"""paddle.vision (counterpart of ``paddle_tpu/vision``: the model zoo's
LeNet and ResNets; datasets, transforms, the vision ops, VGG and
MobileNet come with their slices, ROADMAP.md)."""
from . import models
