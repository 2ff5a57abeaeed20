"""paddle.vision (counterpart of ``paddle_tpu/vision``: the model zoo's
LeNet, ResNets, VGG and MobileNets; datasets, transforms and the vision
ops come with their slices, ROADMAP.md)."""
from . import models
