"""paddle.vision (counterpart of ``paddle_tpu/vision``: the model zoo's
LeNet, ResNets, VGG and MobileNets, and the detection ops; datasets and
transforms come with their slices, ROADMAP.md)."""
from . import models
from . import ops  # noqa: F401
