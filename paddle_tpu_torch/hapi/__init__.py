"""The high-level API (counterpart of ``paddle_tpu/hapi``)."""
from .model import Model, Input
from . import callbacks
from .flops import flops
from . import progressbar  # noqa: F401
from .progressbar import ProgressBar  # noqa: F401
