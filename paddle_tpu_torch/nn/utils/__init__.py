"""paddle.nn.utils (counterpart of ``paddle_tpu/nn/utils/``)."""
from . import weight_norm_hook
from .weight_norm_hook import weight_norm, remove_weight_norm

__all__ = ["weight_norm", "remove_weight_norm"]
