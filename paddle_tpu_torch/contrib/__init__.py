"""fluid.contrib (counterpart of ``paddle_tpu/contrib``): ``layers``, the
CTR and search-ads layer tier, and its names; ``slim`` (quantization)
and ``quantize`` (``QuantizeTranspiler``).  The rest of the reference's
contrib waits for ROADMAP queue A item 12."""
from . import quantize
from .quantize import *              # noqa: F401,F403
from . import slim
from . import layers
from .layers import *                # noqa: F401,F403

__all__ = ["slim"] + list(quantize.__all__) + list(layers.__all__)
