"""fluid.contrib (counterpart of ``paddle_tpu/contrib``): ``layers``, the
CTR and search-ads layer tier, and its names.  The rest of the
reference's contrib waits for ROADMAP queue A item 12."""
from . import layers
from .layers import *                # noqa: F401,F403

__all__ = list(layers.__all__)
