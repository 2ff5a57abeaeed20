"""fluid.contrib.layers (counterpart of ``paddle_tpu/contrib/layers``):
the CTR and search-ads builders and ``ctr_metric_bundle``.  ``rnn_impl``
waits for ROADMAP queue A item 12."""
from . import nn
from .nn import *            # noqa: F401,F403
from . import metric_op
from .metric_op import *     # noqa: F401,F403

__all__ = list(nn.__all__) + list(metric_op.__all__)
