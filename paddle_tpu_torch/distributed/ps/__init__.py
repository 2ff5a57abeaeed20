"""Parameter-server tier (counterpart of ``paddle_tpu/distributed/ps``):
the host-RAM sparse table's value store and the BoxPS wrapper.  The
sharded tables, the RPC plane and ``TheOnePSRuntime`` are not ported
yet."""
from . import table
from . import box
from .box import BoxPSWrapper, get_box_wrapper, reset_box_wrappers

__all__ = ["table", "box", "BoxPSWrapper", "get_box_wrapper",
           "reset_box_wrappers"]
