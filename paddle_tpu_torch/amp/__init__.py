"""Mixed precision (counterpart of ``paddle_tpu/amp``): the op lists the
dygraph tracer's bf16 autocast reads."""
from .lists import WHITE_OPS, BLACK_OPS
