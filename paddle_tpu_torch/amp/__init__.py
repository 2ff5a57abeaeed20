"""Mixed precision (counterpart of ``paddle_tpu/amp``): ``auto_cast`` over
the dygraph tracer's autocast, ``GradScaler``, the op lists the autocast
and the static ``amp_bf16`` pass read, and static AMP's ``decorate``."""
from .auto_cast import auto_cast, amp_guard
from .grad_scaler import GradScaler, AmpScaler
from .lists import WHITE_OPS, BLACK_OPS
from .static_amp import (decorate, rewrite_program_bf16, CustomOpLists,
                         AutoMixedPrecisionLists)
