"""Op lowering library — importing this package registers every ported op.

Counterpart of ``paddle_tpu/ops``.  The lowerings are plain functions on
torch tensors; the CUDA kernels they reach are in cuda_kernels.py.
"""
from . import registry
from .registry import register_op, get_op, has_op, all_ops, LoweringContext

from . import math            # noqa: F401  elementwise/activation/matmul
from . import manipulation    # noqa: F401  reshape/transpose/creation
from . import reduction       # noqa: F401  reductions
from . import nn_ops          # noqa: F401  softmax/dropout family/layer_norm
from . import misc_ops        # noqa: F401  fused compositions
from . import catalog_tail_ops  # noqa: F401  fc, rnn, py_func, detection tail
from . import plumbing_ops    # noqa: F401  arrays, LoD, save/load, queues
from . import random_ops      # noqa: F401  initializer RNG ops
from . import loss_ops        # noqa: F401  cross-entropy losses
from . import optimizer_ops   # noqa: F401  adam/momentum and fused forms
from . import ctr_ops         # noqa: F401  fused_embedding_pool, CTR tier
from . import fused_extra_ops  # noqa: F401  the nn tail, the fused family
from . import rnn_ops         # noqa: F401  lstm/gru/cudnn_lstm family
from . import nlp_ops         # noqa: F401  CRF, CTC, beam search, sampled heads
from . import sequence_extra  # noqa: F401  padded sequence ops
from . import detection_ops   # noqa: F401  affine_grid, focal loss
from . import attention       # noqa: F401  fused attention
from . import quant_ops       # noqa: F401  fake quantize / dequantize family
from . import cuda_kernels    # noqa: F401  hand-written CUDA kernels

# stamp each non-differentiable op's category (ops/nondiff_reasons.py)
from .nondiff_reasons import apply_reasons as _apply_nondiff_reasons
_apply_nondiff_reasons()
