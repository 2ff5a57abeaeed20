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
from . import catalog_tail_ops  # noqa: F401  equal_all
from . import plumbing_ops    # noqa: F401  is_empty
from . import random_ops      # noqa: F401  initializer RNG ops
from . import loss_ops        # noqa: F401  cross-entropy losses
from . import optimizer_ops   # noqa: F401  adam/momentum and fused forms
from . import ctr_ops         # noqa: F401  fused_embedding_pool
from . import attention       # noqa: F401  fused attention
from . import cuda_kernels    # noqa: F401  hand-written CUDA kernels
