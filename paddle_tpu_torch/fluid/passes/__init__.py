"""paddle_tpu_torch.fluid.passes — the Program-IR pass framework
(counterpart of ``paddle_tpu/fluid/passes``, the freeze preset and the
``fuse_attention``, ``fuse_sparse_embedding`` and ``fuse_optimizer``
kernel-tier passes)."""
from .core import (Pass, PassContext, PassRegistry, PassPipeline,
                   register_pass, create_pass, get_pass_names)
from .pattern import Pattern, PVar, POp, Match, PatternRewritePass
from . import builtin  # registers the built-in pass catalog
from . import inference as inference_preset  # registers fold_batch_norm
from . import kernel_tier  # registers the kernel-tier passes
from .builtin import passes_for_build_strategy
from .inference import (FoldBatchNormPass, inference_passes,
                        INFERENCE_PASS_NAMES)
from .kernel_tier import (FuseAttentionPass, FuseSparseEmbeddingPass,
                          FuseOptimizerPass)

__all__ = [
    "Pass", "PassContext", "PassRegistry", "PassPipeline",
    "register_pass", "create_pass", "get_pass_names",
    "Pattern", "PVar", "POp", "Match", "PatternRewritePass",
    "passes_for_build_strategy", "FoldBatchNormPass", "inference_passes",
    "INFERENCE_PASS_NAMES", "FuseAttentionPass", "FuseSparseEmbeddingPass",
    "FuseOptimizerPass",
]
