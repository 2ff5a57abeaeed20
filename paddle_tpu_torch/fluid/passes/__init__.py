"""paddle_tpu_torch.fluid.passes — the Program-IR pass framework
(counterpart of ``paddle_tpu/fluid/passes``: the freeze preset, the
pairwise fusions, the kernel-tier passes and the two AMP passes)."""
from .core import (Pass, PassContext, PassRegistry, PassPipeline,
                   register_pass, create_pass, get_pass_names)
from .pattern import Pattern, PVar, POp, Match, PatternRewritePass
from .graphviz import program_to_dot, dump_program
from . import builtin  # registers the built-in pass catalog
from . import inference as inference_preset  # registers fold_batch_norm
from . import kernel_tier  # registers the kernel-tier passes
from . import amp  # registers amp_bf16 and prune_redundant_casts
from .builtin import passes_for_build_strategy
from .inference import (FoldBatchNormPass, inference_passes,
                        INFERENCE_PASS_NAMES)
from .kernel_tier import (FuseAttentionPass, FuseSparseEmbeddingPass,
                          FuseOptimizerPass)
from .amp import AmpBf16Pass, PruneRedundantCastsPass

__all__ = [
    "Pass", "PassContext", "PassRegistry", "PassPipeline",
    "register_pass", "create_pass", "get_pass_names",
    "Pattern", "PVar", "POp", "Match", "PatternRewritePass",
    "program_to_dot", "dump_program",
    "passes_for_build_strategy", "FoldBatchNormPass", "inference_passes",
    "INFERENCE_PASS_NAMES", "FuseAttentionPass", "FuseSparseEmbeddingPass",
    "FuseOptimizerPass", "AmpBf16Pass", "PruneRedundantCastsPass",
]
