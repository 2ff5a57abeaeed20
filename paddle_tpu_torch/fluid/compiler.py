"""CompiledProgram / BuildStrategy (counterpart of
``paddle_tpu/fluid/compiler.py``, the pass-pipeline half).

A BuildStrategy's rewrite knobs select Program-IR passes that
CompiledProgram applies once, at the first run, before the executor
builds its run plan.  Data parallelism, sharding, AMP and auto-tuning are
not ported yet.
"""
from __future__ import annotations

from typing import Optional


class BuildStrategy:
    """The rewrite knobs the ported slices use (details/build_strategy.h).
    The freeze preset's passes run in ``serving.freeze_program``; the
    other knobs of the reference come with the slices that need them.
    ``kernel_tier`` is the umbrella that turns on all four kernel-tier
    passes."""

    def __init__(self):
        # kernel tier (fluid/passes/kernel_tier.py): fuse_attention rewrites
        # the naive attention chain (and its grad chain) onto
        # fused_multihead_attention, whose lowering is the hand-written
        # flash-attention kernel on the card; fuse_paged_attention
        # rewrites the decode step's paged attend chain onto
        # paged_attention, the paged-attention kernel;
        # fuse_sparse_embedding rewrites each lookup_table -> sequence_pool
        # chain (and its grad pair) onto fused_embedding_pool, the
        # gather-pool and scatter-add kernels; fuse_optimizer buckets the
        # adam or momentum updates into one fused_adam / fused_momentum,
        # one launch of its kernel
        self.kernel_tier = False
        self.fuse_attention = False
        self.fuse_paged_attention = False
        self.fuse_sparse_embedding = False
        self.fuse_optimizer = False


class CompiledProgram:
    def __init__(self, program_or_graph,
                 build_strategy: Optional[BuildStrategy] = None):
        self._program = getattr(program_or_graph, "_program",
                                program_or_graph)
        self._build_strategy = build_strategy or BuildStrategy()
        self._ir_passes_applied = False
        # forwarded so Executor.run and the serving engine can read hints
        self._hints = self._program._hints

    def _apply_ir_passes(self, fetch_names=()):
        """Run the BuildStrategy-selected pass pipeline over the program,
        once, in place, seeded and protected by the first run's fetch
        list (the DCE seed and the rewrite protection set)."""
        if self._ir_passes_applied:
            return None
        self._ir_passes_applied = True
        from . import passes
        plist = passes.passes_for_build_strategy(self._build_strategy)
        if not plist:
            return None
        return passes.PassPipeline(plist).apply(self._program,
                                                targets=fetch_names)

    @property
    def program(self):
        return self._program

    def global_block(self):
        return self._program.global_block()
