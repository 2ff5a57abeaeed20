"""CompiledProgram / BuildStrategy (counterpart of
``paddle_tpu/fluid/compiler.py``, the pass-pipeline half).

A BuildStrategy's rewrite knobs select Program-IR passes that
CompiledProgram applies once, at the first run, before the executor
builds its run plan (``passes.passes_for_build_strategy``, the
build_strategy.cc AppendPass analog).  ``debug_graphviz_path`` makes the
pipeline write one Graphviz ``.dot`` a stage.  Data parallelism, the
knobs that need several cards (``sync_batch_norm``, ``sharding_mesh``,
``num_trainers`` above 1, ``trainers_endpoints``, ``nccl_comm_num`` above
1, ``collective_mode``) and those whose passes are not ported
(``fuse_all_reduce_ops``, ``sharding``, ``auto_tune``) raise
``NotImplementedError`` at pass application when set.
"""
from __future__ import annotations

from typing import Optional


class ReduceStrategy:
    AllReduce = 0
    Reduce = 1


class BuildStrategy:
    """The knobs (details/build_strategy.h), with the reference's names
    and defaults.  A rewrite knob selects a registered pass."""

    def __init__(self):
        # read by nothing on one card, in the reference either
        self.reduce_strategy = ReduceStrategy.AllReduce
        self.gradient_scale_strategy = 0
        # directory: the pipeline dumps one Graphviz .dot a pass stage
        self.debug_graphviz_path = ""
        self.enable_inplace = True
        # True -> constant_fold + prune_identity + dce (the 1.x
        # memory_optimize contract: shrink the op stream)
        self.memory_optimize = None
        self.constant_folding = False          # -> constant_fold
        self.fuse_elewise_add_act_ops = False  # -> fuse_elewise_add_act
        self.fuse_bn_act_ops = False           # -> fuse_bn_act
        # kernel tier (fluid/passes/kernel_tier.py): fuse_attention
        # rewrites the naive attention chain (and its grad chain) onto
        # fused_multihead_attention, whose lowering is the hand-written
        # flash-attention kernel on the card; fuse_paged_attention
        # rewrites the decode step's paged attend chain onto
        # paged_attention; fuse_sparse_embedding rewrites each
        # lookup_table -> sequence_pool chain (and its grad pair) onto
        # fused_embedding_pool, the gather-pool and scatter-add kernels;
        # fuse_optimizer buckets the adam or momentum updates into one
        # fused_adam / fused_momentum launch.  kernel_tier turns on all
        # four; fuse_all_optimizer_ops is the legacy alias of
        # fuse_optimizer
        self.kernel_tier = False
        self.fuse_attention = False
        self.fuse_paged_attention = False
        self.fuse_sparse_embedding = False
        self.fuse_optimizer = False
        self.fuse_all_optimizer_ops = False
        self.fuse_grad_size_in_num = 32        # allreduce bucket (ops)
        self.enable_dce = False                # -> dce (fetch-seeded)
        # bf16 mixed precision as passes (passes/amp.py): amp -> amp_bf16
        # then prune_redundant_casts unless that is turned off
        self.amp = False
        self.amp_dtype = "bfloat16"
        self.amp_custom_white_list = None
        self.amp_custom_black_list = None
        self.prune_redundant_casts = True
        # not ported: set off the default, pass application raises
        self.fuse_all_reduce_ops = False
        self.sharding = None
        self.sharding_mesh = None
        self.auto_tune = False
        self.enable_sequential_execution = False
        self.remove_unnecessary_lock = True
        self.sync_batch_norm = False
        self.num_trainers = 1
        self.trainer_id = 0
        self.trainers_endpoints = []
        self.collective_mode = None
        self.nccl_comm_num = 1


class ExecutionStrategy:
    """The reference's execution knobs, kept for the programs that set
    them; the eager executor has no thread pool or scope drops to
    tune."""

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 1
        self.num_iteration_per_run = 1
        self.allow_op_delay = False


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
        from . import passes
        hint_fg = self._program._hints.get("fuse_grad_size_in_num")
        if hint_fg is not None:
            # a tuned bucket size travels with the program
            self._build_strategy.fuse_grad_size_in_num = int(hint_fg)
        plist = passes.passes_for_build_strategy(self._build_strategy)
        self._ir_passes_applied = True
        gv = self._build_strategy.debug_graphviz_path or None
        if not plist and not gv:
            return None
        return passes.PassPipeline(plist, graphviz_path=gv).apply(
            self._program, targets=fetch_names)

    @property
    def program(self):
        return self._program

    def global_block(self):
        return self._program.global_block()
