"""The pass catalog: DCE, constant folding, add+act and bn+act fusion
(with their training rules, which also fuse the paired ``generic_grad``
ops), identity pruning, and the BuildStrategy -> pipeline wiring.

Counterpart of ``paddle_tpu/fluid/passes/builtin.py``.  The all-reduce
coalescing and sharding passes come with the parallelism slice.
"""
from __future__ import annotations

from typing import Dict, List

from ..framework import Operator, convert_dtype, prune_ops, unique_name, \
    _op_reads
from .core import Pass, PassContext, register_pass, create_pass
from .pattern import Pattern, PatternRewritePass, writer_index as \
    _writer_idxs

ACTS = ("relu", "sigmoid", "tanh")


def _consumers(block, name: str) -> List[Operator]:
    """Ops reading ``name``, including control-flow sub-block captures."""
    return [op for op in block.ops if name in _op_reads(block, op)]


def _no_hazard_between(block, i0: int, i1: int, reads, writes) -> bool:
    """Safe to move an op from position i0 to i1 (i0 < i1): no op strictly
    between may write a var the moved op reads, or touch a var it
    writes."""
    reads, writes = set(reads), set(writes)
    for op in block.ops[i0 + 1:i1]:
        wr = set(op.output_arg_names)
        if (wr & (reads | writes)) or (set(_op_reads(block, op)) & writes):
            return False
    return True


# ---------------------------------------------------------------------------
# dead-code elimination
# ---------------------------------------------------------------------------

@register_pass
class DeadCodeEliminationPass(Pass):
    """Backward-reachability DCE from the fetch targets
    (framework.prune_ops): ops feeding neither a target, persistable
    state, nor a side effect are removed from the program."""

    name = "dce"

    def apply(self, program, ctx: PassContext) -> Dict[str, int]:
        block = program.global_block()
        targets = list(ctx.targets) or None
        kept = prune_ops(block, block.ops, targets=targets,
                         keep_state_writes=True)
        removed = len(block.ops) - len(kept)
        if removed:
            block.ops = kept
            program._bump_version()
        return {"ops_removed": removed}


# ---------------------------------------------------------------------------
# constant folding
# ---------------------------------------------------------------------------

@register_pass
class ConstantFoldPass(Pass):
    """Fold fill_constant/scale/cast chains at pass time:
    ``scale(fill_constant)`` and ``cast(fill_constant)`` become one
    fill_constant; ``scale(scale(x))`` composes into one scale.  Orphaned
    producers are left for DCE."""

    name = "constant_fold"
    writes = frozenset({"ops", "attrs"})

    def apply_block(self, block, ctx: PassContext) -> Dict[str, int]:
        folded = 0
        for _ in range(4 * len(block.ops) + 16):
            if not self._fold_one(block):
                break
            folded += 1
        return {"ops_folded": folded}

    def _consts(self, block) -> Dict[str, Operator]:
        out = {}
        for op in block.ops:
            if op.type == "fill_constant" and not op.inputs.get(
                    "ShapeTensor") and not op.inputs.get("ValueTensor"):
                name = (op.outputs.get("Out") or [None])[0]
                if name and len(_writer_idxs(block, name)) == 1:
                    out[name] = op
        return out

    def _replace_with_fill(self, block, i, src_fill, out_name, value,
                           dtype, op_role):
        block._remove_op(i)
        block._insert_op(
            i, "fill_constant", outputs={"Out": [out_name]},
            attrs={"shape": list(src_fill.attrs.get("shape", [])),
                   "value": float(value), "dtype": dtype,
                   "op_role": op_role})

    def _fold_one(self, block) -> bool:
        consts = self._consts(block)
        for i, op in enumerate(block.ops):
            out = (op.outputs.get("Out") or [None])[0]
            src = (op.inputs.get("X") or [None])[0]
            if out is None or src is None:
                continue
            if op.type == "scale" and not op.inputs.get("ScaleTensor"):
                s = float(op.attrs.get("scale", 1.0))
                b = float(op.attrs.get("bias", 0.0))
                after = bool(op.attrs.get("bias_after_scale", True))
                if src in consts:
                    v = float(consts[src].attrs.get("value", 0.0))
                    self._replace_with_fill(
                        block, i, consts[src], out,
                        v * s + b if after else (v + b) * s,
                        consts[src].attrs.get("dtype", "float32"),
                        op.attrs.get("op_role", 0))
                    return True
                widx = _writer_idxs(block, src)
                if len(widx) == 1 and widx[0] < i and after:
                    inner = block.ops[widx[0]]
                    # rewiring the outer scale to read inner's input is
                    # only sound if that input still holds the value
                    # inner saw
                    if (inner.type == "scale"
                            and not inner.inputs.get("ScaleTensor")
                            and inner.attrs.get("bias_after_scale", True)
                            and inner.inputs.get("X")
                            and _no_hazard_between(
                                block, widx[0], i,
                                reads=inner.inputs["X"], writes=())):
                        s1 = float(inner.attrs.get("scale", 1.0))
                        b1 = float(inner.attrs.get("bias", 0.0))
                        # (x*s1+b1)*s+b == x*(s1*s) + (b1*s+b)
                        op.inputs["X"] = list(inner.inputs["X"])
                        op.set_attr("scale", s1 * s)
                        op.set_attr("bias", b1 * s + b)
                        return True
            elif op.type == "cast" and src in consts:
                self._replace_with_fill(
                    block, i, consts[src], out,
                    consts[src].attrs.get("value", 0.0),
                    op.attrs.get("out_dtype", "float32"),
                    op.attrs.get("op_role", 0))
                return True
        return False


# ---------------------------------------------------------------------------
# producer + activation fusion
# ---------------------------------------------------------------------------

class _FusionPass(PatternRewritePass):
    """Shared machinery for pairwise producer->activation fusion with
    optional grad-pair fusion (training programs)."""

    def _check_edge(self, m, ctx, t: str, extra_consumers) -> bool:
        """The fused-away intermediate ``t`` must be an internal edge:
        written once, consumed only by the ops being fused, not
        protected."""
        block = m.block
        if ctx.is_protected(block, t):
            return False
        if len(_writer_idxs(block, t)) != 1:
            return False
        allowed = {id(o) for o in extra_consumers}
        return all(id(c) in allowed for c in _consumers(block, t))

    def _splice(self, block, new_op, anchor, dead) -> None:
        """Insert ``new_op`` right after ``anchor`` and remove the
        ``dead`` ops — all through the version-bumping mutators."""
        block._insert_op_obj(block.ops.index(anchor) + 1, new_op)
        for op in dead:
            block._remove_op(block.ops.index(op))


@register_pass
class FuseElewiseAddActPass(_FusionPass):
    """elementwise_add + {relu,sigmoid,tanh} -> fused_elemwise_activation
    (fuse_elewise_add_act_pass.cc).  In training programs the pair of
    generic_grad ops collapses into one generic_grad over the fused op."""

    name = "fuse_elewise_add_act"

    def __init__(self, **options):
        super().__init__(**options)
        pt = Pattern("elewise_add_act_train")
        x, y, t, out, g, tg = pt.vars("x y t out g tg")
        pt.op("elementwise_add", ins={"X": [x], "Y": [y]},
              outs={"Out": [t]})
        pt.op(ACTS, ins={"X": [t]}, outs={"Out": [out]})
        pt.op("generic_grad", ins={"I_X": [t], "G_Out": [g]},
              outs={"GI_X": [tg]})
        pt.op("generic_grad", ins={"G_Out": [tg]})
        pf = Pattern("elewise_add_act_fwd")
        x2, y2, t2, out2 = pf.vars("x y t out")
        pf.op("elementwise_add", ins={"X": [x2], "Y": [y2]},
              outs={"Out": [t2]})
        pf.op(ACTS, ins={"X": [t2]}, outs={"Out": [out2]})
        self.rules = [(pt, self._rewrite_train), (pf, self._rewrite_fwd)]

    def _fused_ops(self, m, with_grads: bool):
        block = m.block
        add, act = m.ops[0], m.ops[1]
        t, out = m.var("t"), m.var("out")
        attrs = {"functor_list": ["elementwise_add", act.type],
                 "axis": add.attrs.get("axis", -1),
                 "op_role": add.attrs.get("op_role", 0)}
        inter = unique_name(t + "@fuse_inter")
        fused = Operator(block, "fused_elemwise_activation",
                         {"X": list(add.inputs["X"]),
                          "Y": list(add.inputs["Y"])},
                         {"Out": [out], "IntermediateOut": [inter]},
                         attrs)
        if not with_grads:
            return fused, None
        act_g, add_g = m.ops[2], m.ops[3]
        g_ins = {"I_X": list(add.inputs["X"]),
                 "I_Y": list(add.inputs["Y"]),
                 "G_Out": list(act_g.inputs["G_Out"])}
        g_outs = {k: list(v) for k, v in add_g.outputs.items()}
        fused_g = Operator(block, "generic_grad", g_ins, g_outs,
                           {"fwd_type": "fused_elemwise_activation",
                            "fwd_attrs": dict(attrs),
                            "in_slots": ["X", "Y"],
                            "grad_slots": list(
                                add_g.attrs.get("grad_slots", [])),
                            "op_role": 1})
        return fused, fused_g

    def _common_ok(self, m, ctx, consumers_of_t) -> bool:
        block = m.block
        add, act = m.ops[0], m.ops[1]
        if not self._check_edge(m, ctx, m.var("t"), consumers_of_t):
            return False
        if len(_writer_idxs(block, m.var("out"))) != 1:
            return False
        return _no_hazard_between(
            block, m.index(0), m.index(1),
            reads=add.input_arg_names, writes=[m.var("t")])

    def _rewrite_fwd(self, m, ctx) -> bool:
        if not self._common_ok(m, ctx, m.ops[1:2]):
            return False
        fused, _ = self._fused_ops(m, with_grads=False)
        self._splice(m.block, fused, m.ops[1], m.ops[:2])
        return True

    def _rewrite_train(self, m, ctx) -> bool:
        block = m.block
        add, act, act_g, add_g = m.ops
        if act_g.attrs.get("fwd_type") != act.type:
            return False
        if add_g.attrs.get("fwd_type") != "elementwise_add":
            return False
        if (add_g.inputs.get("I_X") != add.inputs.get("X")
                or add_g.inputs.get("I_Y") != add.inputs.get("Y")):
            return False
        if not self._common_ok(m, ctx, [act, act_g]):
            return False
        tg = m.var("tg")
        if (len(_writer_idxs(block, tg)) != 1
                or not self._check_edge(m, ctx, tg, [add_g])):
            return False
        if not _no_hazard_between(
                block, m.index(2), m.index(3),
                reads=list(add.inputs["X"]) + list(add.inputs["Y"])
                + list(act_g.inputs["G_Out"]),
                writes=add_g.output_arg_names):
            return False
        fused, fused_g = self._fused_ops(m, with_grads=True)
        self._splice(block, fused_g, act_g, [act_g, add_g])
        self._splice(block, fused, act, [add, act])
        return True


@register_pass
class FuseBnActPass(_FusionPass):
    """batch_norm + activation -> fused_bn_activation
    (fuse_bn_act_pass.cc), with the same training-aware grad-pair fusion
    as fuse_elewise_add_act."""

    name = "fuse_bn_act"

    def __init__(self, **options):
        super().__init__(**options)
        pt = Pattern("bn_act_train")
        x, t, out, g, tg = pt.vars("x t out g tg")
        pt.op("batch_norm", ins={"X": [x]}, outs={"Y": [t]})
        pt.op(ACTS, ins={"X": [t]}, outs={"Out": [out]})
        pt.op("generic_grad", ins={"I_X": [t], "G_Out": [g]},
              outs={"GI_X": [tg]})
        pt.op("generic_grad", ins={"G_Y": [tg]})
        pf = Pattern("bn_act_fwd")
        x2, t2, out2 = pf.vars("x t out")
        pf.op("batch_norm", ins={"X": [x2]}, outs={"Y": [t2]})
        pf.op(ACTS, ins={"X": [t2]}, outs={"Out": [out2]})
        self.rules = [(pt, self._rewrite_train), (pf, self._rewrite_fwd)]

    def _fused_op(self, m) -> Operator:
        block = m.block
        bn, act = m.ops[0], m.ops[1]
        outs = {k: list(v) for k, v in bn.outputs.items()}
        outs["Y"] = [m.var("out")]
        return Operator(block, "fused_bn_activation",
                        {k: list(v) for k, v in bn.inputs.items()}, outs,
                        dict(bn.attrs, act_type=act.type))

    def _common_ok(self, m, ctx, consumers_of_t) -> bool:
        block = m.block
        bn = m.ops[0]
        if bn.attrs.get("use_global_stats"):
            return False
        if not self._check_edge(m, ctx, m.var("t"), consumers_of_t):
            return False
        if len(_writer_idxs(block, m.var("out"))) != 1:
            return False
        # moving bn down to the act position carries its state writes
        # (MeanOut/VarianceOut write the Mean/Variance vars in place)
        other_outs = [n for n in bn.output_arg_names if n != m.var("t")]
        return _no_hazard_between(
            block, m.index(0), m.index(1),
            reads=bn.input_arg_names,
            writes=[m.var("t")] + other_outs)

    def _rewrite_fwd(self, m, ctx) -> bool:
        if not self._common_ok(m, ctx, m.ops[1:2]):
            return False
        self._splice(m.block, self._fused_op(m), m.ops[1], m.ops[:2])
        return True

    def _rewrite_train(self, m, ctx) -> bool:
        block = m.block
        bn, act, act_g, bn_g = m.ops
        if act_g.attrs.get("fwd_type") != act.type:
            return False
        if bn_g.attrs.get("fwd_type") != "batch_norm":
            return False
        if bn_g.inputs.get("I_X") != bn.inputs.get("X"):
            return False
        if not self._common_ok(m, ctx, [act, act_g]):
            return False
        tg = m.var("tg")
        if not self._check_edge(m, ctx, tg, [bn_g]):
            return False
        grad_reads = [n for slot, ns in bn_g.inputs.items()
                      if slot != "G_Y" for n in ns]
        if not _no_hazard_between(
                block, m.index(2), m.index(3),
                reads=grad_reads + list(act_g.inputs["G_Out"]),
                writes=bn_g.output_arg_names):
            return False
        fused = self._fused_op(m)
        g_ins = {k: list(v) for k, v in bn_g.inputs.items()
                 if k != "G_Y"}
        g_ins["G_Y"] = list(act_g.inputs["G_Out"])
        fused_g = Operator(
            block, "generic_grad", g_ins,
            {k: list(v) for k, v in bn_g.outputs.items()},
            {"fwd_type": "fused_bn_activation",
             "fwd_attrs": dict(fused.attrs),
             "in_slots": list(bn_g.attrs.get("in_slots", [])),
             "grad_slots": list(bn_g.attrs.get("grad_slots", [])),
             "op_role": 1})
        self._splice(block, fused_g, act_g, [act_g, bn_g])
        self._splice(block, fused, act, [bn, act])
        return True


# ---------------------------------------------------------------------------
# identity cleanup
# ---------------------------------------------------------------------------

@register_pass
class PruneIdentityPass(Pass):
    """Remove no-op plumbing (identity_op_clean_pass.cc): scale(1.0, 0.0),
    cast to the var's own dtype, and assign of a write-once
    non-persistable var — consumers are rewired to the source var."""

    name = "prune_identity"

    def _is_identity(self, block, op) -> bool:
        if op.type == "scale":
            return (not op.inputs.get("ScaleTensor")
                    and float(op.attrs.get("scale", 1.0)) == 1.0
                    and float(op.attrs.get("bias", 0.0)) == 0.0)
        if op.type == "cast":
            src = (op.inputs.get("X") or [None])[0]
            v = block._find_var_recursive(src) if src else None
            if v is None or v.dtype is None:
                return False
            try:
                return convert_dtype(op.attrs.get("out_dtype", "float32")) \
                    == convert_dtype(v.dtype)
            except (ValueError, TypeError):
                return False
        if op.type == "assign":
            src = (op.inputs.get("X") or [None])[0]
            v = block._find_var_recursive(src) if src else None
            # persistable sources are the snapshot idiom — never prune
            return v is not None and not v.persistable
        return False

    def apply_block(self, block, ctx: PassContext) -> Dict[str, int]:
        removed = 0
        for _ in range(len(block.ops) + 16):
            if not self._prune_one(block, ctx):
                break
            removed += 1
        return {"ops_removed": removed}

    def _prune_one(self, block, ctx: PassContext) -> bool:
        prog = block.program
        for i, op in enumerate(block.ops):
            if not self._is_identity(block, op):
                continue
            src = (op.inputs.get("X") or [None])[0]
            out = (op.outputs.get("Out") or [None])[0]
            if src is None or out is None or src == out:
                continue
            if ctx.is_protected(block, out):
                continue
            if len(_writer_idxs(block, out)) != 1:
                continue
            if len(_writer_idxs(block, src)) > 1:
                continue
            # every consumer must live in THIS block
            other = [o for b in prog.blocks for o in b.ops
                     if b is not block and out in _op_reads(b, o)]
            if other or any(out in repr(o.attrs) for b in prog.blocks
                            for o in b.ops):
                continue
            for o in block.ops:
                if o is op:
                    continue
                for slot, names in o.inputs.items():
                    if out in names:
                        o.inputs[slot] = [src if n == out else n
                                          for n in names]
            block._remove_op(i)
            return True
        return False


# ---------------------------------------------------------------------------
# BuildStrategy -> pipeline wiring (build_strategy.cc AppendPass analog)
# ---------------------------------------------------------------------------

# knobs whose meaning is not ported: (knob, set off its default?, what
# it needs); such a knob raises at pass application instead of running a
# different program
def _above_one(v):
    return v is not None and int(v) > 1


_ITEM_10 = "the parallelism slice (ROADMAP queue A item 10)"
_UNPORTED_KNOBS = (
    ("fuse_all_reduce_ops", bool, "coalesce_allreduce, " + _ITEM_10),
    ("sharding", bool, "shard_collectives, " + _ITEM_10),
    ("auto_tune", bool, "the profile-guided tuner (ROADMAP queue A "
                        "item 9)"),
    ("sync_batch_norm", bool, "batch statistics across cards, "
                              + _ITEM_10),
    ("sharding_mesh", bool, "a device mesh, " + _ITEM_10),
    ("num_trainers", _above_one, "several trainers, " + _ITEM_10),
    ("trainers_endpoints", bool, "several trainers, " + _ITEM_10),
    ("nccl_comm_num", _above_one, "several communicators, " + _ITEM_10),
    ("collective_mode", bool, "a collective mode, " + _ITEM_10),
)


def passes_for_build_strategy(build_strategy) -> List[Pass]:
    """The pass list a BuildStrategy's knobs select, in the reference's
    canonical order: fold -> fuse -> kernel tier -> prune_identity -> amp
    -> dce.  The kernel tier runs after the pairwise fusions (they never
    overlap its chains) and before AMP; AMP runs before DCE, which sweeps
    the cast orphans the redundancy pruner leaves.  ``kernel_tier`` turns
    on all four kernel-tier passes; ``memory_optimize`` turns on folding,
    identity pruning and DCE."""
    from . import amp as _amp  # noqa: F401 — registers the AMP passes
    from . import kernel_tier as _kt  # noqa: F401 — registers the tier
    bs = build_strategy
    for knob, is_set, what in _UNPORTED_KNOBS:
        if is_set(getattr(bs, knob, None)):
            raise NotImplementedError(
                f"BuildStrategy.{knob} needs {what}, which is not ported "
                f"yet")
    mem = bool(getattr(bs, "memory_optimize", None))
    tier = bool(getattr(bs, "kernel_tier", False))
    specs = []
    if getattr(bs, "constant_folding", False) or mem:
        specs.append(("constant_fold", {}))
    if getattr(bs, "fuse_elewise_add_act_ops", False):
        specs.append(("fuse_elewise_add_act", {}))
    if getattr(bs, "fuse_bn_act_ops", False):
        specs.append(("fuse_bn_act", {}))
    if tier or getattr(bs, "fuse_attention", False):
        specs.append(("fuse_attention", {}))
    if tier or getattr(bs, "fuse_paged_attention", False):
        specs.append(("fuse_paged_attention", {}))
    if tier or getattr(bs, "fuse_sparse_embedding", False):
        specs.append(("fuse_sparse_embedding", {}))
    if tier or getattr(bs, "fuse_optimizer", False) \
            or getattr(bs, "fuse_all_optimizer_ops", False):
        specs.append(("fuse_optimizer", {}))
    if mem:
        specs.append(("prune_identity", {}))
    if getattr(bs, "amp", False):
        specs.append(("amp_bf16", {
            "dtype": getattr(bs, "amp_dtype", "bfloat16") or "bfloat16",
            "custom_white_list": getattr(bs, "amp_custom_white_list",
                                         None),
            "custom_black_list": getattr(bs, "amp_custom_black_list",
                                         None)}))
        if getattr(bs, "prune_redundant_casts", True):
            specs.append(("prune_redundant_casts", {}))
    if getattr(bs, "enable_dce", False) or mem:
        specs.append(("dce", {}))
    return [create_pass(name, **kw) for name, kw in specs]
