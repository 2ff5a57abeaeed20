"""The pass catalog of the freeze preset: DCE, constant folding, add+act
and bn+act fusion, identity pruning.

Counterpart of ``paddle_tpu/fluid/passes/builtin.py``.  The fusions keep
their forward rules; the rules that also fuse the paired ``generic_grad``
ops of training programs come with the training slice, as do the
all-reduce coalescing and sharding passes.
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
    """Shared machinery for pairwise producer -> activation fusion."""

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
    (fuse_elewise_add_act_pass.cc)."""

    name = "fuse_elewise_add_act"

    def __init__(self, **options):
        super().__init__(**options)
        pf = Pattern("elewise_add_act_fwd")
        x, y, t, out = pf.vars("x y t out")
        pf.op("elementwise_add", ins={"X": [x], "Y": [y]},
              outs={"Out": [t]})
        pf.op(ACTS, ins={"X": [t]}, outs={"Out": [out]})
        self.rules = [(pf, self._rewrite_fwd)]

    def _rewrite_fwd(self, m, ctx) -> bool:
        block = m.block
        add, act = m.ops[0], m.ops[1]
        if not self._check_edge(m, ctx, m.var("t"), [act]):
            return False
        if len(_writer_idxs(block, m.var("out"))) != 1:
            return False
        if not _no_hazard_between(block, m.index(0), m.index(1),
                                  reads=add.input_arg_names,
                                  writes=[m.var("t")]):
            return False
        attrs = {"functor_list": ["elementwise_add", act.type],
                 "axis": add.attrs.get("axis", -1),
                 "op_role": add.attrs.get("op_role", 0)}
        inter = unique_name(m.var("t") + "@fuse_inter")
        fused = Operator(block, "fused_elemwise_activation",
                         {"X": list(add.inputs["X"]),
                          "Y": list(add.inputs["Y"])},
                         {"Out": [m.var("out")], "IntermediateOut": [inter]},
                         attrs)
        self._splice(block, fused, act, [add, act])
        return True


@register_pass
class FuseBnActPass(_FusionPass):
    """batch_norm + activation -> fused_bn_activation
    (fuse_bn_act_pass.cc)."""

    name = "fuse_bn_act"

    def __init__(self, **options):
        super().__init__(**options)
        pf = Pattern("bn_act_fwd")
        x, t, out = pf.vars("x t out")
        pf.op("batch_norm", ins={"X": [x]}, outs={"Y": [t]})
        pf.op(ACTS, ins={"X": [t]}, outs={"Out": [out]})
        self.rules = [(pf, self._rewrite_fwd)]

    def _rewrite_fwd(self, m, ctx) -> bool:
        block = m.block
        bn, act = m.ops[0], m.ops[1]
        if bn.attrs.get("use_global_stats"):
            return False
        if not self._check_edge(m, ctx, m.var("t"), [act]):
            return False
        if len(_writer_idxs(block, m.var("out"))) != 1:
            return False
        # moving bn down to the act position carries its state writes
        other_outs = [n for n in bn.output_arg_names if n != m.var("t")]
        if not _no_hazard_between(block, m.index(0), m.index(1),
                                  reads=bn.input_arg_names,
                                  writes=[m.var("t")] + other_outs):
            return False
        outs = {k: list(v) for k, v in bn.outputs.items()}
        outs["Y"] = [m.var("out")]
        fused = Operator(block, "fused_bn_activation",
                         {k: list(v) for k, v in bn.inputs.items()}, outs,
                         dict(bn.attrs, act_type=act.type))
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

def passes_for_build_strategy(build_strategy) -> List[Pass]:
    """The pass list a BuildStrategy's knobs select, in the reference's
    order: ``fuse_attention``, ``fuse_paged_attention``,
    ``fuse_sparse_embedding``, then ``fuse_optimizer``.  ``kernel_tier``
    turns on all four."""
    from . import kernel_tier as _kt  # noqa: F401 — registers the tier
    bs = build_strategy
    tier = bool(bs.kernel_tier)
    names = [name for name, on in (
        ("fuse_attention", bs.fuse_attention),
        ("fuse_paged_attention", bs.fuse_paged_attention),
        ("fuse_sparse_embedding", bs.fuse_sparse_embedding),
        ("fuse_optimizer", bs.fuse_optimizer)) if tier or on]
    return [create_pass(name) for name in names]
