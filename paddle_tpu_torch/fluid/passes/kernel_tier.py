"""The kernel tier as compiler passes: ``fuse_attention``,
``fuse_paged_attention``, ``fuse_sparse_embedding`` and
``fuse_optimizer``.

Counterpart of ``FuseAttentionPass``, ``FusePagedAttentionPass``,
``FuseSparseEmbeddingPass`` and ``FuseOptimizerPass`` in
``paddle_tpu/fluid/passes/kernel_tier.py``.

* ``fuse_attention`` — the naive attention chain

      matmul(Q, Kᵀ) → [scale] → [+mask] → softmax → [dropout] → matmul(·, V)

  and, in a training program, its paired ``generic_grad`` chain rewrite
  to ONE ``fused_multihead_attention`` op (+ one fused ``generic_grad``).
  On the card the op's lowering is the hand-written flash-attention
  forward kernel, and its grad the backward kernel (ops/attention.py).
  An absorbed dropout op's rate, seed and implementation are stamped
  into the fused op.  The rewrite declines, silently, when the IR shapes
  of Q, K, V and the output are not 4-d ``[B, H, T, D]`` — so a wrong
  shape inference would keep the kernel off the path; the tests hold the
  rewrite count to the layer count.
* ``fuse_paged_attention`` — the decode step's attention over block-paged
  K/V pools, gather → reshape → mul+reduce_sum → scale → masked add →
  softmax → mul+reduce_sum (serving/decode.py), rewrites to ONE
  ``paged_attention`` op: on the card the hand-written paged-attention
  kernel (ops/attention.py).  Only the exact-zero mask spelling
  ``valid·N + (-N)`` matches, and every intermediate must die with the
  rewrite.
* ``fuse_sparse_embedding`` — ``lookup_table[_v2]`` followed by
  ``sequence_pool`` (SUM/AVERAGE) or ``reduce_sum(dim=[1])``, and in a
  training program the pair of ``generic_grad`` ops behind them, rewrite
  to ONE ``fused_embedding_pool`` op (+ one fused ``generic_grad``):
  on the card the hand-written gather-pool kernel and, for its grad,
  the deterministic scatter-add kernel (ops/ctr_ops.py).  The gathered
  ``[B, S, D]`` intermediate must have no other consumer.
* ``fuse_optimizer`` — a run of same-(type, dtype, masters, attrs, lr)
  ``adam``, ``momentum`` or ``lamb`` ops buckets into one
  ``fused_adam`` / ``fused_momentum`` / ``fused_lamb`` op: for Adam and
  Momentum one launch of the hand-written kernel over the bucket (its
  master path when the ops carry fp32 masters), element for element the
  same arithmetic as the per-param updates; LAMB's is a plain op, as
  the reference has no kernel for it.

Each rewrite counts ``kernel_tier.<pass>.rewrites``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .. import trace
from ..framework import Operator, _op_reads
from .core import Pass, PassContext, register_pass
from .pattern import Pattern, PatternRewritePass, writer_index as _widx

__all__ = ["FuseAttentionPass", "FusePagedAttentionPass",
           "FuseSparseEmbeddingPass", "FuseOptimizerPass"]


def _consumers(block, name: str) -> List[Operator]:
    return [op for op in block.ops if name in _op_reads(block, op)]


def _internal_edge(block, ctx: PassContext, name: str, allowed_ops) -> bool:
    """A var the rewrite deletes must be a purely internal edge: written
    once, not protected, consumed only by the ops being fused."""
    if ctx.is_protected(block, name):
        return False
    if len(_widx(block, name)) != 1:
        return False
    allowed = {id(o) for o in allowed_ops}
    return all(id(c) in allowed for c in _consumers(block, name))


def _ndim(block, name: str) -> Optional[int]:
    v = block._find_var_recursive(name)
    if v is None or v.shape is None:
        return None
    return len(v.shape)


def _splice(block, new_op: Operator, anchor: Operator, dead) -> None:
    """Insert ``new_op`` right after ``anchor``, remove the ``dead`` ops —
    all through the version-bumping mutators."""
    block._insert_op_obj(block.ops.index(anchor) + 1, new_op)
    for op in dead:
        block._remove_op(block.ops.index(op))


def _count_rewrite(pass_name: str) -> None:
    trace.metrics().counter(f"kernel_tier.{pass_name}.rewrites").inc()


# ---------------------------------------------------------------------------
# fuse_attention
# ---------------------------------------------------------------------------

def _falsy(v) -> bool:
    return not v


def _truthy(v) -> bool:
    return bool(v)


@register_pass
class FuseAttentionPass(PatternRewritePass):
    """matmul(Q,Kᵀ) → [scale] → [+mask] → softmax → [dropout] → matmul(·,V)
    ⇒ ``fused_multihead_attention`` (forward AND the paired generic_grad
    chain in training programs).  Patterns are generated for every
    optional-op combination, training variants first and longer chains
    before their own sub-chains, so a complete chain always wins."""

    name = "fuse_attention"

    def __init__(self, **options):
        super().__init__(**options)
        for train in (True, False):
            for with_drop in (True, False):
                for with_mask in (True, False):
                    for with_scale in (True, False):
                        self.rules.append(self._rule(
                            train, with_scale, with_mask, with_drop))

    # -- pattern construction ----------------------------------------------
    def _rule(self, train, with_scale, with_mask, with_drop):
        p = Pattern(f"attention_{'train' if train else 'fwd'}"
                    f"_s{int(with_scale)}m{int(with_mask)}d{int(with_drop)}")
        q, k, v, out = p.vars("q k v out")
        scores = [p.var("s0")]            # score-var chain, program order
        p.op("matmul", ins={"X": [q], "Y": [k]}, outs={"Out": [scores[-1]]},
             attrs={"transpose_X": _falsy, "transpose_Y": _truthy})
        if with_scale:
            scores.append(p.var("s1"))
            p.op("scale", ins={"X": [scores[-2]]},
                 outs={"Out": [scores[-1]]},
                 attrs={"bias": _falsy})
        if with_mask:
            scores.append(p.var("s2"))
            # only the trailing-broadcast, unscaled spelling: a Paddle
            # leading-dim axis or a post-add scale multiplier is not what
            # the fused lowering's `s + mask` computes
            p.op("elementwise_add",
                 ins={"X": [scores[-2]], "Y": [p.var("mask")]},
                 outs={"Out": [scores[-1]]},
                 attrs={"axis": lambda a: a in (None, -1),
                        "scale": lambda sc: sc is None
                        or float(sc) == 1.0})
        probs = [p.var("p0")]
        p.op("softmax", ins={"X": [scores[-1]]}, outs={"Out": [probs[-1]]},
             attrs={"axis": lambda a: a in (None, -1, 3)})
        if with_drop:
            probs.append(p.var("p1"))
            p.op("dropout", ins={"X": [probs[-2]]},
                 outs={"Out": [probs[-1]]})
        p.op("matmul", ins={"X": [probs[-1]], "Y": [v]},
             outs={"Out": [out]},
             attrs={"transpose_X": _falsy, "transpose_Y": _falsy,
                    "alpha": lambda a: a is None or float(a) == 1.0})
        if train:
            # grads in reverse forward order (append_backward layout)
            p.op("generic_grad",
                 ins={"I_X": [probs[-1]], "I_Y": [v], "G_Out": [p.var("go")]},
                 outs={"GI_X": [p.var("gp")], "GI_Y": [p.var("gv")]},
                 attrs={"fwd_type": "matmul"})
            g_cur = p.var("gp")
            if with_drop:
                p.op("generic_grad",
                     ins={"I_X": [probs[-2]], "G_Out": [g_cur]},
                     outs={"GI_X": [p.var("gp0")]},
                     attrs={"fwd_type": "dropout"})
                g_cur = p.var("gp0")
            p.op("generic_grad", ins={"I_X": [scores[-1]], "G_Out": [g_cur]},
                 outs={"GI_X": [p.var("gsm")]},
                 attrs={"fwd_type": "softmax"})
            g_cur = p.var("gsm")
            if with_mask:
                p.op("generic_grad",
                     ins={"I_X": [scores[-2]], "G_Out": [g_cur]},
                     outs={"GI_X": [p.var("gadd")]},
                     attrs={"fwd_type": "elementwise_add"})
                g_cur = p.var("gadd")
            if with_scale:
                p.op("generic_grad",
                     ins={"I_X": [scores[0]], "G_Out": [g_cur]},
                     outs={"GI_X": [p.var("gsc")]},
                     attrs={"fwd_type": "scale"})
                g_cur = p.var("gsc")
            p.op("generic_grad",
                 ins={"I_X": [q], "I_Y": [k], "G_Out": [g_cur]},
                 outs={"GI_X": [p.var("gq")], "GI_Y": [p.var("gk")]},
                 attrs={"fwd_type": "matmul"})

        def rewrite(m, ctx, _flags=(train, with_scale, with_mask,
                                    with_drop)):
            return self._rewrite(m, ctx, *_flags)

        return (p, rewrite)

    # -- rewrite ------------------------------------------------------------
    def _rewrite(self, m, ctx, train, with_scale, with_mask,
                 with_drop) -> bool:
        block = m.block
        n_fwd = 3 + int(with_scale) + int(with_mask) + int(with_drop)
        fwd_ops, grad_ops = m.ops[:n_fwd], m.ops[n_fwd:]
        mm2 = fwd_ops[-1]
        drop_op = fwd_ops[-2] if with_drop else None
        # the naive chain operates on [B, H, T, T] scores — require the
        # 4-d shape the fused op's lowering assumes.  Unknown shapes stay
        # on the op-by-op path (conservative: never mis-fuse an mlp's
        # matmul→softmax→matmul into an attention kernel).
        for name in (m.var("q"), m.var("k"), m.var("v"), m.var("out")):
            if _ndim(block, name) != 4:
                return False
        # internal edges: every intermediate score/prob var dies with the
        # rewrite, so it must have no consumer outside the matched ops
        inter = [m.binding[n] for n in
                 ("s0", "s1", "s2", "p0", "p1") if n in m.binding]
        allowed = fwd_ops + grad_ops
        for t in inter:
            if not _internal_edge(block, ctx, t, allowed):
                return False
        if len(_widx(block, m.var("out"))) != 1:
            return False
        for name in (m.var("q"), m.var("k"), m.var("v")):
            if len(_widx(block, name)) > 1:
                return False
        if drop_op is not None:
            mask_out = (drop_op.outputs.get("Mask") or [None])[0]
            if mask_out and _consumers(block, mask_out):
                return False
        if train:
            # grad chain intermediates are internal too, and the mask must
            # not itself require a gradient (the fused op cannot emit one)
            ginter = [m.binding[n] for n in
                      ("gp", "gp0", "gsm", "gadd", "gsc") if n in m.binding]
            for t in ginter:
                if not _internal_edge(block, ctx, t, allowed):
                    return False
            for n in ("gq", "gk", "gv"):
                if len(_widx(block, m.var(n))) != 1:
                    return False
            if with_mask:
                add_g = next(o for o in grad_ops
                             if o.attrs.get("fwd_type") == "elementwise_add")
                if add_g.outputs.get("GI_Y"):
                    return False

        scale = float(fwd_ops[0].attrs.get("alpha", 1.0) or 1.0)
        if with_scale:
            scale *= float(fwd_ops[1].attrs.get("scale", 1.0))
        attrs = {"scale": scale, "causal": False,
                 "op_role": fwd_ops[0].attrs.get("op_role", 0)}
        if drop_op is not None:
            attrs.update(
                dropout_rate=float(drop_op.attrs.get("dropout_prob", 0.5)),
                dropout_seed=int(drop_op.attrs.get(
                    "op_seed", drop_op.attrs.get("seed", 0) or 0)),
                dropout_implementation=drop_op.attrs.get(
                    "dropout_implementation", "downgrade_in_infer"),
                dropout_is_test=bool(drop_op.attrs.get("is_test", False)))
        ins = {"Q": [m.var("q")], "K": [m.var("k")], "V": [m.var("v")]}
        in_slots = ["Q", "K", "V"]
        if with_mask:
            ins["Mask"] = [m.var("mask")]
            in_slots.append("Mask")
        fused = Operator(block, "fused_multihead_attention", ins,
                         {"Out": [m.var("out")]}, attrs)
        if train:
            g_ins = {"I_" + s: list(ins[s]) for s in in_slots}
            g_ins["G_Out"] = [m.var("go")]
            fused_g = Operator(
                block, "generic_grad", g_ins,
                {"GI_Q": [m.var("gq")], "GI_K": [m.var("gk")],
                 "GI_V": [m.var("gv")]},
                {"fwd_type": "fused_multihead_attention",
                 "fwd_attrs": dict(attrs), "in_slots": list(in_slots),
                 "grad_slots": ["Q", "K", "V"], "op_role": 1})
            _splice(block, fused_g, grad_ops[0], grad_ops)
        _splice(block, fused, mm2, fwd_ops)
        _count_rewrite(self.name)
        return True


# ---------------------------------------------------------------------------
# fuse_paged_attention
# ---------------------------------------------------------------------------

@register_pass
class FusePagedAttentionPass(PatternRewritePass):
    """gather(KPool, pt) → reshape → gather(VPool, pt) → reshape →
    mul+reduce_sum(dim=[2]) scores → scale → s·valid + scale(valid, N,
    -N) → softmax → mul+reduce_sum(dim=[1]) context ⇒ one
    ``paged_attention`` op (serving/decode.py paged decode/verify
    programs emit exactly this chain, once per unrolled step).

    The matched spelling is load-bearing: the op's plain version
    (ops/attention.py ``_paged_reference``) reproduces each unfused
    lowering bit for bit, so the rewrite is bit-transparent on the host;
    on the card the op is the hand-written paged-attention kernel.  The
    mask arithmetic is only recognised in the exact-zero form
    (``bias == -scale`` on the valid-scale op) — anything else is not
    the decode contract and stays unfused.  The program's
    ``kv_page_size`` hint is stamped on the op as ``page_size``."""

    name = "fuse_paged_attention"

    def __init__(self, **options):
        super().__init__(**options)
        self.rules.append(self._rule())

    def _rule(self):
        p = Pattern("paged_attention_decode")
        kp, vp, idx, q, valid, out = p.vars("kp vp idx q valid out")
        p.op("gather", ins={"X": [kp], "Index": [idx]},
             outs={"Out": [p.var("kgf")]})
        p.op("reshape2", ins={"X": [p.var("kgf")]},
             outs={"Out": [p.var("kg")]})
        p.op("gather", ins={"X": [vp], "Index": [idx]},
             outs={"Out": [p.var("vgf")]})
        p.op("reshape2", ins={"X": [p.var("vgf")]},
             outs={"Out": [p.var("vg")]})
        p.op("unsqueeze2", ins={"X": [q]}, outs={"Out": [p.var("qe")]},
             attrs={"axes": lambda a: list(a or ()) == [1]})
        p.op("elementwise_mul",
             ins={"X": [p.var("kg")], "Y": [p.var("qe")]},
             outs={"Out": [p.var("m1")]},
             attrs={"axis": lambda a: a in (None, -1)})
        p.op("reduce_sum", ins={"X": [p.var("m1")]},
             outs={"Out": [p.var("s0")]},
             attrs={"dim": lambda d: list(d or ()) == [2],
                    "keep_dim": _falsy, "reduce_all": _falsy})
        p.op("scale", ins={"X": [p.var("s0")]}, outs={"Out": [p.var("s1")]},
             attrs={"bias": _falsy,
                    "bias_after_scale": lambda b: b in (None, True)})
        p.op("elementwise_mul", ins={"X": [p.var("s1")], "Y": [valid]},
             outs={"Out": [p.var("sm")]},
             attrs={"axis": lambda a: a in (None, -1)})
        p.op("scale", ins={"X": [valid]}, outs={"Out": [p.var("vb")]},
             attrs={"bias_after_scale": lambda b: b in (None, True)})
        p.op("elementwise_add",
             ins={"X": [p.var("sm")], "Y": [p.var("vb")]},
             outs={"Out": [p.var("s2")]},
             attrs={"axis": lambda a: a in (None, -1)})
        p.op("softmax", ins={"X": [p.var("s2")]},
             outs={"Out": [p.var("p0")]},
             attrs={"axis": lambda a: a in (None, -1, 1)})
        p.op("unsqueeze2", ins={"X": [p.var("p0")]},
             outs={"Out": [p.var("pe")]},
             attrs={"axes": lambda a: list(a or ()) == [2]})
        p.op("elementwise_mul",
             ins={"X": [p.var("vg")], "Y": [p.var("pe")]},
             outs={"Out": [p.var("m2")]},
             attrs={"axis": lambda a: a in (None, -1)})
        p.op("reduce_sum", ins={"X": [p.var("m2")]},
             outs={"Out": [out]},
             attrs={"dim": lambda d: list(d or ()) == [1],
                    "keep_dim": _falsy, "reduce_all": _falsy})
        return (p, self._rewrite)

    def _rewrite(self, m, ctx) -> bool:
        block = m.block
        ops = m.ops
        # shape guards: flat [R, d] pools, [B, S, d] gathered caches,
        # [B, d] query, [B, S] mask — a coincidental gather→softmax
        # chain with other ranks is not the decode contract
        for name, nd in ((m.var("kp"), 2), (m.var("vp"), 2),
                         (m.var("kg"), 3), (m.var("vg"), 3),
                         (m.var("q"), 2), (m.var("valid"), 2),
                         (m.var("out"), 2)):
            if _ndim(block, name) != nd:
                return False
        # the mask must be the exact-zero spelling: valid*N + (-N)
        vb_op = ops[9]
        neg = float(vb_op.attrs.get("scale", 1.0))
        if float(vb_op.attrs.get("bias", 0.0) or 0.0) != -neg:
            return False
        # every intermediate dies with the rewrite
        inter = [m.binding[n] for n in
                 ("kgf", "kg", "vgf", "vg", "qe", "m1", "s0", "s1",
                  "sm", "vb", "s2", "p0", "pe", "m2")]
        for t in inter:
            if not _internal_edge(block, ctx, t, ops):
                return False
        if len(_widx(block, m.var("out"))) != 1:
            return False
        # reshape2/unsqueeze2 XShape side outputs must be unconsumed
        for op in ops:
            for slot, names in op.outputs.items():
                if slot == "Out":
                    continue
                for n in names:
                    if _consumers(block, n):
                        return False
        scale = float(ops[7].attrs.get("scale", 1.0))
        ps = int(block.program._hints.get("kv_page_size", 1) or 1)
        fused = Operator(
            block, "paged_attention",
            {"Q": [m.var("q")], "KPool": [m.var("kp")],
             "VPool": [m.var("vp")], "Index": [m.var("idx")],
             "Valid": [m.var("valid")]},
            {"Out": [m.var("out")]},
            {"scale": scale, "neg": neg, "page_size": ps,
             "op_role": ops[0].attrs.get("op_role", 0)})
        _splice(block, fused, ops[-1], ops)
        _count_rewrite(self.name)
        return True


# ---------------------------------------------------------------------------
# fuse_sparse_embedding
# ---------------------------------------------------------------------------

_LOOKUPS = ("lookup_table_v2", "lookup_table")


@register_pass
class FuseSparseEmbeddingPass(PatternRewritePass):
    """``lookup_table[_v2]`` + (``sequence_pool``(SUM/AVERAGE) |
    ``reduce_sum(dim=[1])``) ⇒ ``fused_embedding_pool`` — the PaddleBox
    fused_embedding_seq_pool path.  Training programs collapse the two
    generic_grad ops into one whose backward is the fused scatter-add."""

    name = "fuse_sparse_embedding"

    def __init__(self, **options):
        super().__init__(**options)
        for train in (True, False):
            for pool_kind in ("sequence_pool", "reduce_sum"):
                self.rules.append(self._rule(train, pool_kind))

    def _rule(self, train, pool_kind):
        p = Pattern(f"emb_pool_{pool_kind}_{'train' if train else 'fwd'}")
        w, ids, e, out = p.vars("w ids e out")
        p.op(_LOOKUPS, ins={"W": [w], "Ids": [ids]}, outs={"Out": [e]})
        if pool_kind == "sequence_pool":
            p.op("sequence_pool", ins={"X": [e]}, outs={"Out": [out]},
                 attrs={"pooltype": lambda t: str(t).upper()
                        in ("SUM", "AVERAGE")})
        else:
            p.op("reduce_sum", ins={"X": [e]}, outs={"Out": [out]},
                 attrs={"dim": lambda d: list(d or ()) == [1],
                        "keep_dim": _falsy, "reduce_all": _falsy})
        if train:
            p.op("generic_grad", ins={"I_X": [e], "G_Out": [p.var("g")]},
                 outs={"GI_X": [p.var("ge")]},
                 attrs={"fwd_type": pool_kind})
            p.op("generic_grad", ins={"I_W": [w], "G_Out": [p.var("ge")]},
                 outs={"GI_W": [p.var("gw")]},
                 attrs={"fwd_type": lambda t: t in _LOOKUPS})

        def rewrite(m, ctx, _flags=(train, pool_kind)):
            return self._rewrite(m, ctx, *_flags)

        return (p, rewrite)

    def _rewrite(self, m, ctx, train, pool_kind) -> bool:
        block = m.block
        lookup, pool = m.ops[0], m.ops[1]
        grad_ops = m.ops[2:]
        # the gathered [B, S, D] intermediate dies with the rewrite
        if not _internal_edge(block, ctx, m.var("e"), m.ops):
            return False
        nd = _ndim(block, m.var("e"))
        if nd is not None and nd != 3:
            return False
        if nd is None and pool_kind == "reduce_sum":
            return False          # reduce_sum(dim=1) is only a pool on 3-d
        if len(_widx(block, m.var("out"))) != 1:
            return False
        # side outputs of the pooled op (MaxIndex) must be unconsumed
        for slot, names in pool.outputs.items():
            if slot == "Out":
                continue
            for n in names:
                if _consumers(block, n):
                    return False
        if train:
            if not _internal_edge(block, ctx, m.var("ge"), m.ops):
                return False
            if len(_widx(block, m.var("gw"))) != 1:
                return False

        attrs = {"pooltype": str(pool.attrs.get("pooltype", "SUM")).upper()
                 if pool_kind == "sequence_pool" else "SUM",
                 "padding_idx": lookup.attrs.get("padding_idx", -1),
                 "squeeze_ids": lookup.type == "lookup_table",
                 "op_role": lookup.attrs.get("op_role", 0)}
        ins = {"W": [m.var("w")], "Ids": [m.var("ids")]}
        in_slots = ["W", "Ids"]
        length = (pool.inputs.get("Length") or [None])[0] \
            if pool_kind == "sequence_pool" else None
        if length is not None:
            ins["Length"] = [length]
            in_slots.append("Length")
        fused = Operator(block, "fused_embedding_pool", ins,
                         {"Out": [m.var("out")]}, attrs)
        if train:
            g_ins = {"I_" + s: list(ins[s]) for s in in_slots}
            g_ins["G_Out"] = [m.var("g")]
            fused_g = Operator(
                block, "generic_grad", g_ins, {"GI_W": [m.var("gw")]},
                {"fwd_type": "fused_embedding_pool",
                 "fwd_attrs": dict(attrs), "in_slots": list(in_slots),
                 "grad_slots": ["W"], "op_role": 1})
            _splice(block, fused_g, grad_ops[0], grad_ops)
        _splice(block, fused, pool, [lookup, pool])
        _count_rewrite(self.name)
        return True


# ---------------------------------------------------------------------------
# fuse_optimizer
# ---------------------------------------------------------------------------

_ADAM_INS = frozenset({"Param", "Grad", "Moment1", "Moment2", "Beta1Pow",
                       "Beta2Pow", "LearningRate"})
_ADAM_OUTS = ("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
              "Beta2PowOut")
_FUSABLE_UPDATES: Dict[str, Dict] = {
    "adam": {"fused": "fused_adam", "ins": _ADAM_INS, "outs": _ADAM_OUTS},
    "lamb": {"fused": "fused_lamb", "ins": _ADAM_INS, "outs": _ADAM_OUTS},
    "momentum": {"fused": "fused_momentum",
                 "ins": frozenset({"Param", "Grad", "Velocity",
                                   "LearningRate"}),
                 "outs": ("ParamOut", "VelocityOut")},
}

_SHARED_SLOTS = ("LearningRate",)


@register_pass
class FuseOptimizerPass(Pass):
    """Bucket consecutive same-family per-param update ops into one fused
    update op (fuse_adam_op_pass / fuse_momentum_op_pass semantics), at
    most ``bucket_size`` ops a bucket.  The bucket key is (op type, param
    dtype, whether the ops carry fp32 masters, the lr var, the full attr
    set), so a bucket is always homogeneous: one launch.  A bucket with
    masters carries ``MasterParam`` and ``MasterParamOut``.  The
    reference also keys by a sharding plan's PartitionSpec; the port has
    no sharding plan yet."""

    name = "fuse_optimizer"

    def __init__(self, bucket_size: int = 1024, **options):
        super().__init__(**options)
        self.bucket_size = max(int(bucket_size), 2)

    # -- bucket keying ------------------------------------------------------
    def _key(self, block, op) -> Optional[tuple]:
        spec = _FUSABLE_UPDATES.get(op.type)
        if spec is None:
            return None
        has_master = "MasterParam" in op.inputs
        if set(op.inputs) != spec["ins"] | (
                {"MasterParam"} if has_master else set()):
            return None            # SkipUpdate or exotic wiring: leave it
        if any(len(names) != 1 for names in op.inputs.values()):
            return None
        v = block._find_var_recursive(op.inputs["Param"][0])
        dtype = v.dtype if v is not None else None
        attr_sig = tuple(sorted((k, repr(val)) for k, val in op.attrs.items()
                                if k not in ("op_role", "op_seed")))
        return (op.type, str(dtype), has_master,
                op.inputs["LearningRate"][0], attr_sig)

    # -- rewriting ----------------------------------------------------------
    def _fuse_run(self, block, seg, out_ops) -> int:
        """Fuse one same-key run, ``bucket_size`` ops a bucket; returns
        the number of ops removed."""
        if len(seg) < 2:
            out_ops.extend(seg)
            return 0
        spec = _FUSABLE_UPDATES[seg[0].type]
        # per-param vars must be pairwise disjoint (params shared between
        # two update ops would race inside one fused op)
        per_param = [n for op in seg for slot, names in op.inputs.items()
                     if slot not in _SHARED_SLOTS for n in names]
        if len(set(per_param)) != len(per_param):
            out_ops.extend(seg)
            return 0
        removed = 0
        out_slots = list(spec["outs"]) + (
            ["MasterParamOut"] if "MasterParam" in seg[0].inputs else [])
        for lo in range(0, len(seg), self.bucket_size):
            chunk = seg[lo:lo + self.bucket_size]
            if len(chunk) < 2:
                out_ops.extend(chunk)
                continue
            ins = {slot: [op.inputs[slot][0] for op in chunk]
                   for slot in chunk[0].inputs if slot not in _SHARED_SLOTS}
            ins["LearningRate"] = list(chunk[0].inputs["LearningRate"])
            outs = {slot: [op.outputs[slot][0] for op in chunk]
                    for slot in out_slots}
            out_ops.append(Operator(
                block, spec["fused"], ins, outs, dict(chunk[0].attrs)))
            removed += len(chunk) - 1
            _count_rewrite(self.name)
        return removed

    def apply_block(self, block, ctx: PassContext) -> Dict[str, int]:
        out_ops: list = []
        seg: list = []
        seg_key = None
        removed = 0

        def flush():
            nonlocal removed
            if seg:
                removed += self._fuse_run(block, seg, out_ops)
                seg.clear()

        for op in block.ops:
            key = self._key(block, op)
            if key is not None:
                if seg and key != seg_key:
                    flush()
                seg_key = key
                seg.append(op)
            else:
                flush()
                out_ops.append(op)
        flush()
        if removed:
            block.ops = out_ops
            block.program._bump_version()
        return {"ops_removed": removed}
