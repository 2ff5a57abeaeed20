"""bf16 mixed precision as registered Program-IR passes.

Counterpart of ``paddle_tpu/fluid/passes/amp.py`` (reference
python/paddle/fluid/contrib/mixed_precision/fp16_utils.py
``rewrite_program``: cast insertion per black/white lists).  The fast
dtype is bfloat16: on the card a bf16 ``mul`` runs on cuBLAS's tensor
cores with float32 accumulation, and bf16 keeps float32's exponent range,
so loss scaling is optional.  Two passes:

* ``amp_bf16`` — a dtype-dataflow rewriter.  Walks the global block
  tracking the runtime dtype of every value (var metadata only seeds the
  walk) and inserts a fresh ``cast`` per consumed edge: white-list ops get
  bf16 inputs, black-list ops (reductions, softmax, losses, grad ``sum``
  fan-in) get float32 back, gray ops follow their inputs (a bf16 operand
  pulls float32 operands down, so the bias-add after a bf16 product does
  not promote the activation back).  Each forward op is paired with its
  ``generic_grad`` (the vjp recompute sees the same input dtypes as the
  forward), the ``I_<slot>`` mirrors get their own casts, and the
  ``GI_<slot>`` cotangents are cast back to the var's dtype, so
  parameter gradients land in float32.
* ``prune_redundant_casts`` — removes identity casts, dedupes identical
  casts of one var, collapses lossless chains (bf16 -> f32 -> bf16 is the
  identity; f32 -> bf16 -> f32 is not), and folds the surviving
  amp-inserted casts into their consumer ops as a ``__amp_cast__`` attr
  that ``executor.run_block_ops`` applies inline, on every device.

Both produce the reference's program op for op.  Metrics:
``amp.ops_cast`` / ``amp.casts_pruned`` / ``amp.unclassified_ops``
counters and the ``amp.dtype_hist.<dtype>`` gauges.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional

import torch

from .. import trace
from ..framework import (Operator, convert_dtype, unique_name,
                         _op_reads, _OPTIMIZER_OP_TYPES)
from .core import Pass, PassContext, register_pass
from .pattern import writer_index as _writer_idxs

__all__ = ["AmpBf16Pass", "PruneRedundantCastsPass"]

# ops the rewriter never touches: plumbing, control flow (sub-block
# captures can't be re-aliased safely), the loss-scaling machinery, and
# the optimizer update tail (master weights own that precision story)
_SKIP_TYPES = frozenset({
    "feed", "fetch", "cast", "fill_constant", "assign", "while",
    "conditional_block", "select_input", "select_output", "recurrent",
    "py_func", "print", "check_finite_and_unscale", "update_loss_scaling",
    "generic_grad",
}) | _OPTIMIZER_OP_TYPES

_FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")
_LOW_DTYPES = ("float16", "bfloat16")


def _promote(a: Optional[str], b: Optional[str]) -> Optional[str]:
    if a is None:
        return b
    if b is None:
        return a
    try:
        return str(torch.promote_types(getattr(torch, a),
                                       getattr(torch, b))
                   ).removeprefix("torch.")
    except (AttributeError, TypeError):
        return a


@register_pass
class AmpBf16Pass(Pass):
    """Insert casts so white-list ops consume bf16 and black-list ops
    fp32, with the grad halves kept dtype-consistent (see module
    docstring).  Deliberately local: one fresh cast per consumed edge —
    global cleanup is prune_redundant_casts' job."""

    name = "amp_bf16"
    writes = frozenset({"ops", "vars", "attrs"})

    def __init__(self, dtype: str = "bfloat16", custom_white_list=None,
                 custom_black_list=None, **options):
        super().__init__(**options)
        self.dtype = str(dtype)
        self._custom_white = frozenset(custom_white_list or ())
        self._custom_black = frozenset(custom_black_list or ())
        self._warned: set = set()

    # -- grad pairing -------------------------------------------------------
    @staticmethod
    def _pair_grads(block) -> Dict[int, List[Operator]]:
        """id(forward op) -> its generic_grad ops: the grad's I_<slot>
        mirrors must equal the forward's input lists (how append_backward
        builds them), so the vjp recompute sees the forward's exact
        values."""
        pairs: Dict[int, List[Operator]] = {}
        grads = [op for op in block.ops if op.type == "generic_grad"]
        used: set = set()
        for f in block.ops:
            if f.type == "generic_grad":
                continue
            for g in grads:
                if id(g) in used or g.attrs.get("fwd_type") != f.type:
                    continue
                if all(g.inputs.get("I_" + s) == list(ns)
                       for s, ns in f.inputs.items()):
                    pairs.setdefault(id(f), []).append(g)
                    used.add(id(g))
                    break
        return pairs

    # -- the walk -----------------------------------------------------------
    def apply(self, program, ctx: PassContext) -> Dict[str, int]:
        block = program.global_block()
        stats = self._apply_block(block, ctx)
        program._amp_enabled = True
        program._amp_dtype = self.dtype
        program._hints["amp_dtype"] = self.dtype
        trace.metrics().counter("amp.ops_cast").inc(
            stats.get("casts_inserted", 0))
        # program dtype histogram: how much of the value plane actually
        # runs low-precision after the rewrite
        hist: Dict[str, int] = {}
        for v in block.vars.values():
            d = v.dtype or "unknown"
            hist[d] = hist.get(d, 0) + 1
        for d, n in hist.items():
            trace.metrics().gauge(f"amp.dtype_hist.{d}").set(n)
        return stats

    def _apply_block(self, block, ctx: PassContext) -> Dict[str, int]:
        env: Dict[str, str] = {}     # value name -> runtime dtype

        def dt_of(name: str) -> Optional[str]:
            if name in env:
                return env[name]
            v = block._find_var_recursive(name)
            return v.dtype if v is not None else None

        pairs = self._pair_grads(block)
        inserted = rewritten = 0
        for op in list(block.ops):
            role = int(op.attrs.get("op_role", 0) or 0)
            if op.type in _SKIP_TYPES or role != 0:
                self._flow_through(block, op, env, dt_of)
                continue
            kind = self._classify(op.type)
            in_dts = [dt_of(n) for n in op.input_arg_names]
            float_in = [d for d in in_dts if d in _FLOAT_DTYPES]
            target = None
            if kind == "white":
                target = self.dtype
                from_dts = ("float32", "float64")
            elif kind in ("black", "fp32", "unclassified"):
                if kind == "unclassified" and op.type not in self._warned:
                    # registry-audit escape hatch: a matmul/conv-family op
                    # nobody classified runs fp32, loudly, once
                    self._warned.add(op.type)
                    trace.metrics().counter("amp.unclassified_ops").inc()
                    print(f"paddle_tpu_torch: WARNING: AMP found "
                          f"unclassified matmul/conv-family op "
                          f"'{op.type}' — running it fp32; add it to "
                          f"amp/lists.py WHITE_OPS/FP32_FAMILY_OPS",
                          file=sys.stderr)
                if any(d in _LOW_DTYPES for d in float_in):
                    target = "float32"
                    from_dts = _LOW_DTYPES
            else:                                   # gray: follow inputs
                if (self.dtype in float_in
                        and any(d in ("float32", "float64")
                                for d in float_in)):
                    target = self.dtype
                    from_dts = ("float32", "float64")
            if target is not None:
                n_cast = self._rewrite_op(block, op, target, from_dts,
                                          env, dt_of, pairs)
                inserted += n_cast
                rewritten += 1 if n_cast else 0
            self._flow_through(block, op, env, dt_of,
                               forced=self.dtype if kind == "white"
                               else target)
        return {"casts_inserted": inserted, "ops_rewritten": rewritten}

    def _classify(self, op_type: str) -> str:
        # single source of truth for the taxonomy (and the union
        # semantics of the custom lists): amp.lists.classify
        from ...amp.lists import classify
        return classify(op_type, white=self._custom_white,
                        black=self._custom_black)

    def _flow_through(self, block, op, env, dt_of, forced=None) -> None:
        """Update the dtype env for ``op``'s outputs: forced compute dtype
        for rewritten ops, promotion of float inputs otherwise, var
        metadata as the fallback."""
        if op.type == "cast":
            for n in op.output_arg_names:
                env[n] = str(op.attrs.get("out_dtype", "float32"))
            return
        if op.type == "fill_constant":
            for n in op.output_arg_names:
                env[n] = str(op.attrs.get("dtype", "float32"))
            return
        flo = None
        for n in op.input_arg_names:
            d = dt_of(n)
            if d in _FLOAT_DTYPES:
                flo = _promote(flo, d)
        out_dt = forced or flo
        for n in op.output_arg_names:
            v = block._find_var_recursive(n)
            meta = v.dtype if v is not None else None
            if meta is not None and meta not in _FLOAT_DTYPES:
                env[n] = meta               # int/bool outputs keep dtype
                continue
            if out_dt is not None:
                env[n] = out_dt
                # keep IR metadata honest for downstream passes/fetch
                if v is not None and not v.persistable:
                    v.dtype = out_dt

    def _rewrite_op(self, block, op, target, from_dts, env, dt_of,
                    pairs) -> int:
        """Cast ``op``'s float inputs with dtypes in ``from_dts`` to
        ``target``; mirror onto paired generic_grads (fresh I_ casts, GI_
        cast-backs)."""
        n_cast = 0
        grads = pairs.get(id(op), [])
        for slot in list(op.inputs):
            names = op.inputs[slot]
            for j, name in enumerate(names):
                d = dt_of(name)
                if d not in from_dts or d == target:
                    continue
                if name in op.output_arg_names:
                    continue        # in-place state slot: never re-alias
                c = self._insert_cast(block, op, name, target)
                names[j] = c
                env[c] = target
                n_cast += 1
                for g in grads:
                    n_cast += self._rewrite_grad(block, g, slot, j, name,
                                                 c, d, target, env)
        if n_cast:
            block.program._bump_version()   # input rewires alone must
        return n_cast                       # never leave a stale digest

    def _insert_cast(self, block, before_op, name, to_dtype,
                     role: int = None) -> str:
        src = block._find_var_recursive(name)
        c = unique_name(f"{name}@amp.{to_dtype}")
        idx = block.ops.index(before_op)
        block._insert_op(
            idx, "cast", inputs={"X": [name]}, outputs={"Out": [c]},
            attrs={"out_dtype": to_dtype, "amp_inserted": True,
                   "op_role": int(before_op.attrs.get("op_role", 0)
                                  if role is None else role)})
        cv = block._find_var_recursive(c)
        cv.dtype = to_dtype
        if src is not None:
            if cv.shape is None:
                cv.shape = src.shape
            # differentiable-through (NOT stop_gradient): in the
            # pre-backward decorate flow append_backward must chain grads
            # through these casts, mirroring the source's own setting
            cv.stop_gradient = bool(src.stop_gradient)
        return c

    def _rewrite_grad(self, block, g, slot, j, name, cast_name, orig_dt,
                      target, env) -> int:
        """Keep a paired generic_grad dtype-consistent with its rewritten
        forward: fresh cast for the I_<slot> mirror (prune dedupes it
        against the forward's), and the GI_<slot> cotangent cast back to
        the original var dtype so downstream grad consumers (fan-in sum,
        the optimizer update) see what they saw before the rewrite."""
        n_cast = 0
        islot = "I_" + slot
        mirrors = g.inputs.get(islot)
        if mirrors is not None and j < len(mirrors) and mirrors[j] == name:
            c2 = self._insert_cast(block, g, name, target, role=1)
            mirrors[j] = c2
            env[c2] = target
            n_cast += 1
        gslot = "GI_" + slot
        gouts = g.outputs.get(gslot)
        if gouts is not None and j < len(gouts) and orig_dt != target:
            gname = gouts[j]
            tmp = unique_name(f"{gname}@amp.raw")
            gouts[j] = tmp
            tv = block.create_var(name=tmp, dtype=target,
                                  stop_gradient=True)
            gv = block._find_var_recursive(gname)
            if gv is not None:
                tv.shape = gv.shape
            idx = block.ops.index(g) + 1
            block._insert_op(
                idx, "cast", inputs={"X": [tmp]}, outputs={"Out": [gname]},
                attrs={"out_dtype": orig_dt, "amp_inserted": True,
                       "op_role": 1})
            if gv is not None:
                gv.dtype = orig_dt
            env[tmp] = target
            env[gname] = orig_dt
            n_cast += 1
        return n_cast


# ---------------------------------------------------------------------------
# cleanup: identity / duplicate / chain / fold
# ---------------------------------------------------------------------------

# precision-widening rank: a cast d0 -> d1 is LOSSLESS iff d1 represents
# every d0 value exactly (same dtype, or strictly wider).  bf16 and f16
# are mutually lossy (different mantissa/exponent splits).
_RANK = {"bfloat16": 1, "float16": 1, "float32": 2, "float64": 3}


def _lossless(d0: Optional[str], d1: Optional[str]) -> bool:
    if d0 is None or d1 is None:
        return False
    if d0 == d1:
        return True
    r0, r1 = _RANK.get(d0), _RANK.get(d1)
    return r0 is not None and r1 is not None and r1 > r0


_64_TO_32 = {"int64": "int32", "uint64": "uint32", "float64": "float32"}


def _device_dtype(dtype) -> str:
    """The dtype the reference's arrays have on its device (64-bit names
    narrowed, jax's x64 mode being off there).  The identity-cast rule
    compares these so both packages prune the same casts; the port's
    own tensors keep int64 ids."""
    name = convert_dtype(dtype)
    return _64_TO_32.get(name, name)


# consumers a cast can be folded into: anything the executor dispatches
# through a plain lowering rule.  Control flow (sub-block captures),
# plumbing, and nested-program carriers stay out.
_UNFOLDABLE = frozenset({
    "feed", "fetch", "while", "conditional_block", "select_input",
    "select_output", "recurrent", "py_func", "print", "cast",
})


@register_pass
class PruneRedundantCastsPass(Pass):
    """Remove the redundancy amp_bf16's local rewrite leaves behind —
    without ever changing fetch values: every rule below is value-exact
    (identity casts, duplicate casts, LOSSLESS chain collapse) or a pure
    relocation (folding the astype into the consumer's dispatch)."""

    name = "prune_redundant_casts"
    writes = frozenset({"ops", "attrs"})

    def apply_block(self, block, ctx: PassContext) -> Dict[str, int]:
        pruned = folded = 0
        # each sweep applies every currently-safe rewrite (not one per
        # full rescan — a BERT-scale block would pay O(casts * n^2)
        # otherwise); every rule strictly shrinks the op stream or a
        # cast chain, so the fixpoint loop terminates
        for _ in range(len(block.ops) + 8):
            n = self._prune_sweep(block, ctx)
            if not n:
                break
            pruned += n
        for _ in range(4):
            n = self._fold_all(block, ctx)
            if not n:
                break
            folded += n
        pruned += folded
        if pruned:
            trace.metrics().counter("amp.casts_pruned").inc(pruned)
        return {"casts_pruned": pruned, "casts_folded": folded}

    # -- shared safety checks ------------------------------------------------
    def _rewirable(self, block, ctx, out: str) -> bool:
        """May every consumer of ``out`` be pointed somewhere else?"""
        if ctx.is_protected(block, out):
            return False
        if len(_writer_idxs(block, out)) != 1:
            return False
        prog = block.program
        other = [o for b in prog.blocks for o in b.ops
                 if b is not block and out in _op_reads(b, o)]
        return not other and not any(
            out in repr(o.attrs.get("true_outs", ()))
            + repr(o.attrs.get("false_outs", ()))
            for b in prog.blocks for o in b.ops)

    @staticmethod
    def _src_stable(block, i0: int, i1: int, src: str) -> bool:
        """``src`` still holds the value op i0 read when op i1 runs."""
        return not any(src in op.output_arg_names
                       for op in block.ops[i0 + 1:i1])

    def _runtime_dtype(self, block, upto: int, name: str) -> Optional[str]:
        """Dataflow dtype of ``name`` as seen by ops[upto]: last writer's
        declared out dtype for casts/fills, var metadata otherwise."""
        for op in reversed(block.ops[:upto]):
            if name in op.output_arg_names:
                if op.type == "cast":
                    return str(op.attrs.get("out_dtype", "float32"))
                if op.type == "fill_constant":
                    return str(op.attrs.get("dtype", "float32"))
                break
        v = block._find_var_recursive(name)
        return v.dtype if v is not None else None

    # -- one SWEEP per call (fixpoint loop above): every rule re-checks
    # its safety conditions against the block's CURRENT state (indices
    # recomputed after each mutation), so batching rewrites is exactly as
    # conservative as one-rewrite-per-rescan — just O(casts * n) a sweep
    def _prune_sweep(self, block, ctx: PassContext) -> int:
        n_rewrites = 0
        by_key: Dict[tuple, Operator] = {}      # (src, dt) -> kept cast
        for op in list(block.ops):
            if (op.type != "cast" or not op.inputs.get("X")
                    or not op.outputs.get("Out")):
                continue
            try:
                i = block.ops.index(op)
            except ValueError:
                continue        # removed earlier in this sweep
            src, out = op.inputs["X"][0], op.outputs["Out"][0]
            dt = str(op.attrs.get("out_dtype", "float32"))
            src_dt = self._runtime_dtype(block, i, src)

            # 1. identity cast: the value already IS the target dtype
            try:
                same = (src_dt is not None
                        and _device_dtype(dt) == _device_dtype(src_dt))
            except (ValueError, TypeError):
                same = False
            if same and self._rewire_and_remove(block, ctx, i, op, src):
                n_rewrites += 1
                continue

            # 2. duplicate: an earlier cast of the same src to the same
            # dtype whose output is still valid here
            key = (src, dt)
            prev = by_key.get(key)
            if prev is not None:
                try:
                    j = block.ops.index(prev)
                except ValueError:
                    j = None    # the kept cast was itself removed
                prev_out = prev.outputs["Out"][0]
                if (j is not None and j < i
                        and self._src_stable(block, j, i, src)
                        and self._rewire_and_remove(block, ctx, i, op,
                                                    prev_out)):
                    n_rewrites += 1
                    continue
            else:
                if len(_writer_idxs(block, src)) <= 1 \
                        and len(_writer_idxs(block, out)) == 1:
                    by_key[key] = op

            # 3. lossless chain collapse: cast(cast(x, wide), dt) ==
            # cast(x, dt) — and when dt == dtype(x), rule 1 finishes it
            widx = _writer_idxs(block, src)
            if len(widx) == 1 and widx[0] < i:
                inner = block.ops[widx[0]]
                if (inner.type == "cast" and inner.inputs.get("X")
                        and not ctx.is_protected(block, src)):
                    x = inner.inputs["X"][0]
                    x_dt = self._runtime_dtype(block, widx[0], x)
                    mid = str(inner.attrs.get("out_dtype", "float32"))
                    if (_lossless(x_dt, mid)
                            and self._src_stable(block, widx[0], i, x)):
                        op.inputs["X"] = [x]
                        block.program._bump_version()
                        n_rewrites += 1
                        continue

            # 4. dead amp cast (orphaned by earlier rules)
            if op.attrs.get("amp_inserted") \
                    and not ctx.is_protected(block, out) \
                    and not self._consumers(block, op, out):
                block._remove_op(i)
                n_rewrites += 1
        return n_rewrites

    def _fold_all(self, block, ctx: PassContext) -> int:
        """One sweep folding every foldable amp cast into its consumers'
        dispatch (the final prune stage)."""
        folded = 0
        for op in [op for op in list(block.ops)
                   if op.type == "cast" and op.attrs.get("amp_inserted")
                   and op.inputs.get("X") and op.outputs.get("Out")]:
            i = block.ops.index(op)
            if self._fold_into_consumers(block, ctx, i, op):
                folded += 1
        return folded

    @staticmethod
    def _consumers(block, cast_op, out: str):
        return [o for o in block.ops
                if o is not cast_op and out in _op_reads(block, o)]

    def _rewire_and_remove(self, block, ctx, i, op, repl: str) -> bool:
        out = op.outputs["Out"][0]
        if out == repl or not self._rewirable(block, ctx, out):
            return False
        consumers = [o for o in block.ops
                     if o is not op and out in _op_reads(block, o)]
        for o in consumers:
            # repl must still hold the value this cast read when the
            # consumer runs — an in-place writer of repl between them
            # (assign/check_finite/optimizer update) would change fetches
            if not self._src_stable(block, i, block.ops.index(o), repl):
                return False
        for o in consumers:
            for slot, names in o.inputs.items():
                if out in names:
                    o.inputs[slot] = [repl if n == out else n
                                      for n in names]
        block._remove_op(block.ops.index(op))
        return True

    def _fold_into_consumers(self, block, ctx, i, op) -> bool:
        """Turn ``y = cast(x); f(y)`` into ``f(x)`` with a
        ``__amp_cast__`` attr on f — the executor applies the astype
        inline while gathering inputs (run_block_ops), so the cast costs
        zero dispatched ops.  Value-exact: same astype, same place in the
        dataflow."""
        src, out = op.inputs["X"][0], op.outputs["Out"][0]
        dt = str(op.attrs.get("out_dtype", "float32"))
        if not self._rewirable(block, ctx, out):
            return False
        consumers = self._consumers(block, op, out)
        if not consumers or any(o.type in _UNFOLDABLE for o in consumers):
            return False
        ci = block.ops.index(op)
        for o in consumers:
            if not self._src_stable(block, ci, block.ops.index(o), src):
                return False
        for o in consumers:
            amp = {k: list(v) for k, v in
                   (o.attrs.get("__amp_cast__") or {}).items()}
            for slot, names in o.inputs.items():
                if out not in names:
                    continue
                dts = amp.get(slot) or [None] * len(names)
                if len(dts) < len(names):
                    dts = list(dts) + [None] * (len(names) - len(dts))
                for k, n in enumerate(names):
                    if n == out:
                        names[k] = src
                        dts[k] = dt
                amp[slot] = dts
            o.set_attr("__amp_cast__", amp)
        block._remove_op(block.ops.index(op))
        return True
