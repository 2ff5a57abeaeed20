"""Control-flow ops on the eager executor: ``while``,
``conditional_block`` and ``select_input`` (``select_output`` is
dispatched here and raises, as in the reference).

Counterpart of ``paddle_tpu/fluid/control_flow_impl.py``, with the same
semantics: a sub-block runs over the enclosing env; what the caller sees
after the op is the set of vars the body writes, plus everything it
reads (the carry); a ``conditional_block`` without a false block passes
its outputs' earlier values through.  The TPU package traces the
sub-blocks into ``lax.while_loop`` and ``lax.cond``; here they run op by
op, as the rest of the block does.

The design, and the host syncs it costs:

- ``while`` reads its predicate on the host before every trip: the trip
  count decides how many ops are launched, so it must be known there.
  That is one sync a trip.
- ``conditional_block`` runs its branches and picks the outputs with
  ``torch.where`` on the predicate where it lies, so a conditional costs
  no sync.  A learning-rate schedule built with ``Switch`` (two or more
  ``conditional_block`` ops a step) then never makes a step wait on the
  host, and the async window (``fluid/async_pipeline.py``) keeps its
  steps in flight.  Selection is exact, so the result is the taken
  branch's value bit for bit.  A branch whose effect no selection can
  undo, a nested ``while``, a tensor-array op, ``print`` or ``assert``,
  reads the predicate on the host instead and runs only the taken
  branch.

Each host read adds one to the ``control_flow.host_reads`` counter.
As in the reference no gradient flows through ``while`` or
``conditional_block``: ``append_backward`` skips ops it has no lowering
for.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from . import trace
from .framework import _op_reads

CONTROL_FLOW_OPS = ("while", "conditional_block", "select_input",
                    "select_output")

# ops whose effect a select cannot take back: a branch holding one runs
# only when taken, which needs its predicate on the host
_HOST_EFFECT_OPS = frozenset({
    "while", "print", "assert", "write_to_array", "read_from_array",
    "lod_array_length", "recurrent"})


def _block_reads_writes(block):
    """Reads (in first-read order) and writes of a block, nested
    sub-blocks' captures included (``framework._op_reads``, shared with
    the pruner)."""
    reads, writes = [], set()
    for op in block.ops:
        for n in _op_reads(block, op):
            if n not in writes and n not in reads:
                reads.append(n)
        writes.update(op.output_arg_names)
    return reads, sorted(writes)


def _host_effects(block) -> bool:
    prog = block.program
    for op in block.ops:
        if op.type in _HOST_EFFECT_OPS:
            return True
        for attr in ("sub_block", "cond_block", "true_block", "false_block"):
            idx = op.attrs.get(attr)
            if isinstance(idx, int) and 0 <= idx < len(prog.blocks) \
                    and _host_effects(prog.blocks[idx]):
                return True
    return False


def _host_bool(t) -> bool:
    """The predicate's one value, read on the host (one sync on the
    card)."""
    trace.metrics().counter("control_flow.host_reads").inc()
    return bool(t.reshape(-1)[0].item())


def _select(pred, a, b):
    """``a`` where ``pred`` else ``b``, exactly; lists (tensor arrays)
    element by element."""
    if isinstance(a, list):
        return [_select(pred, x, y) for x, y in zip(a, b)]
    if not torch.is_tensor(a):
        return a
    p = pred.reshape(()).to(device=a.device, dtype=torch.bool)
    return torch.where(p, a, b.to(a.dtype))


def run_control_flow_op(op, block, env: Dict[str, Any], ctx) -> None:
    from .executor import run_block_ops
    program = block.program

    if op.type == "while":
        cond_block = program.blocks[op.attr("cond_block")]
        body_block = program.blocks[op.attr("sub_block")]
        _, b_writes = _block_reads_writes(body_block)
        cond_out = op.attr("cond_var")
        e = dict(env)
        while True:
            run_block_ops(cond_block, e, ctx)
            if not _host_bool(e[cond_out]):
                break
            run_block_ops(body_block, e, ctx)
        env.update({n: e[n] for n in b_writes if n in e})
        env.update({n: e[n] for n in op.output_arg_names if n in e})
        return

    if op.type == "conditional_block":
        true_block = program.blocks[op.attr("true_block")]
        false_idx = op.attr("false_block", -1)
        false_block = program.blocks[false_idx] if false_idx >= 0 else None
        out_names = op.output("Out")
        t_outs = op.attr("true_outs")
        f_outs = op.attr("false_outs") if false_block is not None \
            else t_outs
        if false_block is None:
            missing = [n for n in t_outs if n not in env]
            if missing:
                raise KeyError(
                    f"conditional_block outputs {missing} have no prior "
                    f"value: define them before the conditional")
        pred = env[op.input("Cond")[0]]

        def branch(blk, names):
            if blk is None:           # the pass-through false path
                return [env[n] for n in names]
            e = run_block_ops(blk, dict(env), ctx)
            return [e[n] for n in names]

        if _host_effects(true_block) or (
                false_block is not None and _host_effects(false_block)):
            taken = _host_bool(pred)
            result = branch(true_block, t_outs) if taken \
                else branch(false_block, f_outs)
        else:
            result = [_select(pred, a, b) for a, b in zip(
                branch(true_block, t_outs), branch(false_block, f_outs))]
        env.update(zip(out_names, result))
        return

    if op.type == "select_input":
        mask = env[op.input("Mask")[0]].reshape(()).to(torch.int64)
        xs = [env[n] for n in op.input("X")]
        out = xs[0]
        for i in range(1, len(xs)):
            out = _select(mask == i, xs[i], out)
        env[op.output("Out")[0]] = out
        return

    raise NotImplementedError(f"control flow op {op.type}")
