"""Op-level autodiff over the Program IR (counterpart of
``paddle_tpu/fluid/backward.py``).

``append_backward`` reverse-walks the ops of a block and appends one
``generic_grad`` op per differentiable forward op, plus ``sum`` ops for
fan-in, under the reference's grad-var names (``<var>@GRAD``, with
``@RENAME_<k>`` partials).  There are no hand-written grad ops: the
``generic_grad`` lowering computes input cotangents with
``torch.func.vjp`` over the forward op's own lowering rule, so it
recomputes that forward (the TPU package's XLA removes the duplicate by
CSE; the port's eager executor runs it twice).  Ops with special grad
semantics register a ``custom_grad`` (ops/registry.py).

The executor runs every lowering under ``torch.no_grad()``;
``torch.func.vjp`` enables autograd inside the function it
differentiates, so the gradients come out all the same.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

import torch

from ..ops.registry import register_op, get_op, has_op
from .framework import Block, Variable, Parameter

GRAD_SUFFIX = "@GRAD"


def _grad_name(name: str) -> str:
    return name + GRAD_SUFFIX


def _is_float(x) -> bool:
    return torch.is_tensor(x) and x.is_floating_point()


# ---------------------------------------------------------------------------
# the generic grad op
# ---------------------------------------------------------------------------
@register_op("generic_grad", differentiable=False)
def _generic_grad(ins, attrs, ctx):
    """ins:  I_<slot> forward inputs, G_<slot> output cotangents.
    outs: GI_<slot> input cotangents (only for slots listed in grad_slots).
    """
    fwd_def = get_op(attrs["fwd_type"])
    fwd_attrs = attrs["fwd_attrs"]
    grad_slots: List[str] = attrs["grad_slots"]         # slots needing grads
    in_slots: List[str] = attrs["in_slots"]

    fwd_ins = {s: list(ins.get("I_" + s, [])) for s in in_slots}

    if fwd_def.custom_grad is not None:
        # no custom grad reads the forward's outputs, so the forward is
        # not run again (on the TPU, XLA drops that recompute as dead code;
        # here it would launch the forward kernel a second time)
        out_grads = {s[2:]: list(gs) if fwd_def.grad_lists else gs[0]
                     for s, gs in ins.items() if s.startswith("G_") and gs}
        in_grads = fwd_def.custom_grad(fwd_ins, None, out_grads,
                                       fwd_attrs, ctx)
        return {"GI_" + s: v for s, v in in_grads.items() if s in grad_slots}

    # the differentiated arguments: float inputs of the grad slots; the
    # rest (nondiff slots, ints) are closed over
    diff_at = [(s, i) for s in in_slots
               if s in grad_slots and s not in fwd_def.nondiff_inputs
               for i, a in enumerate(fwd_ins[s]) if _is_float(a)]
    out_at = []                 # (slot, index) of each differentiated output

    def fwd_fn(*diff):
        merged = {s: list(v) for s, v in fwd_ins.items()}
        for (s, i), d in zip(diff_at, diff):
            merged[s][i] = d
        outs = fwd_def.fn(merged, fwd_attrs, ctx)
        out_at.clear()
        flat = []
        for s, vals in outs.items():
            if s in fwd_def.nondiff_outputs:
                continue
            for i, o in enumerate(vals):
                if _is_float(o):
                    out_at.append((s, i))
                    flat.append(o)
        return tuple(flat)

    primal_outs, vjp_fn = torch.func.vjp(
        fwd_fn, *(fwd_ins[s][i] for s, i in diff_at))
    cotangents = []
    for (s, i), o in zip(out_at, primal_outs):
        gs = ins.get("G_" + s, [])
        g = gs[i] if i < len(gs) else None
        cotangents.append(torch.zeros_like(o) if g is None
                          else g.to(o.dtype))
    in_grads = dict(zip(diff_at, vjp_fn(tuple(cotangents))))
    zero = torch.zeros((), dtype=torch.float32, device=ctx.device)
    return {"GI_" + s: [in_grads.get((s, i), zero)
                        for i in range(len(fwd_ins[s]))]
            for s in grad_slots}


# ---------------------------------------------------------------------------
# append_backward
# ---------------------------------------------------------------------------
def _forward_requires(block: Block, no_grad: Set[str]) -> Set[str]:
    """Forward propagate 'requires grad' from trainable leaves."""
    req = set()
    for v in block.program.global_block().vars.values():
        if isinstance(v, Parameter) and v.trainable and v.name not in no_grad:
            req.add(v.name)
    for v in block.vars.values():
        if v.is_data and not v.stop_gradient and v.name not in no_grad:
            req.add(v.name)
    for op in block.ops:
        opdef = get_op(op.type) if has_op(op.type) else None
        if opdef is None or not opdef.differentiable:
            continue
        if any(n in req for n in op.input_arg_names):
            for n in op.output_arg_names:
                var = block._find_var_recursive(n)
                if var is None or not var.stop_gradient:
                    req.add(n)
    return req


def _relevant_to(block: Block, loss_name: str) -> Set[str]:
    """Backward reachability: vars that influence the loss."""
    rel = {loss_name}
    for op in reversed(block.ops):
        if any(n in rel for n in op.output_arg_names):
            rel.update(op.input_arg_names)
    return rel


def append_backward(loss: Variable, parameter_list=None,
                    no_grad_set: Optional[Set[str]] = None,
                    callbacks=None, checkpoints=None) -> List:
    """Append grad ops computing d(loss)/d(param) for every trainable
    param; returns [(param, grad_var)] like the reference.
    ``callbacks`` and ``checkpoints`` are accepted and, as in the
    reference, do not change the ops: the executor runs no recompute
    segments (``RecomputeOptimizer`` records them as a program hint)."""
    block = loss.block
    program = block.program
    no_grad = set(no_grad_set or ())
    requires = _forward_requires(block, no_grad)
    relevant = _relevant_to(block, loss.name)

    # loss cotangent = 1 (fill_constant, like fluid's fill op for loss@GRAD)
    loss_grad = _grad_name(loss.name)
    block.append_op(
        "fill_constant", outputs={"Out": [loss_grad]},
        attrs={"shape": list(loss.shape or ()), "value": 1.0,
               "dtype": loss.dtype or "float32", "op_role": 1})
    block.var(loss_grad).stop_gradient = True

    # var -> list of partial grad var names (summed at the end)
    grads: Dict[str, List[str]] = {loss.name: [loss_grad]}

    fwd_ops = list(block.ops[:-1])   # exclude the fill just added
    for op in reversed(fwd_ops):
        if not has_op(op.type) or op.type == "generic_grad":
            continue
        opdef = get_op(op.type)
        if not opdef.differentiable:
            continue
        if not any(n in relevant and n in grads for n in op.output_arg_names):
            continue
        grad_slots = []
        for slot, names in op.inputs.items():
            if slot in opdef.nondiff_inputs:
                continue
            if any(n in requires and n not in no_grad for n in names):
                grad_slots.append(slot)
        if not grad_slots:
            continue

        g_ins: Dict[str, List[str]] = {}
        for slot, names in op.inputs.items():
            g_ins["I_" + slot] = list(names)
        has_any_outgrad = False
        for slot, names in op.outputs.items():
            if slot in opdef.nondiff_outputs:
                continue
            gnames = []
            ok = False
            for n in names:
                if n in grads:
                    gnames.append(_sum_partials(block, n, grads))
                    ok = True
                else:
                    gnames = None
                    break
            if ok and gnames is not None:
                g_ins["G_" + slot] = gnames
                has_any_outgrad = True
        if not has_any_outgrad:
            continue

        g_outs: Dict[str, List[str]] = {}
        for slot in grad_slots:
            outs = []
            for n in op.input(slot):
                gname = _grad_name(n)
                if n in grads or gname in {x for v in grads.values()
                                           for x in v}:
                    gname = gname + "@RENAME_" + str(len(grads.get(n, [])))
                outs.append(gname)
                grads.setdefault(n, []).append(gname)
            g_outs["GI_" + slot] = outs

        block.append_op(
            "generic_grad", inputs=g_ins, outputs=g_outs,
            attrs={"fwd_type": op.type, "fwd_attrs": dict(op.attrs),
                   "in_slots": list(op.inputs.keys()),
                   "grad_slots": grad_slots, "op_role": 1})
        for slot_outs in g_outs.values():
            for n in slot_outs:
                block.var(n).stop_gradient = True

    # build (param, grad) list
    params = (list(parameter_list) if parameter_list
              else [p for p in program.all_parameters() if p.trainable])
    result = []
    for p in params:
        p_obj = p if isinstance(p, Variable) else block.var(p)
        if p_obj.name in no_grad or p_obj.name not in grads:
            continue
        gname = _sum_partials(block, p_obj.name, grads)
        gvar = block.var(gname)
        gvar.shape = p_obj.shape
        gvar.dtype = p_obj.dtype
        result.append((p_obj, gvar))
    return result


def _sum_partials(block: Block, name: str, grads: Dict[str, List[str]]) -> str:
    """Collapse accumulated partial grads into one var (fluid's inserted
    ``sum`` op for fan-in)."""
    parts = grads[name]
    if len(parts) == 1:
        final = parts[0]
    else:
        final = _grad_name(name)
        if final in parts:
            final = final + "@SUM"
        block.append_op("sum", inputs={"X": parts},
                        outputs={"Out": [final]}, attrs={"op_role": 1})
        block.var(final).stop_gradient = True
    grads[name] = [final]
    return final


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """The gradients of ``targets[0]`` with respect to each of
    ``inputs`` (fluid ``calc_gradient``): the backward is appended, and
    each input's ``@GRAD`` var returned, or None where the target does
    not depend on it."""
    t = targets[0] if isinstance(targets, (list, tuple)) else targets
    append_backward(t, parameter_list=None, no_grad_set=no_grad_set)
    ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    return [t.block.var(_grad_name(v.name))
            if t.block.has_var(_grad_name(v.name)) else None for v in ins]
