"""Dygraph core: eager tensors and tape autograd on torch tensors.

Counterpart of ``paddle_tpu/dygraph/base.py`` (reference
paddle/fluid/imperative/): ``VarBase`` holds a tensor and its gradient,
``Tracer.trace_op`` runs an op's lowering eagerly and records a tape
entry, and ``Tracer.engine_execute`` walks the tape in reverse, each
entry through the same ``generic_grad`` lowering the static backward
uses (``torch.func.vjp`` over the op's own lowering), summing fan-in.

The tracer lives on one place: ``CUDAPlace(0)`` unless the caller asks
for another; without a card that raises, as ``fluid.Executor`` does.
Every op gets its own 64-bit seed from the tracer (``next_seed``), the
counterpart of the reference's folded PRNG key; a tape entry keeps it,
so the backward's replay of a dropout regenerates the forward's mask.

``functionalize`` (dygraph/functional.py) runs the same layers with the
tape off, for ``torch.func.grad``: ``no_grad_ctx`` stops the tape and
nothing else, because ``torch.func.grad`` honours ``torch.no_grad()``
and would return no gradient under it.

``grad()`` is the partial-grad engine: it replays the tape entries
that feed its outputs as one pure function (``_tape_replay_fn``, each
entry under its own recorded seed) and differentiates that with
``torch.func.vjp``; with ``create_graph`` it records one
``__partial_grad__`` op whose lowering is that vjp, so the tape's own
``generic_grad`` differentiates it again (a gradient penalty's double
backward).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from ..fluid import core
from ..fluid import trace as _trace
from ..fluid.framework import (convert_dtype, torch_dtype, unique_name,
                               _set_dygraph_tracer, _dygraph_tracer,
                               _current_expected_place)
from ..ops.registry import get_op, register_op, LoweringContext, _mix


def _device():
    """The active tracer's device (the host when there is none)."""
    t = _dygraph_tracer()
    return t.device if t is not None else torch.device("cpu")


def _as_tensor(value):
    """A tensor as is; anything else through numpy onto the tracer's
    device."""
    if isinstance(value, torch.Tensor):
        return value
    a = np.ascontiguousarray(np.asarray(value))
    t = torch.from_numpy(a.copy() if not a.flags.writeable else a)
    return t.to(_device())


class VarBase:
    """Eager tensor (imperative/layer.h VarBase)."""

    def __init__(self, value, name=None, stop_gradient=False,
                 persistable=False):
        self._value = _as_tensor(value)
        self.name = name or unique_name("eager_tmp")
        self.stop_gradient = stop_gradient
        self.persistable = persistable
        self._grad: Optional[torch.Tensor] = None

    # --- data access -------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._value.shape)

    @property
    def dtype(self):
        return convert_dtype(self._value.dtype)

    @property
    def ndim(self):
        return self._value.ndim

    def numpy(self):
        """A host copy; bfloat16, which numpy lacks, comes as float32."""
        v = self._value.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()

    def value(self):
        return self._value

    def detach(self):
        return VarBase(self._value.detach(), stop_gradient=True)

    def clone(self):
        """A new VarBase over the same value, off the tape."""
        return VarBase(self._value, stop_gradient=self.stop_gradient)

    def astype(self, dtype):
        return VarBase(self._value.to(torch_dtype(dtype)),
                       stop_gradient=self.stop_gradient)

    def set_value(self, value):
        """Replace the value, keeping this tensor's device and dtype."""
        self._value = _as_tensor(value).to(device=self._value.device,
                                           dtype=self._value.dtype)

    # --- autograd ----------------------------------------------------------
    @property
    def grad(self):
        return None if self._grad is None \
            else self._grad.detach().cpu().numpy()

    @property
    def gradient_var(self):
        return self._grad

    def gradient(self):
        return self.grad

    def clear_gradient(self):
        self._grad = None

    def backward(self, grad_tensor=None, retain_graph=False):
        tracer = _dygraph_tracer()
        if tracer is None:
            raise RuntimeError("backward() outside dygraph guard")
        seed = (grad_tensor._value if isinstance(grad_tensor, VarBase)
                else torch.ones_like(self._value))
        tracer.engine_execute(self, seed, retain_graph=retain_graph)

    # --- operators (the arithmetic the ported models use) ------------------
    def _binary(self, op_type, other, reverse=False):
        if not isinstance(other, VarBase):
            other = VarBase(torch.as_tensor(other, dtype=self._value.dtype,
                                            device=self._value.device),
                            stop_gradient=True)
        x, y = (other, self) if reverse else (self, other)
        return _dygraph_tracer().trace_op(
            op_type, {"X": [x], "Y": [y]}, {"Out": [None]},
            {"axis": -1})["Out"][0]

    def __add__(self, o):
        return self._binary("elementwise_add", o)

    def __radd__(self, o):
        return self._binary("elementwise_add", o, True)

    def __sub__(self, o):
        return self._binary("elementwise_sub", o)

    def __rsub__(self, o):
        return self._binary("elementwise_sub", o, True)

    def __mul__(self, o):
        return self._binary("elementwise_mul", o)

    def __rmul__(self, o):
        return self._binary("elementwise_mul", o, True)

    def __truediv__(self, o):
        return self._binary("elementwise_div", o)

    def __rtruediv__(self, o):
        return self._binary("elementwise_div", o, True)

    def __pow__(self, o):
        return self._binary("elementwise_pow", o)

    def __rpow__(self, o):
        return self._binary("elementwise_pow", o, True)

    def __floordiv__(self, o):
        return self._binary("elementwise_floordiv", o)

    def __rfloordiv__(self, o):
        return self._binary("elementwise_floordiv", o, True)

    def __mod__(self, o):
        return self._binary("elementwise_mod", o)

    def __rmod__(self, o):
        return self._binary("elementwise_mod", o, True)

    def __gt__(self, o):
        return self._binary("greater_than", o)

    def __lt__(self, o):
        return self._binary("less_than", o)

    def __ge__(self, o):
        return self._binary("greater_equal", o)

    def __le__(self, o):
        return self._binary("less_equal", o)

    def __bool__(self):
        """A one-value tensor's truth; anything larger is ambiguous."""
        if self._value.numel() != 1:
            raise ValueError(
                "The truth value of a multi-element VarBase is ambiguous; "
                "use .any()/.all() reductions")
        return bool(self._value.reshape(()))

    def __matmul__(self, o):
        return _dygraph_tracer().trace_op(
            "matmul", {"X": [self], "Y": [o]}, {"Out": [None]}, {})["Out"][0]

    def __neg__(self):
        return _dygraph_tracer().trace_op(
            "scale", {"X": [self]}, {"Out": [None]},
            {"scale": -1.0})["Out"][0]

    def __getitem__(self, idx):
        """A view of the value, off the tape, as the reference's."""
        return VarBase(self._value[idx], stop_gradient=self.stop_gradient)

    def __len__(self):
        return self.shape[0]

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def reshape(self, shape):
        return _dygraph_tracer().trace_op(
            "reshape", {"X": [self]}, {"Out": [None]},
            {"shape": list(shape)})["Out"][0]

    def __float__(self):
        return float(self._value.detach().reshape(()))

    def __repr__(self):
        return (f"VarBase(name={self.name}, shape={self.shape}, "
                f"dtype={self.dtype}, stop_gradient={self.stop_gradient})")


class ParamBase(VarBase):
    def __init__(self, value, name=None, trainable=True, regularizer=None,
                 need_clip=True):
        super().__init__(value, name=name, stop_gradient=not trainable,
                         persistable=True)
        self.trainable = trainable
        self.regularizer = regularizer
        self.need_clip = need_clip


class _TapeEntry:
    __slots__ = ("op_type", "ins", "outs", "attrs", "key")

    def __init__(self, op_type, ins, outs, attrs, key=None):
        self.op_type = op_type
        self.ins = ins          # slot -> [VarBase]
        self.outs = outs        # slot -> [VarBase]
        self.attrs = attrs
        self.key = key          # the forward's base seed: the backward
                                # regenerates the same dropout masks


class Tracer:
    """imperative/tracer.cc: eager dispatch and tape recording on one
    place (``CUDAPlace(0)`` unless the caller, or ``paddle.set_device``,
    names another)."""

    def __init__(self, place: Optional[core.Place] = None):
        self.place = place if place is not None \
            else _current_expected_place()
        self.device = self.place.torch_device()
        if self.device.type == "cuda":
            # full-precision fp32 products on the card, as the Executor
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self._tape: List[_TapeEntry] = []
        self._no_grad = False
        self._train_mode = True
        self._seed = int(np.random.randint(0, 2 ** 31 - 1))
        self._seed_ctr = 0
        self._amp_enabled = False
        self._amp_dtype = "bfloat16"

    # -- RNG ---------------------------------------------------------------
    def next_seed(self) -> int:
        """A fresh 64-bit base seed: the tracer's seed mixed with a
        counter that every traced op and every parameter advances."""
        self._seed_ctr += 1
        return _mix(self._seed, self._seed_ctr)

    def next_key(self) -> int:
        """The reference's next folded PRNG key.  The port has no key:
        this is the next 64-bit op seed, the one ``LoweringContext``
        takes as ``base_seed`` (``next_seed``)."""
        return self.next_seed()

    def _ctx(self, base_seed=None):
        return LoweringContext(
            device=self.device,
            base_seed=self.next_seed() if base_seed is None else base_seed,
            is_test=not self._train_mode)

    # -- op dispatch ---------------------------------------------------------
    def trace_op(self, op_type, inputs, outputs, attrs=None):
        attrs = dict(attrs or {})
        opdef = get_op(op_type)
        ins_vb: Dict[str, List[VarBase]] = {}
        for slot, vals in (inputs or {}).items():
            if vals is None:
                continue
            vals = vals if isinstance(vals, (list, tuple)) else [vals]
            ins_vb[slot] = [v for v in vals if v is not None]
        if self._amp_enabled and op_type != "run_program":
            # a run_program's own ops autocast as they run
            ins_vb = self._autocast(op_type, ins_vb)
        ins_t = {s: [v._value for v in vs] for s, vs in ins_vb.items()}
        if opdef.stateful_rng and "op_seed" not in attrs:
            attrs["op_seed"] = int(np.random.randint(0, 2 ** 31 - 1))
        ctx = self._ctx()
        # an eager op's host span (its kernels may still run on the card
        # when it closes); one boolean while the plane is off
        if _trace.enabled():
            _t0 = _trace.now()
            outs_t = opdef.fn(ins_t, attrs, ctx)
            _trace.complete(op_type, _t0, cat="dygraph_op")
        else:
            outs_t = opdef.fn(ins_t, attrs, ctx)
        requires = (not self._no_grad and opdef.differentiable and any(
            not v.stop_gradient for vs in ins_vb.values() for v in vs))
        outs_vb = {slot: [VarBase(t, stop_gradient=not requires)
                          for t in ts]
                   for slot, ts in outs_t.items()}
        if requires:
            self._tape.append(_TapeEntry(op_type, ins_vb, outs_vb, attrs,
                                         key=ctx.base_seed))
        return outs_vb

    def _autocast(self, op_type, ins_vb):
        """imperative/amp_auto_cast.cc: white ops (matmul, attention) run
        in bf16, black ops (softmax, losses, reductions) in float32, gray
        ops follow their inputs: if any floating input is already bf16 the
        float32 ones are cast down.  A cast input keeps ``_src``, the
        VarBase it came from, so the tape routes its gradient to the
        float32 master."""
        from ..amp.lists import WHITE_OPS, BLACK_OPS
        lo = torch_dtype(self._amp_dtype)
        if op_type in WHITE_OPS:
            target = lo
        elif op_type in BLACK_OPS:
            target = torch.float32
        else:
            if not any(v._value.dtype == lo
                       for vs in ins_vb.values() for v in vs):
                return ins_vb
            target = lo
        src = torch.float32 if target == lo else lo
        out = {}
        for s, vs in ins_vb.items():
            nvs = []
            for v in vs:
                if v._value.dtype == src:
                    nv = VarBase(v._value.to(target),
                                 stop_gradient=v.stop_gradient)
                    nv._src = v
                    nvs.append(nv)
                else:
                    nvs.append(v)
            out[s] = nvs
        return out

    # -- parameters ---------------------------------------------------------
    def create_parameter(self, name, shape, dtype, initializer,
                         trainable=True, regularizer=None, need_clip=True):
        value = materialize_initializer(initializer, shape, dtype,
                                        self.next_seed(), self.device)
        return ParamBase(value, name=name, trainable=trainable,
                         regularizer=regularizer, need_clip=need_clip)

    # -- backward engine (BasicEngine::Execute) ------------------------------
    def engine_execute(self, loss: VarBase, seed_grad, retain_graph=False):
        from ..fluid.backward import _generic_grad
        grads: Dict[int, torch.Tensor] = {id(loss): seed_grad}
        var_by_id: Dict[int, VarBase] = {id(loss): loss}

        for entry in reversed(self._tape):
            if not any(id(v) in grads
                       for vs in entry.outs.values() for v in vs):
                continue
            opdef = get_op(entry.op_type)
            grad_slots = [s for s, vs in entry.ins.items()
                          if s not in opdef.nondiff_inputs
                          and any(not v.stop_gradient for v in vs)]
            if not grad_slots:
                continue
            g_ins = {"I_" + s: [v._value for v in vs]
                     for s, vs in entry.ins.items()}
            for s, vs in entry.outs.items():
                if s in opdef.nondiff_outputs:
                    continue
                gvals = [grads.get(id(v)) for v in vs]
                if any(g is not None for g in gvals):
                    g_ins["G_" + s] = [
                        g if g is not None else torch.zeros_like(v._value)
                        for g, v in zip(gvals, vs)]
            attrs = {"fwd_type": entry.op_type, "fwd_attrs": entry.attrs,
                     "in_slots": list(entry.ins.keys()),
                     "grad_slots": grad_slots}
            # the entry's own forward seed: a dropout's vjp reruns its
            # forward, which must draw the mask the forward applied
            result = _generic_grad(g_ins, attrs, self._ctx(entry.key))
            for s in grad_slots:
                for v, g in zip(entry.ins[s], result.get("GI_" + s, [])):
                    if v.stop_gradient or g is None:
                        continue
                    # an autocast input is a fresh VarBase outside the
                    # tape: follow _src to the producer's output
                    while getattr(v, "_src", None) is not None:
                        v = v._src
                        g = g.to(v._value.dtype)
                    prev = grads.get(id(v))
                    grads[id(v)] = g if prev is None else prev + g
                    var_by_id[id(v)] = v

        # write the sums onto the leaves (GradientAccumulator)
        for vid, g in grads.items():
            v = var_by_id[vid]
            v._grad = g if v._grad is None else v._grad + g
        if not retain_graph:
            self._tape.clear()


def materialize_initializer(init, shape, dtype, seed: int, device):
    """Run an Initializer eagerly on ``device`` (the dygraph counterpart
    of its op in the startup program), drawing from a generator seeded
    with ``seed``."""
    from ..fluid import initializer as I
    dtype = torch_dtype(dtype)
    shape = tuple(int(s) for s in shape)
    if isinstance(init, I.XavierInitializer):
        fi, fo = I._fans(shape)
        fi, fo = init.fan_in or fi, init.fan_out or fo
        if init.uniform:
            lim = float(np.sqrt(6.0 / (fi + fo)))
            init = I.UniformInitializer(-lim, lim)
        else:
            init = I.NormalInitializer(0.0, float(np.sqrt(2.0 / (fi + fo))))
    if isinstance(init, I.MSRAInitializer):
        fi = init.fan_in or I._fans(shape)[0]
        if init.uniform:
            lim = float(np.sqrt(6.0 / fi))
            init = I.UniformInitializer(-lim, lim)
        else:
            init = I.NormalInitializer(0.0, float(np.sqrt(2.0 / fi)))
    if isinstance(init, I.ConstantInitializer):
        return torch.full(shape, init.value, dtype=dtype, device=device)
    if isinstance(init, (I.NumpyArrayInitializer, I.BilinearInitializer)):
        return torch.from_numpy(np.array(init.array(shape), "float64")) \
            .reshape(shape).to(device=device, dtype=dtype)
    if isinstance(init, I.TruncatedNormalInitializer):
        from ..ops.registry import get_op
        out = get_op("truncated_gaussian_random").fn(
            {}, {"shape": list(shape), "mean": init.loc, "std": init.scale,
                 "dtype": convert_dtype(dtype), "op_seed": 1},
            LoweringContext(device=device, base_seed=seed))["Out"][0]
        return out
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if isinstance(init, I.UniformInitializer):
        u = torch.rand(shape, generator=gen, device=device)
        return (u * (init.high - init.low) + init.low).to(dtype)
    if isinstance(init, I.NormalInitializer):
        n = torch.randn(shape, generator=gen, device=device)
        return (n * init.scale + init.loc).to(dtype)
    raise TypeError(f"unsupported initializer {init!r} in dygraph")


# ---------------------------------------------------------------------------
# the partial-grad engine (imperative/partial_grad_engine.cc)
# ---------------------------------------------------------------------------
def _src_root(v):
    """The VarBase an autocast copy came from (itself if none)."""
    while getattr(v, "_src", None) is not None:
        v = v._src
    return v


def _tape_replay_fn(tape, inputs, outputs, train_mode, device,
                    no_grad_ids=()):
    """A pure function ``input values -> output values`` that re-executes
    the tape entries, each under its own recorded seed, so a dropout
    draws the forward's mask again.  A bound input's value wins over its
    producer (a gradient with respect to an intermediate would otherwise
    be zero), and values whose root is in ``no_grad_ids`` are detached:
    the reference's partial-grad engine holds ``no_grad_vars`` constant
    even in mid-graph."""
    bound = {id(v) for v in inputs}
    no_grad_ids = set(no_grad_ids)

    def replay(*input_vals):
        env = {id(v): val for v, val in zip(inputs, input_vals)}

        def look(v):
            u = v
            while u is not None:
                if id(u) in env:
                    val = env[id(u)]
                    return val if val.dtype == v._value.dtype \
                        else val.to(v._value.dtype)
                u = getattr(u, "_src", None)
            return v._value

        for entry in tape:
            ins = {s: [look(v) for v in vs] for s, vs in entry.ins.items()}
            ctx = LoweringContext(device=device, base_seed=entry.key,
                                  is_test=not train_mode)
            outs = get_op(entry.op_type).fn(ins, entry.attrs, ctx)
            for s, vs in entry.outs.items():
                for v, a in zip(vs, outs.get(s, [])):
                    if id(v) in bound:
                        continue
                    if id(v) in no_grad_ids \
                            or id(_src_root(v)) in no_grad_ids:
                        a = a.detach()
                    env[id(v)] = a
        return tuple(look(o) for o in outputs)

    return replay


def _slice_tape(tape, outputs):
    """Only the entries that are ancestors of ``outputs``: ``grad`` does
    not replay the whole tape (a loop calling it each step would do
    quadratic work)."""
    anc = {id(_src_root(o)) for o in outputs} | {id(o) for o in outputs}
    keep = []
    for entry in reversed(tape):
        if any(id(v) in anc or id(_src_root(v)) in anc
               for vs in entry.outs.values() for v in vs):
            keep.append(entry)
            for vs in entry.ins.values():
                for v in vs:
                    anc.add(id(v))
                    anc.add(id(_src_root(v)))
    keep.reverse()
    return keep


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad: d(outputs)/d(inputs), leaving every ``.grad``
    untouched.  The kept tape is replayed as a pure function and
    differentiated with ``torch.func.vjp``.  With ``create_graph`` the
    gradient is itself recorded as one ``__partial_grad__`` op, whose
    inputs are ``inputs`` and every leaf parameter the tape consumed
    (``Params``), so a later backward reaches those too.  As in the
    reference, ``retain_graph`` defaults to ``create_graph`` and frees
    only the replayed entries."""
    tracer = _dygraph_tracer()
    if tracer is None:
        raise RuntimeError("paddle.grad() outside dygraph mode")
    outputs = list(outputs) if isinstance(outputs, (list, tuple)) \
        else [outputs]
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    no_grad_ids = {id(_src_root(v)) for v in (no_grad_vars or [])}
    if any(id(_src_root(v)) in no_grad_ids for v in inputs):
        raise ValueError("a variable cannot be in both inputs and "
                         "no_grad_vars")
    tape = _slice_tape(list(tracer._tape), outputs)

    # an input is used when a kept entry (an ancestor of the outputs)
    # consumed it, or when it is one of their outputs
    consumed = {id(_src_root(u))
                for entry in tape for vs in entry.ins.values() for u in vs}
    produced = {id(w) for entry in tape
                for vs in entry.outs.values() for w in vs}
    used = [id(_src_root(v)) in consumed or id(v) in produced
            for v in inputs]
    if not allow_unused and not all(used):
        bad = [i for i, u in enumerate(used) if not u]
        raise RuntimeError(
            f"inputs at positions {bad} are unreachable from outputs; "
            f"pass allow_unused=True to get None for them")

    if grad_outputs is None:
        seeds = [torch.ones_like(o._value) for o in outputs]
    else:
        gos = list(grad_outputs) if isinstance(grad_outputs,
                                               (list, tuple)) \
            else [grad_outputs]
        if len(gos) != len(outputs):
            raise ValueError(
                f"grad_outputs has {len(gos)} entries but outputs has "
                f"{len(outputs)}; their lengths must match")
        seeds = [torch.ones_like(o._value) if g is None else g._value
                 for o, g in zip(outputs, gos)]

    if create_graph:
        # every differentiable leaf the tape consumed rides through the
        # op as an input, or d(grad)/d(that leaf) would be zero; leaves
        # only (binding an intermediate would cut the chain to inputs),
        # and no_grad_vars stay out: they are constants
        seen = {id(v) for v in inputs}
        params = []
        for entry in tape:
            for vs in entry.ins.values():
                for v in vs:
                    r = _src_root(v)
                    if (not r.stop_gradient and id(r) not in seen
                            and id(r) not in produced
                            and id(r) not in no_grad_ids):
                        seen.add(id(r))
                        params.append(r)
        replay = _tape_replay_fn(tape, inputs + params, outputs,
                                 tracer._train_mode, tracer.device,
                                 no_grad_ids)
        result = list(tracer.trace_op(
            "__partial_grad__", {"X": inputs, "Params": params},
            {"Out": [None] * len(inputs)},
            {"__replay__": replay, "__seeds__": seeds,
             "__n_inputs__": len(inputs)})["Out"])
    else:
        replay = _tape_replay_fn(tape, inputs, outputs, tracer._train_mode,
                                 tracer.device, no_grad_ids)
        _, vjp = torch.func.vjp(replay, *[v._value for v in inputs])
        result = [VarBase(g, stop_gradient=True)
                  for g in vjp(tuple(seeds))]

    if retain_graph is None:
        retain_graph = create_graph
    if not retain_graph:
        # free only what this call replayed: unrelated graphs on the same
        # tape, and the __partial_grad__ entry just recorded, survive
        dead = {id(e) for e in tape}
        tracer._tape = [e for e in tracer._tape if id(e) not in dead]
    return [r if u else None for r, u in zip(result, used)] \
        if allow_unused else result


@register_op("__partial_grad__")
def _partial_grad(ins, attrs, ctx):
    """The vjp of the recorded replay at X and Params: the first
    ``__n_inputs__`` cotangents."""
    n = attrs.get("__n_inputs__", len(ins["X"]))
    bind = list(ins["X"]) + list(ins.get("Params", []))
    _, vjp = torch.func.vjp(attrs["__replay__"], *bind)
    return {"Out": list(vjp(tuple(attrs["__seeds__"])))[:n]}


# ---------------------------------------------------------------------------
@contextlib.contextmanager
def guard(place=None):
    """fluid.dygraph.guard: eager mode on ``place`` (the card unless the
    caller asks for another)."""
    prev = _dygraph_tracer()
    _set_dygraph_tracer(Tracer(place))
    try:
        yield
    finally:
        _set_dygraph_tracer(prev)


def enable_dygraph(place=None):
    _set_dygraph_tracer(Tracer(place))


def disable_dygraph():
    _set_dygraph_tracer(None)


def to_variable(value, name=None, zero_copy=None, place=None):
    """A VarBase on ``place``'s device, the tracer's when None; one
    already is returned as is."""
    if isinstance(value, VarBase):
        return value
    if place is not None:
        value = torch.as_tensor(np.asarray(value) if not isinstance(
            value, torch.Tensor) else value).to(place.torch_device())
    return VarBase(value, name=name, stop_gradient=True)


@contextlib.contextmanager
def no_grad_ctx():
    """Stop recording the tape (and nothing else: torch's grad mode is
    untouched, so ``torch.func.grad`` still differentiates)."""
    t = _dygraph_tracer()
    if t is None:
        yield
        return
    prev = t._no_grad
    t._no_grad = True
    try:
        yield
    finally:
        t._no_grad = prev


def no_grad(fn=None):
    """A context that stops the tape, or, given a function, that
    function run under it."""
    if fn is None:
        return no_grad_ctx()

    def wrapper(*a, **k):
        with no_grad_ctx():
            return fn(*a, **k)
    return wrapper
