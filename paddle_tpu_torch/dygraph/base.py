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

Not ported yet: ``grad()`` (the partial-grad engine) and its tape
replay, ``__partial_grad__``, ``VarBase``'s operators past ``+``,
``-`` and ``*``, and the initializers this port lacks.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from ..fluid import core
from ..fluid.framework import (convert_dtype, torch_dtype, unique_name,
                               _set_dygraph_tracer, _dygraph_tracer)
from ..ops.registry import get_op, LoweringContext, _mix


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
    place (``CUDAPlace(0)`` unless the caller asks for another)."""

    def __init__(self, place: Optional[core.Place] = None):
        self.place = place if place is not None else core.CUDAPlace(0)
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
        if self._amp_enabled:
            ins_vb = self._autocast(op_type, ins_vb)
        ins_t = {s: [v._value for v in vs] for s, vs in ins_vb.items()}
        if opdef.stateful_rng and "op_seed" not in attrs:
            attrs["op_seed"] = int(np.random.randint(0, 2 ** 31 - 1))
        ctx = self._ctx()
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
    if isinstance(init, I.ConstantInitializer):
        return torch.full(shape, init.value, dtype=dtype, device=device)
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


def to_variable(value, name=None, zero_copy=None):
    """A VarBase on the tracer's device; one already is returned as is."""
    if isinstance(value, VarBase):
        return value
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
    if fn is None:
        return no_grad_ctx()

    def wrapper(*a, **k):
        with no_grad_ctx():
            return fn(*a, **k)
    return wrapper
