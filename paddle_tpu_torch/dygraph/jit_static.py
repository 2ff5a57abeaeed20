"""StaticFunction: ``@declarative`` / ``@to_static`` (counterpart of
``paddle_tpu/dygraph/jit_static.py``; reference
dygraph_to_static/program_translator.py:729 StaticFunction and
operators/run_program_op.cc).

A call runs the (AST-converted) function through the ``run_program`` op,
so the whole callable is ONE tape entry.  The port has no ``jax.jit``:
the function runs eagerly on the tensors' device, with the tape off
inside, and a tensor ``if``/``while`` reads its predicate on the host
(dygraph_to_static/convert_operators.py).  When a gradient is wanted,
``run_program`` runs the function under ``torch.func.vjp`` and keeps the
closure; its ``custom_grad`` calls that closure, so the backward does not
run the forward again (the functional step's one autograd pass).

The contract is the reference's:

* parameters and buffers are inputs, never constants: a parameter
  updated between calls is read anew;
* updated buffers (BatchNorm's moving statistics) come back as nondiff
  outputs and are written to the layer after each call, as plain tensors
  (a buffer written inside a ``torch.func`` transform would otherwise
  leave a wrapped tensor bound to the live model, dygraph/functional.py);
* the output tree is recorded per input signature;
* a fresh seed from ``Tracer.next_key()`` seeds each call, so dropout
  varies per call, and the dropout kernels' backward regenerates the
  forward's masks from the same op seeds;
* caches live on the instance (they die with it), keyed by the
  function, the train mode, the parameter names, the buffer count and
  the static-argument spec.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .base import VarBase, to_variable

_MASK64 = (1 << 64) - 1


def _float(t):
    return torch.is_tensor(t) and t.is_floating_point()


def _run_program_grad(ins, outs, out_grads, attrs, ctx):
    """The cotangents of the differentiated inputs from the forward's
    ``torch.func.vjp`` closure (kept in the entry's attrs); the
    function is not run again."""
    saved = attrs["__vjp__"]
    gs = out_grads.get("Out", [])
    cot = []
    for i, o in zip(saved["float_outs"], saved["primals"]):
        g = gs[i] if i < len(gs) else None
        cot.append(torch.zeros_like(o) if g is None else g.to(o.dtype))
    grads = saved["fn"](tuple(cot))
    result = {s: [None] * len(ins.get(s, [])) for s in ("Params", "X")}
    for (s, i), g in zip(saved["diff_at"], grads):
        result[s][i] = g
    return result


def _register_run_program():
    from ..ops.registry import register_op, has_op

    if has_op("run_program"):
        return

    @register_op("run_program", nondiff_inputs=("Key", "Buffers"),
                 nondiff_outputs=("BufOut",), custom_grad=_run_program_grad,
                 grad_lists=True)
    def _run_program(ins, attrs, ctx):
        """Run the StaticFunction's function once.  With
        ``__need_grad__`` it runs under ``torch.func.vjp`` over the
        floating Params and X, and the closure stays in ``attrs`` for
        the backward."""
        fn = attrs["__callable__"]
        params = list(ins.get("Params", []))
        bufs = list(ins.get("Buffers", []))
        xs = list(ins.get("X", []))
        key = (int(ins["Key"][0]) & _MASK64) if ins.get("Key") \
            else ctx.base_seed
        if not attrs.get("__need_grad__", False):
            outs, new_bufs = fn(params, bufs, xs, key)
            return {"Out": list(outs), "BufOut": list(new_bufs)}

        diff_at = [("Params", i) for i, p in enumerate(params) if _float(p)]
        diff_at += [("X", i) for i, x in enumerate(xs) if _float(x)]

        float_outs = []

        def pure(*diff):
            ps, xv = list(params), list(xs)
            for (s, i), d in zip(diff_at, diff):
                (ps if s == "Params" else xv)[i] = d
            outs, new_bufs = fn(ps, bufs, xv, key)
            # the floating outputs are differentiated; the rest (ids,
            # masks) and the new buffers ride as aux, unwrapped
            float_outs[:] = [i for i, o in enumerate(outs) if _float(o)]
            return (tuple(outs[i] for i in float_outs),
                    (tuple(o for o in outs if not _float(o)),
                     tuple(new_bufs)))

        primals, vjp_fn, (rest, new_bufs) = torch.func.vjp(
            pure, *[(params if s == "Params" else xs)[i]
                    for s, i in diff_at], has_aux=True)
        n_outs = len(primals) + len(rest)
        floats, others = iter(primals), iter(rest)
        outs = [next(floats) if i in float_outs else next(others)
                for i in range(n_outs)]
        attrs["__vjp__"] = {"fn": vjp_fn, "diff_at": diff_at,
                            "float_outs": float_outs, "primals": primals}
        return {"Out": outs, "BufOut": list(new_bufs)}


_register_run_program()


def _shape_sig(arrays):
    return tuple((tuple(a.shape), str(a.dtype)) for a in arrays)


def _flatten(out):
    """(leaves, spec) of a nest of lists, tuples and dicts whose leaves
    are VarBases, tensors or numbers; None stays in the spec."""
    leaves = []

    def scan(x):
        if x is None:
            return ("N",)
        if isinstance(x, (list, tuple)):
            return ("L", type(x).__name__, tuple(scan(v) for v in x))
        if isinstance(x, dict):
            return ("D", tuple((k, scan(x[k])) for k in sorted(x)))
        leaves.append(x)
        return ("T", len(leaves) - 1)

    return leaves, scan(out)


def _unflatten(spec, vals):
    t = spec[0]
    if t == "N":
        return None
    if t == "T":
        return vals[spec[1]]
    if t == "L":
        seq = [_unflatten(s, vals) for s in spec[2]]
        return tuple(seq) if spec[1] == "tuple" else seq
    return {k: _unflatten(s, vals) for k, s in spec[1]}


def _leaf_tensor(v, device):
    if isinstance(v, VarBase):
        return v._value
    if torch.is_tensor(v):
        return v
    return torch.as_tensor(np.asarray(v)).to(device)


class StaticFunction:
    """One build per (instance params, train mode, static args); a new
    input signature records its output tree."""

    def __init__(self, fn):
        functools.update_wrapper(self, fn)
        self._fn = fn
        self._converted = None         # lazily AST-converted body
        self._own_cache = {}           # for free functions (no instance)
        self.__declarative__ = True

    def _traced_fn(self):
        """The function ``run_program`` runs: the AST-converted body
        (tensor-dependent if/while/for range become convert_* calls that
        read the predicate on the host, dygraph_to_static/) when
        conversion applies, the original otherwise (ProgramTranslator's
        fallback)."""
        if self._converted is None:
            from .dygraph_to_static import ast_to_static
            self._converted = ast_to_static(self._fn) or self._fn
        return self._converted

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return functools.partial(self.__call__, obj)

    # -- arg splitting ------------------------------------------------------
    @staticmethod
    def _is_tensor(x):
        return isinstance(x, (VarBase, np.ndarray, torch.Tensor))

    def _split(self, args, kwargs, flat):
        """Replace tensors with indices into ``flat`` (recursing through
        lists/tuples/dicts); keep true statics inline."""
        def scan(x):
            if isinstance(x, VarBase):
                flat.append(x)
                return ("T", len(flat) - 1)
            if self._is_tensor(x):
                flat.append(to_variable(x if torch.is_tensor(x)
                                        else np.asarray(x)))
                return ("T", len(flat) - 1)
            if isinstance(x, (list, tuple)):
                return ("L", type(x).__name__, tuple(scan(v) for v in x))
            if isinstance(x, dict):
                return ("D", tuple((k, scan(x[k])) for k in sorted(x)))
            return ("S", x)
        a_spec = tuple(scan(a) for a in args)
        k_spec = tuple((k, scan(kwargs[k])) for k in sorted(kwargs))
        return a_spec, k_spec

    @staticmethod
    def _rebuild(spec, vals):
        t = spec[0]
        if t == "T":
            return vals[spec[1]]
        if t == "L":
            seq = [StaticFunction._rebuild(s, vals) for s in spec[2]]
            return tuple(seq) if spec[1] == "tuple" else seq
        if t == "D":
            return {k: StaticFunction._rebuild(s, vals) for k, s in spec[1]}
        return spec[1]

    # -- call ---------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        from .base import _dygraph_tracer
        from .layers import Layer

        tracer = _dygraph_tracer()
        if tracer is None:
            return self._fn(*args, **kwargs)

        instance = None
        if args and isinstance(args[0], Layer):
            instance, args = args[0], args[1:]

        flat = []
        a_spec, k_spec = self._split(args, kwargs, flat)
        params = list(instance.parameters()) if instance is not None else []
        buffers = [b for b in instance.buffers() if b is not None] \
            if instance is not None else []
        pnames = tuple(getattr(p, "name", str(i))
                       for i, p in enumerate(params))

        if instance is not None:
            store = instance.__dict__.setdefault("_declarative_caches", {})
        else:
            store = self._own_cache
        cache_key = (self._fn.__qualname__, tracer._train_mode, pnames,
                     len(buffers), repr((a_spec, k_spec)))
        entry = store.get(cache_key)
        if entry is None:
            entry = self._build(instance, params, buffers, a_spec, k_spec)
            store[cache_key] = entry

        # the key rides as a host int64 (two's complement): reading it
        # back never waits on the card
        key = tracer.next_key()
        key_vb = VarBase(torch.tensor(key - (1 << 64) if key >> 63 else key,
                                      dtype=torch.int64),
                         stop_gradient=True)
        ins = {"X": flat, "Key": [key_vb]}
        if params:
            ins["Params"] = params
        if buffers:
            ins["Buffers"] = buffers
        need_grad = not tracer._no_grad and any(
            not v.stop_gradient for v in flat + params)
        out_slots = tracer.trace_op(
            "run_program", ins, {"Out": [None], "BufOut": [None]},
            {"__callable__": entry["run"], "__need_grad__": need_grad})
        # write updated buffers (BatchNorm stats etc.) back to the layer
        for b, nb in zip(buffers, out_slots.get("BufOut", [])):
            b._value = nb._value
        return _unflatten(entry["cell"]["last_tree"], out_slots["Out"])

    def _build(self, instance, params, buffers, a_spec, k_spec):
        from .base import no_grad_ctx, _dygraph_tracer

        fn = self._traced_fn()
        cell = {"trees": {}, "traces": 0, "last_tree": None}

        def run(param_vals, buf_vals, input_vals, key):
            """The function over bound values, the tape off, every op's
            seed mixed from ``key``; returns (output leaves, the buffers'
            new values).  The layer's own values are put back after."""
            from .dygraph_to_static import convert_operators as co
            tracer = _dygraph_tracer()
            saved_p = [p._value for p in params]
            saved_b = [b._value for b in buffers]
            saved_seed = (tracer._seed, tracer._seed_ctr)
            saved_active = list(co._ACTIVE_BUFFERS)
            co._ACTIVE_BUFFERS[:] = buffers
            try:
                for p, v in zip(params, param_vals):
                    p._value = v
                for b, v in zip(buffers, buf_vals):
                    b._value = v
                tracer._seed, tracer._seed_ctr = key, 0
                vals = [to_variable(v) for v in input_vals]
                call_args = [self._rebuild(s, vals) for s in a_spec]
                call_kwargs = {k: self._rebuild(s, vals) for k, s in k_spec}
                with no_grad_ctx():   # inner tape entries are subsumed by
                    # the run_program entry's whole-function vjp
                    if instance is not None:
                        out = fn(instance, *call_args, **call_kwargs)
                    else:
                        out = fn(*call_args, **call_kwargs)
                new_bufs = [b._value for b in buffers]
                leaves, tree = _flatten(out)
                sig = _shape_sig(input_vals)
                if sig not in cell["trees"]:
                    cell["trees"][sig] = tree
                    cell["traces"] += 1
                cell["last_tree"] = tree
                return ([_leaf_tensor(v, tracer.device) for v in leaves],
                        new_bufs)
            finally:
                for p, v in zip(params, saved_p):
                    p._value = v
                for b, v in zip(buffers, saved_b):
                    b._value = v
                tracer._seed, tracer._seed_ctr = saved_seed
                co._ACTIVE_BUFFERS[:] = saved_active

        return {"run": run, "cell": cell}


def declarative(function=None):
    """Run a dygraph function or method as one ``run_program`` op: one
    tape entry, its backward the forward's own vjp (reference
    ``@declarative`` / ``@to_static``)."""
    def deco(fn):
        return StaticFunction(fn)
    if function is not None:
        return deco(function)
    return deco


to_static = declarative
