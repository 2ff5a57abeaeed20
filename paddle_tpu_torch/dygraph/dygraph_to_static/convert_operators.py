"""Runtime dispatchers for converted control flow (counterpart of
``paddle_tpu/dygraph/dygraph_to_static/convert_operators.py``; reference
dygraph_to_static/convert_operators.py convert_ifelse,
convert_while_loop).

Every rewritten site calls these.  A Python predicate keeps Python's
semantics untouched.  A TENSOR predicate is where the port differs: the
reference lowers it to ``lax.cond`` / ``lax.while_loop`` inside its jit
trace; the port runs eagerly, so it reads the predicate on the host and
runs the branch, or the trip, it names.  Each such read adds one to the
``dy2static.host_reads`` counter (beside the executor's
``control_flow.host_reads``).

The reference's diagnostics are kept, so the same programs succeed and
fail:

* a name a tensor-dependent region leaves unbound raises ``ValueError``;
  one read before its first write inside a traced body raises
  ``UnboundLocalError`` (``_UnboundGuard``);
* a tensor ``if`` whose branches bind a name to different shapes or
  dtypes raises ``TypeError``.  ``lax.cond`` traces both branches; the
  port runs the branch not taken once per site and input signature, its
  results thrown away and the tracer's seed counter and the running
  function's buffers put back, and compares;
* a tensor ``while`` whose body changes a carried shape or dtype raises
  ``TypeError``, checked after every trip;
* names unbound before a tensor loop stay unbound after it (the
  reference's divergence from Python, ``convert_while_loop``).

Outputs of a tensor region are VarBases, Python numbers promoted to
tensors on the tracer's device (float32, int64, bool), as ``lax``
promotes them to arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from ...fluid import trace


class _Undefined:
    """Placeholder for names not yet bound when a converted region starts
    (the reference's __undefined_var).  Escaping through a TENSOR branch is
    an error; through a Python branch it just stays unbound."""
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "<undefined>"


UNDEFINED = _Undefined()


class _UnboundGuard:
    """Stands in for a name that was unbound when a tensor region started:
    any USE inside the region raises a clear UnboundLocalError instead of
    an obscure TypeError on the raw UNDEFINED sentinel (a body that only
    WRITES the name never touches the guard)."""

    def __init__(self, name, where):
        object.__setattr__(
            self, "_msg",
            f"dygraph-to-static: variable '{name}' may be unbound when the "
            f"converted {where} body runs (it was not assigned before the "
            f"{where}); bind it before the {where} or make the first use "
            f"inside the body a write")

    def _raise(self, *a, **k):
        raise UnboundLocalError(object.__getattribute__(self, "_msg"))

    __getattr__ = _raise

    def __repr__(self):
        return "<unbound-in-traced-region>"


for _d in ("add radd sub rsub mul rmul truediv rtruediv floordiv rfloordiv "
           "mod rmod pow rpow matmul rmatmul neg pos abs invert lt le gt ge "
           "eq ne bool len getitem setitem delitem call iter contains "
           "and rand or ror xor rxor lshift rlshift rshift rrshift "
           "int float index").split():
    setattr(_UnboundGuard, f"__{_d}__", _UnboundGuard._raise)


def _guarded(args, names, where):
    """args with UNDEFINED entries replaced by per-name use guards."""
    return [a if a is not UNDEFINED else _UnboundGuard(n, where)
            for n, a in zip(names, args)]


def defined(thunk):
    """True when ``thunk()`` (a lambda closing over a local) is bound."""
    try:
        thunk()
        return True
    except (NameError, UnboundLocalError):
        return False


def undefined():
    return UNDEFINED


def _is_tensor(v):
    from ..base import VarBase
    return isinstance(v, (VarBase, torch.Tensor))


def _raw(v):
    from ..base import VarBase
    return v._value if isinstance(v, VarBase) else v


def host_read(pred) -> bool:
    """A tensor predicate's truth, read on the host: one count of
    ``dy2static.host_reads``.  Only a one-value tensor has one, as only a
    scalar predicate passes ``lax.cond``."""
    p = _raw(pred)
    if p.numel() != 1:
        raise TypeError(
            f"dygraph-to-static: a tensor predicate must hold one value, "
            f"got shape {tuple(p.shape)}")
    trace.metrics().counter("dy2static.host_reads").inc()
    return bool(p.reshape(()))


def _truth(p) -> bool:
    return host_read(p) if _is_tensor(p) else bool(np.asarray(p))


def _promote(name, v, where):
    """A carried value of a tensor region as a tensor: tensors pass
    through, Python numerics become tensors on the tracer's device,
    anything else cannot cross the region's boundary."""
    from ..base import _device
    if v is UNDEFINED or isinstance(v, _UnboundGuard):
        # a guard escaping untouched means the branch/body never assigned
        # the name — surface the unbound diagnostic, not a type mismatch
        raise ValueError(
            f"dygraph-to-static: variable '{name}' may be undefined after "
            f"the tensor-dependent {where}; bind it before the {where}")
    if _is_tensor(v):
        return _raw(v)
    if isinstance(v, (bool, np.bool_)):
        return torch.tensor(bool(v), device=_device())
    if isinstance(v, (int, np.integer)):
        return torch.tensor(int(v), dtype=torch.int64, device=_device())
    if isinstance(v, (float, np.floating)):
        return torch.tensor(float(v), dtype=torch.float32, device=_device())
    if isinstance(v, np.ndarray):
        return torch.from_numpy(v).to(_device())
    raise TypeError(
        f"dygraph-to-static: variable '{name}' ({type(v).__name__}) is "
        f"assigned inside a tensor-dependent {where}; only tensors and "
        f"numeric scalars can flow through device control flow")


def _rewrap(template, value):
    from ..base import VarBase
    return VarBase(value,
                   stop_gradient=template.stop_gradient
                   if isinstance(template, VarBase) else True)


def _avals(vals):
    return [(tuple(v.shape), v.dtype) for v in vals]


# the branch not taken is run once per (site, input signature); a site is
# its true branch's code object, held here so its id stays its own (equal
# code in two functions compares equal)
_PROBED = {}
# the buffers of the function ``run_program`` is running (a probe puts
# them back)
_ACTIVE_BUFFERS = []


def _probe(fn, args, names):
    """The untaken branch's promoted outputs, with no lasting effect:
    the tracer's seeds and the running function's buffers are put
    back."""
    from ..base import _dygraph_tracer
    tracer = _dygraph_tracer()
    seed = (tracer._seed, tracer._seed_ctr) if tracer is not None else None
    bufs = [(b, b._value) for b in _ACTIVE_BUFFERS]
    try:
        with torch.no_grad():
            outs = fn(*args)
            return [_promote(n, o, "branch") for n, o in zip(names, outs)]
    finally:
        if tracer is not None:
            tracer._seed, tracer._seed_ctr = seed
        for b, v in bufs:
            b._value = v


def convert_ifelse(pred, true_fn, false_fn, names, args):
    """Rewritten ``if``: Python predicate -> Python branch; tensor
    predicate -> read on the host, that branch run eagerly (inputs ride
    the closure, outputs are the branch-assigned variables)."""
    p = _raw(pred)
    if not _is_tensor(p):
        return true_fn(*args) if bool(np.asarray(p)) else false_fn(*args)
    take = host_read(p)
    gargs = _guarded(args, names, "branch")
    taken, other = (true_fn, false_fn) if take else (false_fn, true_fn)
    res = [_promote(n, o, "branch")
           for n, o in zip(names, taken(*gargs))]
    site = (id(true_fn.__code__), tuple(
        (tuple(_raw(a).shape), _raw(a).dtype) if _is_tensor(a) else type(a)
        for a in args))
    if site not in _PROBED:
        other_res = _probe(other, gargs, names)
        if _avals(res) != _avals(other_res):
            raise TypeError(
                f"dygraph-to-static: the two branches of a tensor-dependent "
                f"`if` must produce matching shapes/dtypes for "
                f"{list(names)}: {_avals(res)} against "
                f"{_avals(other_res)}")
        _PROBED[site] = true_fn.__code__
    return tuple(_rewrap(a, r) for a, r in zip(args, res))


def range_cond(i, stop, step):
    """Bound check for the for->while desugar, sign-aware in both the
    Python and the tensor case."""
    from ..base import VarBase
    ri, rstop, rstep = _raw(i), _raw(stop), _raw(step)
    if not (_is_tensor(ri) or _is_tensor(rstop) or _is_tensor(rstep)):
        s = float(np.asarray(rstep))
        return (np.asarray(ri) < np.asarray(rstop) if s > 0
                else np.asarray(ri) > np.asarray(rstop))
    device = next(t.device for t in (ri, rstop, rstep) if _is_tensor(t))
    ri, rstop, rstep = (torch.as_tensor(t, device=device)
                        for t in (ri, rstop, rstep))
    out = torch.where(rstep > 0, ri < rstop, ri > rstop)
    return VarBase(out, stop_gradient=True)


def convert_while_loop(cond_fn, body_fn, names, args):
    """Rewritten ``while``: Python condition -> Python loop; tensor
    condition -> an eager loop over the live variables, the condition
    read on the host before each trip (trips + 1 reads).

    Known divergence from eager Python, kept from the reference: names
    unbound BEFORE the loop are body-local temps — they cannot escape a
    tensor loop, so after a ``for i in range(t)`` with a tensor bound the
    loop variable stays unbound post-loop, where eager Python would leave
    the last value bound.  Reads of such a name before its first in-body
    write raise UnboundLocalError via _UnboundGuard."""
    first = _raw(cond_fn(*args))
    if not _is_tensor(first):
        cur = first
        while _truth(cur):
            args = body_fn(*args)
            cur = _raw(cond_fn(*args))
        return args

    # live/dead split: names UNBOUND before the loop are body-local temps
    # (first use is a write, or Python itself would have raised); the
    # carry holds only the live variables
    live = [i for i, a in enumerate(args) if a is not UNDEFINED]
    carry = [_promote(names[i], args[i], "while loop") for i in live]
    shapes = _avals(carry)
    guarded = _guarded(args, names, "while loop")

    def merge(c):
        vals = list(guarded)
        for k, i in enumerate(live):
            vals[i] = _rewrap(args[i], c[k])
        return vals

    go = host_read(first)
    while go:
        outs = body_fn(*merge(carry))
        carry = [_promote(names[i], outs[i], "while loop body")
                 for i in live]
        if _avals(carry) != shapes:
            raise TypeError(
                f"dygraph-to-static: tensor-dependent `while` must keep "
                f"{list(names)} at fixed shapes/dtypes across iterations: "
                f"{shapes} became {_avals(carry)}")
        go = host_read(cond_fn(*merge(carry)))
    final = list(args)
    for k, i in enumerate(live):
        final[i] = _rewrap(args[i], carry[k])
    return tuple(final)


# ---------------------------------------------------------------------------
# reference convert_operators.py surface: the runtime helpers the rewritten
# AST calls.  Tensor-aware where it matters; python passthrough otherwise.
# ---------------------------------------------------------------------------

def cast_bool_if_necessary(var):
    if _is_tensor(var) and _raw(var).dtype != torch.bool:
        from ...fluid import layers as L
        from ..base import to_variable
        return L.cast(to_variable(var), "bool")
    return var


def convert_logical_and(x_func, y_func):
    x = x_func() if callable(x_func) else x_func
    if _is_tensor(x):
        from ...fluid import layers as L
        y = y_func() if callable(y_func) else y_func
        return L.logical_and(cast_bool_if_necessary(x),
                             cast_bool_if_necessary(y))
    return x and (y_func() if callable(y_func) else y_func)


def convert_logical_or(x_func, y_func):
    x = x_func() if callable(x_func) else x_func
    if _is_tensor(x):
        from ...fluid import layers as L
        y = y_func() if callable(y_func) else y_func
        return L.logical_or(cast_bool_if_necessary(x),
                            cast_bool_if_necessary(y))
    return x or (y_func() if callable(y_func) else y_func)


def convert_logical_not(x):
    if _is_tensor(x):
        from ...fluid import layers as L
        return L.logical_not(cast_bool_if_necessary(x))
    return not x


def convert_len(var):
    if _is_tensor(var):
        return int(_raw(var).shape[0])
    return len(var)


def convert_assert(cond, message=""):
    if _is_tensor(cond):
        from ...fluid import layers as L
        return L.Assert(cond) if hasattr(L, "Assert") else None
    assert cond, message


def convert_print(*args):
    out = []
    for a in args:
        if _is_tensor(a):
            from ...fluid import layers as L
            a = L.Print(a) if hasattr(L, "Print") else a
        out.append(a)
    print(*out)


def convert_pop(target, *args):
    if _is_tensor(target):
        raise TypeError("cannot pop() from a tensor; convert the list "
                        "before the call")
    return target.pop(*args)


def convert_var_dtype(var, dtype):
    if _is_tensor(var):
        from ...fluid import layers as L
        return L.cast(var, dtype)
    return {"bool": bool, "int": int, "float": float}[dtype](var)


def convert_var_shape(x, idx=None):
    shape = getattr(x, "shape", None)
    if shape is None:
        raise AttributeError("object has no shape")
    return shape if idx is None else shape[idx]


def convert_shape_compare(left, *args):
    """chained comparison: left op1 v1 op2 v2 ... — tensor-aware: tensor
    operands combine with logical_and instead of python bool()."""
    import operator as op
    ops = {"<": op.lt, "<=": op.le, ">": op.gt, ">=": op.ge,
           "==": op.eq, "!=": op.ne}
    cur = left
    result = None
    for i in range(0, len(args), 2):
        o, nxt = args[i], args[i + 1]
        piece = ops[o](cur, nxt)
        if _is_tensor(piece) or _is_tensor(result):
            from ...fluid import layers as L
            piece = cast_bool_if_necessary(piece)
            result = piece if result is None else \
                L.logical_and(cast_bool_if_necessary(result), piece)
        else:
            piece = bool(piece)
            result = piece if result is None else (result and piece)
            if not result:
                return False
        cur = nxt
    return True if result is None else result
