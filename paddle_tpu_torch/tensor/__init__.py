"""paddle.tensor, the 2.0 namespace (counterpart of
``paddle_tpu/tensor/__init__.py``): functions over the fluid op builders,
so each works in a program and under a dygraph tracer alike.  The
tensors a function makes from nothing (``to_tensor``, ``full``, the
random functions) lie on the tracer's device, the card unless the
caller asked for the host."""
from ..fluid import layers as _L
from ..fluid.layers import (concat, cast, zeros, ones, zeros_like, ones_like,
                            argmax, argmin, argsort, linspace, increment)
from ..fluid.layers.nn import (matmul, reshape, squeeze, unsqueeze,
                               transpose, flatten, split, slice, gather,
                               gather_nd, scatter, stack, unstack, expand,
                               expand_as, clip, where, topk)
from ..fluid.layers import nn as _nn


def add(x, y): return _L.elementwise_add(x, y)
def subtract(x, y): return _L.elementwise_sub(x, y)
def multiply(x, y): return _L.elementwise_mul(x, y)
def divide(x, y): return _L.elementwise_div(x, y)
def pow(x, y): return _L.elementwise_pow(x, y)
def maximum(x, y): return _L.elementwise_max(x, y)
def minimum(x, y): return _L.elementwise_min(x, y)
def sqrt(x): return _nn.sqrt(x)
def square(x): return _nn.square(x)
def exp(x): return _nn.exp(x)
def log(x): return _nn.log(x)
def abs(x): return _nn.abs(x)
def tanh(x): return _nn.tanh(x)
def mean(x, axis=None, keepdim=False):
    return _nn._reduce_layer("reduce_mean", x, axis, keepdim)
def sum(x, axis=None, keepdim=False):
    return _nn._reduce_layer("reduce_sum", x, axis, keepdim)
def max(x, axis=None, keepdim=False):
    return _nn._reduce_layer("reduce_max", x, axis, keepdim)
def min(x, axis=None, keepdim=False):
    return _nn._reduce_layer("reduce_min", x, axis, keepdim)
def prod(x, axis=None, keepdim=False):
    return _nn._reduce_layer("reduce_prod", x, axis, keepdim)


from ..fluid.layers import fill_constant, assign, one_hot, eye  # noqa: E402
from ..fluid.layers import range as arange  # noqa: E402,F401
from ..fluid.layers.nn import (_single_out, elementwise_op,  # noqa: E402,F401
                               floor, ceil, round, sign, sin, cos, rsqrt,
                               reciprocal, sigmoid, log2, log10, log1p, sinh,
                               cosh, tan, asin, acos, atan, logsumexp, erf)
from ..fluid.layer_helper import LayerHelper as _LH  # noqa: E402
from ..fluid.framework import in_dygraph_mode as _dy  # noqa: E402


def _op(op_type, inputs, attrs=None, outs=("Out",), dtype=None):
    ref = next(v for vs in inputs.values() for v in vs)
    h = _LH(op_type)
    outvars = {o: [h.create_variable_for_type_inference(
        dtype=dtype or getattr(ref, "dtype", "float32"))] for o in outs}
    r = h.append_op(op_type, inputs=inputs, outputs=outvars,
                    attrs=attrs or {})
    got = r if _dy() else outvars
    res = [got[o][0] for o in outs]
    return res[0] if len(res) == 1 else res


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """A VarBase on ``place`` (the tracer's device when None) under a
    tracer; a constant of the main program in static mode."""
    import numpy as np
    arr = np.asarray(data, dtype=dtype)
    if _dy():
        from ..dygraph.base import to_variable
        v = to_variable(arr, place=place)
        v.stop_gradient = stop_gradient
        return v
    return assign(arr)


def full(shape, fill_value, dtype="float32"):
    return fill_constant(shape, dtype, fill_value)


def full_like(x, fill_value, dtype=None):
    return _op("fill_any_like", {"X": [x]},
               {"value": float(fill_value), "dtype": dtype})


def cumsum(x, axis=None, dtype=None):
    return _op("cumsum", {"X": [x]}, {"axis": -1 if axis is None else axis,
                                      "flatten": axis is None})


def cross(x, y, axis=None):
    return _op("cross", {"X": [x], "Y": [y]},
               {"dim": -1 if axis is None else axis})


def dot(x, y): return _op("dot", {"X": [x], "Y": [y]})
def kron(x, y): return _op("kron", {"X": [x], "Y": [y]})
def bmm(x, y): return _op("matmul_v2", {"X": [x], "Y": [y]})
def mv(x, v): return _op("mv", {"X": [x], "Vec": [v]})
def trace(x, offset=0, axis1=0, axis2=1):
    return _op("trace", {"Input": [x]}, {"offset": offset, "axis1": axis1,
                                         "axis2": axis2})
def tril(x, diagonal=0):
    return _op("tril_triu", {"X": [x]}, {"diagonal": diagonal, "lower": True})
def triu(x, diagonal=0):
    return _op("tril_triu", {"X": [x]}, {"diagonal": diagonal,
                                         "lower": False})
def cholesky(x, upper=False):
    return _op("cholesky", {"X": [x]}, {"upper": upper})
def inverse(x): return _op("inverse", {"Input": [x]}, outs=("Output",))
def index_select(x, index, axis=0):
    return _op("index_select", {"X": [x], "Index": [index]}, {"dim": axis})
def index_sample(x, index):
    return _op("index_sample", {"X": [x], "Index": [index]})
def masked_select(x, mask):
    return _op("masked_select", {"X": [x], "Mask": [mask]}, outs=("Y",))
def roll(x, shifts, axis=None):
    sh = shifts if isinstance(shifts, (list, tuple)) else [shifts]
    ax = ([] if axis is None
          else (axis if isinstance(axis, (list, tuple)) else [axis]))
    return _op("roll", {"X": [x]}, {"shifts": list(sh), "axis": list(ax)})
def flip(x, axis):
    ax = axis if isinstance(axis, (list, tuple)) else [axis]
    return _op("flip", {"X": [x]}, {"axis": list(ax)})
def tile(x, repeat_times):
    return _op("tile", {"X": [x]}, {"repeat_times": list(repeat_times)})
def unbind(x, axis=0):
    n = x.shape[axis]
    h = _LH("unbind")
    outs = [h.create_variable_for_type_inference(
        dtype=getattr(x, "dtype", "float32")) for _ in range(n)]
    r = h.append_op("unbind", inputs={"X": [x]}, outputs={"Out": outs},
                    attrs={"axis": axis})
    return r["Out"] if _dy() else outs
def meshgrid(*xs):
    xs = list(xs[0]) if len(xs) == 1 and isinstance(
        xs[0], (list, tuple)) else list(xs)
    h = _LH("meshgrid")
    outs = [h.create_variable_for_type_inference(
        dtype=getattr(xs[0], "dtype", "float32")) for _ in xs]
    r = h.append_op("meshgrid", inputs={"X": xs}, outputs={"Out": outs},
                    attrs={})
    return r["Out"] if _dy() else outs
def logit(x, eps=None): return _op("logit", {"X": [x]}, {"eps": eps or 0.0})
def dist(x, y, p=2):
    return _op("dist", {"X": [x], "Y": [y]}, {"p": float(p)})
def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    return _op("allclose", {"Input": [x], "Other": [y]},
               {"rtol": str(rtol), "atol": str(atol),
                "equal_nan": equal_nan})
def isnan(x): return _op("isnan_v2", {"X": [x]})
def isinf(x): return _op("isinf_v2", {"X": [x]})
def isfinite(x): return _op("isfinite_v2", {"X": [x]})
def norm(x, p=2, axis=None, keepdim=False):
    return _op("p_norm", {"X": [x]},
               {"porder": float(p), "axis": -1 if axis is None else axis,
                "keepdim": keepdim, "asvector": axis is None})
def mod(x, y): return _L.elementwise_mod(x, y)
def floor_divide(x, y): return _L.elementwise_floordiv(x, y)
def remainder(x, y): return _L.elementwise_mod(x, y)
def equal(x, y): return _L.equal(x, y)
def not_equal(x, y): return _op("not_equal", {"X": [x], "Y": [y]})
def greater_than(x, y): return _op("greater_than", {"X": [x], "Y": [y]})
def greater_equal(x, y): return _op("greater_equal", {"X": [x], "Y": [y]})
def less_than(x, y): return _op("less_than", {"X": [x], "Y": [y]})
def less_equal(x, y): return _op("less_equal", {"X": [x], "Y": [y]})
def logical_and(x, y): return _op("logical_and", {"X": [x], "Y": [y]})
def logical_or(x, y): return _op("logical_or", {"X": [x], "Y": [y]})
def logical_not(x): return _op("logical_not", {"X": [x]})
def logical_xor(x, y): return _op("logical_xor", {"X": [x], "Y": [y]})
def all(x, axis=None, keepdim=False):
    return _nn._reduce_layer("reduce_all", x, axis, keepdim)
def any(x, axis=None, keepdim=False):
    return _nn._reduce_layer("reduce_any", x, axis, keepdim)
def numel(x):
    import numpy as np
    return int(np.prod(x.shape))


from ..fluid.layers import (rank, shape, reverse, strided_slice,  # noqa: E402,F401
                            unique, multiplex, scatter_nd, scatter_nd_add,
                            is_empty, shard_index, sum as add_n)
from ..fluid.layers.nn import scale, stanh  # noqa: E402,F401


def mm(input, mat2):
    return matmul(input, mat2)


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1):
    """The matrix-flattening ``mul`` op, not an elementwise product."""
    return _nn.mul(x, y, x_num_col_dims, y_num_col_dims)


def t(input):
    """The transpose of a tensor of rank 2 or less."""
    nd = len(input.shape)
    if nd <= 1:
        return input
    if nd != 2:
        raise ValueError("paddle.t only supports tensors up to rank 2; "
                         "use transpose for higher ranks")
    return transpose(input, [1, 0])


def addmm(input, x, y, beta=1.0, alpha=1.0):
    from ..fluid.layer_helper import emit_op
    return emit_op("addmm", "addmm",
                   {"Input": [input], "X": [x], "Y": [y]}, ("Out",),
                   {"Beta": beta, "Alpha": alpha})["Out"][0]


def chunk(x, chunks, axis=0):
    return split(x, chunks, dim=axis)


def broadcast_to(x, shape):
    from ..fluid.layer_helper import emit_op
    return emit_op("expand_v2", "expand_v2", {"X": [x]}, ("Out",),
                   {"shape": list(shape)})["Out"][0]


def broadcast_shape(x_shape, y_shape):
    import numpy as _np
    return list(_np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def nonzero(x, as_tuple=False):
    from ..fluid.layer_helper import emit_op
    out = emit_op("where_index", "where_index", {"Condition": [x]},
                  ("Out",), {})["Out"][0]
    if not as_tuple:
        return out
    n = len(x.shape)
    return tuple(split(out, n, dim=1)) if n > 1 else (out,)


def median(x, axis=None, keepdim=False):
    """The middle of the sorted values (the mean of the two middle ones
    for an even count)."""
    if axis is None:
        return median(reshape(x, [-1]), axis=0, keepdim=keepdim)
    n = int(x.shape[axis])
    if n < 0:
        raise ValueError("paddle.median needs a static size along axis")
    srt, _ = argsort(x, axis=axis)
    lo, hi = (n - 1) // 2, n // 2
    out = (_slice_axis(srt, axis, lo) + _slice_axis(srt, axis, hi)) / 2.0
    if not keepdim:
        out = squeeze(out, [axis])
    return out


def _slice_axis(x, axis, idx):
    return slice(x, axes=[axis], starts=[idx], ends=[idx + 1])


def std(x, axis=None, unbiased=True, keepdim=False):
    return _nn.sqrt(var(x, axis=axis, unbiased=unbiased, keepdim=keepdim))


def var(x, axis=None, unbiased=True, keepdim=False):
    import builtins
    import numpy as _np
    dims = (list(builtins.range(len(x.shape))) if axis is None
            else ([axis] if isinstance(axis, int) else list(axis)))
    sizes = [x.shape[d] for d in dims]
    if builtins.any(int(v) < 0 for v in sizes):
        raise ValueError(
            "paddle.var/std need static sizes along the reduced dims "
            f"(got {sizes}); reshape with concrete shapes first")
    m = _nn.reduce_mean(x, dim=dims, keep_dim=True)
    s = _nn.reduce_sum(_nn.square(x - m), dim=dims, keep_dim=keepdim)
    n = int(_np.prod(sizes))
    return s / (n - 1 if unbiased and n > 1 else n)


def empty(shape, dtype="float32"):
    return fill_constant(list(shape), dtype, 0.0)


def empty_like(x, dtype=None):
    return zeros_like(x) if dtype is None else cast(zeros_like(x), dtype)


def diag(x, offset=0, padding_value=0):
    from ..fluid.layer_helper import emit_op
    return emit_op("diag_v2", "diag_v2", {"X": [x]}, ("Out",),
                   {"offset": offset,
                    "padding_value": padding_value})["Out"][0]


def _op_seed(seed=None):
    """A program gives each random op its own seed (two ``paddle.rand``
    calls must not share a stream); under a tracer 0 lets ``trace_op``
    draw one."""
    if seed:
        return seed
    if not _dy():
        from ..fluid.framework import default_main_program
        return default_main_program().next_op_seed()
    return 0


def _rand_op(op, shape, dtype, seed=None, **attrs):
    from ..fluid.layer_helper import emit_op
    attrs["op_seed"] = _op_seed(seed)
    attrs["shape"] = list(shape)
    attrs["dtype"] = dtype
    return emit_op(op, op, {}, ("Out",), attrs)["Out"][0]


def rand(shape, dtype="float32"):
    return _rand_op("uniform_random", shape, dtype, min=0.0, max=1.0)


def uniform(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    return _rand_op("uniform_random", shape, dtype, seed=seed,
                    min=min, max=max)


def randn(shape, dtype="float32"):
    return _rand_op("gaussian_random", shape, dtype, mean=0.0, std=1.0)


def standard_normal(shape, dtype="float32"):
    return randn(shape, dtype)


def normal(mean=0.0, std=1.0, shape=None):
    return _rand_op("gaussian_random", shape or [1], "float32",
                    mean=float(mean), std=float(std))


def randint(low=0, high=None, shape=(1,), dtype="int64"):
    if high is None:
        low, high = 0, low
    return _rand_op("randint", shape, dtype, low=low, high=high)


def randperm(n, dtype="int64"):
    from ..fluid.layer_helper import emit_op
    return emit_op("randperm", "randperm", {}, ("Out",),
                   {"n": n, "dtype": dtype,
                    "op_seed": _op_seed()})["Out"][0]


def bernoulli(x):
    from ..fluid.layer_helper import emit_op
    return emit_op("bernoulli", "bernoulli", {"X": [x]}, ("Out",),
                   {"op_seed": _op_seed()})["Out"][0]


def multinomial(x, num_samples=1, replacement=False):
    from ..fluid.layer_helper import emit_op
    return emit_op("multinomial", "multinomial", {"X": [x]}, ("Out",),
                   {"num_samples": num_samples,
                    "replacement": replacement,
                    "op_seed": _op_seed()})["Out"][0]


def histogram(input, bins=100, min=0, max=0):
    from ..fluid.layer_helper import emit_op
    return emit_op("histogram", "histogram", {"X": [input]}, ("Out",),
                   {"bins": bins, "min": min, "max": max})["Out"][0]


def equal_all(x, y):
    from ..fluid.layer_helper import emit_op
    return emit_op("equal_all", "equal_all", {"X": [x], "Y": [y]},
                   ("Out",), {})["Out"][0]


def floor_mod(x, y):
    return _nn.elementwise_mod(x, y)


def sort(x, axis=-1, descending=False):
    return argsort(x, axis=axis, descending=descending)[0]


def is_tensor(x):
    from ..dygraph.base import VarBase
    from ..fluid.framework import Variable
    return isinstance(x, (VarBase, Variable))


_PRINT_OPTIONS = {"precision": 8, "threshold": 1000, "edgeitems": 3,
                  "linewidth": 80}


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     linewidth=None, sci_mode=None):
    """Display options for the numpy views that tensors print as;
    ``sci_mode=False`` suppresses scientific notation."""
    import numpy as _np
    for k, v in (("precision", precision), ("threshold", threshold),
                 ("edgeitems", edgeitems), ("linewidth", linewidth)):
        if v is not None:
            _PRINT_OPTIONS[k] = v
    kw = dict(_PRINT_OPTIONS)
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    _np.set_printoptions(**kw)
