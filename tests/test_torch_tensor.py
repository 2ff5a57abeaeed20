"""paddle.tensor in both packages: every function of
``paddle_tpu_torch.tensor`` against ``paddle_tpu.tensor`` on the same
seeded numpy inputs, under a dygraph tracer and in a static program,
float32 at rtol 1e-5 (integer and boolean outputs by value: the port's
ids are int64 where the reference's are int32).  One parametrised test
a family; a family's static cases share one program a package, built
and run once.  The random functions are held to a contract (range,
shape, dtype, frequencies), not to the reference's bits.  Mirrors
``tests/test_tensor_parity.py`` and ``tests/test_namespace20.py:18-85``.
"""
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu.tensor as JT
from paddle_tpu.dygraph import base as jdy

import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.tensor as TT
from paddle_tpu_torch.dygraph import base as tdy
from paddle_tpu_torch.ops import has_op

_R = np.random.RandomState(0)
A = {
    "x": _R.randn(3, 4).astype("float32"),
    "y": _R.randn(3, 4).astype("float32"),
    "pos": (_R.rand(3, 4) + 0.5).astype("float32"),
    "unit": _R.uniform(-0.9, 0.9, (3, 4)).astype("float32"),
    "prob": _R.uniform(0.05, 0.95, (3, 4)).astype("float32"),
    "m": _R.randn(4, 5).astype("float32"),
    "x35": _R.randn(3, 5).astype("float32"),
    "v4": _R.randn(4).astype("float32"),
    "w4": _R.randn(4).astype("float32"),
    "sq": _R.randn(3, 3).astype("float32"),
    "spd": None,
    "b3": _R.randn(2, 3, 4).astype("float32"),
    "c3": _R.randn(2, 4, 5).astype("float32"),
    "v3a": _R.randn(2, 3).astype("float32"),
    "v3b": _R.randn(2, 3).astype("float32"),
    "ids": np.array([2, 0, 1], "int64"),
    "ids2": np.array([[1, 3], [0, 2], [3, 3]], "int64"),
    "col": np.array([[1], [0], [3]], "int64"),
    "sel": np.array([[1], [0], [1]], "int64"),
    "ind2": np.array([[0, 1], [2, 3], [1, 0]], "int64"),
    "mask": (_R.rand(3, 4) > 0.5),
    "bx": (_R.rand(3, 4) > 0.5),
    "by": (_R.rand(3, 4) > 0.5),
    "small": np.array([3.0, 1.0, 2.0, 1.0, 3.0], "float32"),
    "naninf": np.array([1.0, np.nan, np.inf, -np.inf], "float32"),
    "upd": _R.randn(3, 4).astype("float32"),
    "u3": _R.randn(3).astype("float32"),
    "u323": _R.randn(3, 2, 3).astype("float32"),
    "ints": np.array([[7, 3, 12], [5, 0, 9]], "int64"),
    "zero1": np.zeros((0, 3), "float32"),
}
A["spd"] = (A["sq"] @ A["sq"].T + 3 * np.eye(3)).astype("float32")

# name -> (fn(T, *vars), input keys, static too?)
# ``T`` is the package's tensor module; static False where the
# reference's lowering needs concrete values (a dynamic output shape or a
# host scalar), which its static programs cannot give
FAMILIES = {
    "elementwise": {
        "add": (lambda T, x, y: T.add(x, y), ["x", "y"], True),
        "subtract": (lambda T, x, y: T.subtract(x, y), ["x", "y"], True),
        "multiply": (lambda T, x, y: T.multiply(x, y), ["x", "y"], True),
        "divide": (lambda T, x, y: T.divide(x, y), ["x", "pos"], True),
        "pow": (lambda T, x, y: T.pow(x, y), ["pos", "y"], True),
        "maximum": (lambda T, x, y: T.maximum(x, y), ["x", "y"], True),
        "minimum": (lambda T, x, y: T.minimum(x, y), ["x", "y"], True),
        "mod": (lambda T, x, y: T.mod(x, y), ["x", "pos"], True),
        "remainder": (lambda T, x, y: T.remainder(x, y), ["x", "pos"],
                      True),
        "floor_mod": (lambda T, x, y: T.floor_mod(x, y), ["x", "pos"], True),
        "floor_divide": (lambda T, x, y: T.floor_divide(x, y),
                         ["x", "pos"], True),
        "elementwise_op": (lambda T, x, y: T.elementwise_op(
            "elementwise_add", x, y), ["x", "y"], True),
        "scale": (lambda T, x: T.scale(x, 2.0, 1.0), ["x"], True),
        "stanh": (lambda T, x: T.stanh(x), ["x"], True),
        "sqrt": (lambda T, x: T.sqrt(x), ["pos"], True),
        "square": (lambda T, x: T.square(x), ["x"], True),
        "exp": (lambda T, x: T.exp(x), ["x"], True),
        "log": (lambda T, x: T.log(x), ["pos"], True),
        "abs": (lambda T, x: T.abs(x), ["x"], True),
        "tanh": (lambda T, x: T.tanh(x), ["x"], True),
        "floor": (lambda T, x: T.floor(x), ["x"], True),
        "ceil": (lambda T, x: T.ceil(x), ["x"], True),
        "round": (lambda T, x: T.round(x), ["x"], True),
        "sign": (lambda T, x: T.sign(x), ["x"], True),
        "sin": (lambda T, x: T.sin(x), ["x"], True),
        "cos": (lambda T, x: T.cos(x), ["x"], True),
        "tan": (lambda T, x: T.tan(x), ["unit"], True),
        "asin": (lambda T, x: T.asin(x), ["unit"], True),
        "acos": (lambda T, x: T.acos(x), ["unit"], True),
        "atan": (lambda T, x: T.atan(x), ["x"], True),
        "sinh": (lambda T, x: T.sinh(x), ["x"], True),
        "cosh": (lambda T, x: T.cosh(x), ["x"], True),
        "rsqrt": (lambda T, x: T.rsqrt(x), ["pos"], True),
        "reciprocal": (lambda T, x: T.reciprocal(x), ["pos"], True),
        "sigmoid": (lambda T, x: T.sigmoid(x), ["x"], True),
        "log2": (lambda T, x: T.log2(x), ["pos"], True),
        "log10": (lambda T, x: T.log10(x), ["pos"], True),
        "log1p": (lambda T, x: T.log1p(x), ["pos"], True),
        "erf": (lambda T, x: T.erf(x), ["x"], True),
        "logit": (lambda T, x: T.logit(x, 1e-3), ["prob"], True),
        "logsumexp": (lambda T, x: T.logsumexp(x), ["x"], True),
        "clip": (lambda T, x: T.clip(x, -0.5, 0.5), ["x"], True),
        "cumsum": (lambda T, x: T.cumsum(x), ["x"], True),
        "cumsum_axis": (lambda T, x: T.cumsum(x, axis=1), ["x"], True),
        "add_n": (lambda T, x, y: T.add_n([x, y, x]), ["x", "y"], True),
    },
    "linalg": {
        "matmul": (lambda T, x, m: T.matmul(x, m), ["x", "m"], True),
        "mm": (lambda T, x, m: T.mm(x, m), ["x", "m"], True),
        "mul": (lambda T, x, m: T.mul(x, m), ["x", "m"], True),
        "bmm": (lambda T, a, b: T.bmm(a, b), ["b3", "c3"], True),
        "dot": (lambda T, a, b: T.dot(a, b), ["x", "y"], True),
        "dot_1d": (lambda T, a, b: T.dot(a, b), ["v4", "w4"], True),
        "mv": (lambda T, x, v: T.mv(x, v), ["x", "v4"], True),
        "addmm": (lambda T, i, x, y: T.addmm(i, x, y, beta=0.5, alpha=2.0),
                  ["x35", "x", "m"], True),
        "kron": (lambda T, a, b: T.kron(a, b), ["v3a", "sq"], True),
        "cross": (lambda T, a, b: T.cross(a, b), ["v3a", "v3b"], True),
        "trace": (lambda T, x: T.trace(x), ["sq"], True),
        "trace_offset": (lambda T, x: T.trace(x, offset=1), ["x"], True),
        "tril": (lambda T, x: T.tril(x), ["x"], True),
        "triu": (lambda T, x: T.triu(x, 1), ["x"], True),
        "cholesky": (lambda T, x: T.cholesky(x), ["spd"], True),
        "cholesky_upper": (lambda T, x: T.cholesky(x, upper=True), ["spd"],
                           True),
        "inverse": (lambda T, x: T.inverse(x), ["spd"], True),
        "t": (lambda T, x: T.t(x), ["x"], True),
        "dist": (lambda T, x, y: T.dist(x, y), ["x", "y"], True),
        "dist_p1": (lambda T, x, y: T.dist(x, y, p=1), ["x", "y"], True),
        "dist_inf": (lambda T, x, y: T.dist(x, y, p=float("inf")),
                     ["x", "y"], True),
        "norm": (lambda T, x: T.norm(x), ["x"], True),
        "norm_p1_axis0": (lambda T, x: T.norm(x, p=1, axis=0), ["x"], True),
        "diag": (lambda T, v: T.diag(v), ["v4"], True),
        "diag_padding": (lambda T, v: T.diag(v, padding_value=9), ["v4"],
                         True),
        "diag_of_matrix": (lambda T, x: T.diag(x, offset=1), ["x"], True),
        "median": (lambda T, x: T.median(x, axis=1), ["x"], True),
        "median_all": (lambda T, x: T.median(x), ["x"], True),
        "std": (lambda T, x: T.std(x, axis=1), ["x"], True),
        "var": (lambda T, x: T.var(x), ["x"], True),
    },
    "manipulation": {
        "concat": (lambda T, x, y: T.concat([x, y], axis=1), ["x", "y"],
                   True),
        "cast": (lambda T, x: T.cast(x, "int64"), ["x"], True),
        "reshape": (lambda T, x: T.reshape(x, [4, 3]), ["x"], True),
        "squeeze": (lambda T, x: T.squeeze(T.unsqueeze(x, [0]), [0]),
                    ["x"], True),
        "transpose": (lambda T, x: T.transpose(x, [1, 0]), ["x"], True),
        "flatten": (lambda T, x: T.flatten(x, 2), ["b3"], True),
        "split": (lambda T, x: T.split(x, 2, dim=1), ["x"], True),
        "chunk": (lambda T, x: T.chunk(x, 2, axis=1), ["x"], True),
        "slice": (lambda T, x: T.slice(x, [1], [1], [3]), ["x"], True),
        "strided_slice": (lambda T, x: T.strided_slice(x, [1], [0], [4],
                                                       [2]), ["x"], True),
        "gather": (lambda T, x, i: T.gather(x, i), ["x", "ids"], True),
        "gather_nd": (lambda T, x, i: T.gather_nd(x, i), ["x", "ind2"],
                      True),
        "index_select": (lambda T, x, i: T.index_select(x, i, axis=0),
                         ["x", "ids"], True),
        "index_sample": (lambda T, x, i: T.index_sample(x, i),
                         ["x", "ids2"], True),
        "scatter": (lambda T, x, i, u: T.scatter(x, i, u), ["x", "ids",
                                                            "upd"], True),
        "scatter_accumulate": (lambda T, x, i, u: T.scatter(
            x, i, u, overwrite=False), ["x", "ids", "upd"], True),
        "scatter_nd_add": (lambda T, x, i, u: T.scatter_nd_add(
            T.reshape(x, [12]), i, u), ["x", "col", "u3"], True),
        "scatter_nd": (lambda T, i, u: T.scatter_nd(i, u, [4, 2, 3]),
                       ["col", "u323"], True),
        "stack": (lambda T, x, y: T.stack([x, y], axis=1), ["x", "y"], True),
        "unstack": (lambda T, x: T.unstack(x, axis=1), ["x"], True),
        "unbind": (lambda T, x: T.unbind(x, axis=0), ["x"], True),
        "expand": (lambda T, x: T.expand(x, [2, 1]), ["x"], True),
        "expand_as": (lambda T, v, x: T.expand_as(v, x), ["v4", "x"], True),
        "broadcast_to": (lambda T, v: T.broadcast_to(v, [3, 4]), ["v4"],
                         True),
        "tile": (lambda T, x: T.tile(x, [2, 1]), ["x"], True),
        "flip": (lambda T, x: T.flip(x, 0), ["x"], True),
        "reverse": (lambda T, x: T.reverse(x, 1), ["x"], True),
        "roll": (lambda T, x: T.roll(x, 1, 1), ["x"], True),
        "roll_flat": (lambda T, x: T.roll(x, 2), ["x"], True),
        "meshgrid": (lambda T, a, b: T.meshgrid(a, b), ["v4", "small"],
                     True),
        "where": (lambda T, c, x, y: T.where(c, x, y), ["mask", "x", "y"],
                  True),
        "masked_select": (lambda T, x, m: T.masked_select(x, m),
                          ["x", "mask"], False),
        "nonzero": (lambda T, m: T.nonzero(m), ["mask"], False),
        "multiplex": (lambda T, x, y, i: T.multiplex([x, y], i),
                      ["x", "y", "sel"], True),
        "shard_index": (lambda T, i: T.shard_index(i, 16, 2, 1),
                        ["ints"], True),
        "unique": (lambda T, x: T.unique(x), ["small"], False),
        "one_hot": (lambda T, i: T.one_hot(i, 5), ["col"], True),
        "assign": (lambda T, x: T.assign(x), ["x"], True),
        "topk": (lambda T, x: T.topk(x, 2), ["x"], True),
        "argsort": (lambda T, x: T.argsort(x, axis=1), ["x"], True),
        "argsort_desc": (lambda T, x: T.argsort(x, descending=True),
                         ["small"], True),
        "sort": (lambda T, x: T.sort(x), ["small"], True),
        "increment": (lambda T, x: T.increment(x, 2.0), ["v4"], True),
    },
    "logic": {
        "equal": (lambda T, x, y: T.equal(x, y), ["x", "x"], True),
        "not_equal": (lambda T, x, y: T.not_equal(x, y), ["x", "y"], True),
        "greater_than": (lambda T, x, y: T.greater_than(x, y), ["x", "y"],
                         True),
        "greater_equal": (lambda T, x, y: T.greater_equal(x, y),
                          ["x", "y"], True),
        "less_than": (lambda T, x, y: T.less_than(x, y), ["x", "y"], True),
        "less_equal": (lambda T, x, y: T.less_equal(x, y), ["x", "y"],
                       True),
        "logical_and": (lambda T, a, b: T.logical_and(a, b), ["bx", "by"],
                        True),
        "logical_or": (lambda T, a, b: T.logical_or(a, b), ["bx", "by"],
                       True),
        "logical_xor": (lambda T, a, b: T.logical_xor(a, b), ["bx", "by"],
                        True),
        "logical_not": (lambda T, a: T.logical_not(a), ["bx"], True),
        "isnan": (lambda T, x: T.isnan(x), ["naninf"], True),
        "isinf": (lambda T, x: T.isinf(x), ["naninf"], True),
        "isfinite": (lambda T, x: T.isfinite(x), ["naninf"], True),
        "allclose": (lambda T, x, y: T.allclose(x, y), ["x", "x"], True),
        "allclose_not": (lambda T, x, y: T.allclose(x, y), ["x", "y"],
                         True),
        "equal_all": (lambda T, x, y: T.equal_all(x, y), ["x", "x"], True),
        "equal_all_not": (lambda T, x, y: T.equal_all(x, y), ["x", "y"],
                          True),
        "is_empty": (lambda T, x: T.is_empty(x), ["zero1"], True),
        "all": (lambda T, m: T.all(m, axis=1), ["mask"], True),
        "any": (lambda T, m: T.any(m), ["mask"], True),
    },
    "reduction": {
        "mean": (lambda T, x: T.mean(x), ["x"], True),
        "mean_axis": (lambda T, x: T.mean(x, axis=1, keepdim=True), ["x"],
                      True),
        "sum": (lambda T, x: T.sum(x, axis=0), ["x"], True),
        "max": (lambda T, x: T.max(x, axis=1), ["x"], True),
        "min": (lambda T, x: T.min(x), ["x"], True),
        "prod": (lambda T, x: T.prod(x, axis=[0, 1]), ["pos"], True),
        "argmax": (lambda T, x: T.argmax(x, axis=1), ["x"], True),
        "argmin": (lambda T, x: T.argmin(x, axis=0), ["x"], True),
        "histogram": (lambda T, x: T.histogram(x, bins=4, min=-2, max=2),
                      ["x"], True),
        "rank": (lambda T, x: T.rank(x), ["b3"], True),
        "shape": (lambda T, x: T.shape(x), ["b3"], True),
    },
    "creation": {
        "zeros": (lambda T: T.zeros([2, 3]), [], True),
        "ones": (lambda T: T.ones([2, 3], "int64"), [], True),
        "full": (lambda T: T.full([2, 2], 1.5), [], True),
        "empty": (lambda T: T.empty([2, 3]), [], True),
        "fill_constant": (lambda T: T.fill_constant([3], "float32", 2.0),
                          [], True),
        "eye": (lambda T: T.eye(3, 4), [], True),
        "zeros_like": (lambda T, x: T.zeros_like(x), ["x"], True),
        "ones_like": (lambda T, x: T.ones_like(x), ["x"], True),
        "full_like": (lambda T, x: T.full_like(x, 3.0), ["x"], True),
        "empty_like": (lambda T, x: T.empty_like(x), ["x"], True),
        "to_tensor": (lambda T: T.to_tensor(A["sq"]), [], True),
        "arange": (lambda T: T.arange(0, 5, 1), [], False),
        "linspace": (lambda T: T.linspace(0, 1, 5), [], False),
    },
}
CASES = {(fam, name): spec for fam, cases in FAMILIES.items()
         for name, spec in cases.items()}


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _flat(x)]
    return [out]


def _as_np(v):
    return np.asarray(v.numpy() if hasattr(v, "numpy") else v)


def _dygraph(T, dy, enter, fam, name):
    fn, keys, _ = CASES[(fam, name)]
    enter()
    try:
        return [_as_np(o) for o in _flat(
            fn(T, *[dy.to_variable(A[k]) for k in keys]))]
    finally:
        dy.disable_dygraph()


def _static_family(T, fluid, executor, fam):
    """Every static case of ``fam`` in one program: {name: outputs}."""
    main, startup = fluid.Program(), fluid.Program()
    fetch, spans = [], {}
    with fluid.program_guard(main, startup):
        feed = {}
        for name, (fn, keys, static) in FAMILIES[fam].items():
            if not static:
                continue
            ins = []
            for i, k in enumerate(keys):
                n = f"{name}__{i}"
                feed[n] = A[k]
                ins.append(fluid.data(n, list(A[k].shape),
                                      dtype=str(A[k].dtype)))
            outs = _flat(fn(T, *ins))
            spans[name] = (len(fetch), len(fetch) + len(outs))
            fetch += outs
        exe = executor()
        exe.run(startup)
        vals = exe.run(main, feed=feed, fetch_list=fetch)
    return {n: [np.asarray(v) for v in vals[a:b]]
            for n, (a, b) in spans.items()}


_STATIC = {}


def _static(fam):
    if fam not in _STATIC:
        jdy.disable_dygraph()
        tdy.disable_dygraph()
        _STATIC[fam] = (
            _static_family(JT, jfluid, jfluid.Executor, fam),
            _static_family(TT, tfluid,
                           lambda: tfluid.Executor(tfluid.CPUPlace()), fam))
    return _STATIC[fam]


def _same(got, want, label):
    assert len(got) == len(want), label
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (label, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=label)
        else:
            np.testing.assert_array_equal(g, w, err_msg=label)


def _family_test(fam, name):
    want = _dygraph(JT, jdy, jdy.enable_dygraph, fam, name)
    got = _dygraph(TT, tdy, lambda: tdy.enable_dygraph(tfluid.CPUPlace()),
                   fam, name)
    _same(got, want, f"{name} (dygraph)")
    if CASES[(fam, name)][2]:
        ref, port = _static(fam)
        _same(port[name], ref[name], f"{name} (static)")


@pytest.mark.parametrize("name", sorted(FAMILIES["elementwise"]))
def test_elementwise_and_unary_match_reference(name):
    _family_test("elementwise", name)


@pytest.mark.parametrize("name", sorted(FAMILIES["linalg"]))
def test_linalg_and_stats_match_reference(name):
    _family_test("linalg", name)


@pytest.mark.parametrize("name", sorted(FAMILIES["manipulation"]))
def test_manipulation_matches_reference(name):
    _family_test("manipulation", name)


@pytest.mark.parametrize("name", sorted(FAMILIES["logic"]))
def test_logic_matches_reference(name):
    _family_test("logic", name)


@pytest.mark.parametrize("name", sorted(FAMILIES["reduction"]))
def test_reductions_match_reference(name):
    _family_test("reduction", name)


@pytest.mark.parametrize("name", sorted(FAMILIES["creation"]))
def test_creation_matches_reference(name):
    _family_test("creation", name)


# --- the random functions: a contract, not bits ----------------------------
def _random_draws(T, dy, enter):
    enter()
    try:
        np.random.seed(3)
        x = dy.to_variable(np.full((4000,), 0.3, "float32"))
        probs = dy.to_variable(np.array([0.1, 0.2, 0.7], "float32"))
        return {
            "rand": _as_np(T.rand([200, 5])),
            "uniform": _as_np(T.uniform([200, 5], min=-2.0, max=3.0)),
            "randn": _as_np(T.randn([4000])),
            "standard_normal": _as_np(T.standard_normal([4000])),
            "normal": _as_np(T.normal(1.0, 2.0, [4000])),
            "randint": _as_np(T.randint(2, 7, [4000])),
            "randperm": _as_np(T.randperm(50)),
            "bernoulli": _as_np(T.bernoulli(x)),
            "multinomial": _as_np(T.multinomial(probs, 4000,
                                                replacement=True)),
            "multinomial_distinct": _as_np(T.multinomial(
                dy.to_variable(np.array([0.2, 0.3, 0.1, 0.4], "float32")),
                4)),
        }
    finally:
        dy.disable_dygraph()


# name -> check(draw): the contract both packages meet
RANDOM_CONTRACTS = {
    "rand": lambda d: d.shape == (200, 5) and d.dtype == np.float32
    and d.min() >= 0 and d.max() < 1 and abs(d.mean() - 0.5) < 0.05,
    "uniform": lambda d: d.shape == (200, 5) and d.min() >= -2
    and d.max() < 3 and abs(d.mean() - 0.5) < 0.2,
    "randn": lambda d: abs(d.mean()) < 0.1 and abs(d.std() - 1) < 0.1,
    "standard_normal": lambda d: abs(d.mean()) < 0.1
    and abs(d.std() - 1) < 0.1,
    "normal": lambda d: abs(d.mean() - 1) < 0.2 and abs(d.std() - 2) < 0.2,
    "randint": lambda d: d.shape == (4000,) and d.min() == 2
    and d.max() == 6 and np.issubdtype(d.dtype, np.integer)
    and all(abs((d == v).mean() - 0.2) < 0.04 for v in range(2, 7)),
    "randperm": lambda d: np.array_equal(np.sort(d), np.arange(50)),
    "bernoulli": lambda d: set(np.unique(d).tolist()) <= {0.0, 1.0}
    and abs(d.mean() - 0.3) < 0.04,
    "multinomial": lambda d: d.shape == (4000,)
    and all(abs((d == i).mean() - p) < 0.04
            for i, p in enumerate((0.1, 0.2, 0.7))),
    "multinomial_distinct": lambda d: sorted(d.tolist()) == [0, 1, 2, 3],
}


@pytest.mark.parametrize("name", sorted(RANDOM_CONTRACTS))
def test_random_function_contract(name):
    """Range, shape, dtype and frequencies (to 0.04 absolute over 4,000
    draws, about 4.5 standard errors of a frequency near 0.3) in both
    packages; the port's draws come from its op's own generator."""
    want = _random_draws(JT, jdy, jdy.enable_dygraph)[name]
    got = _random_draws(TT, tdy,
                        lambda: tdy.enable_dygraph(tfluid.CPUPlace()))[name]
    assert RANDOM_CONTRACTS[name](np.asarray(want)), "reference"
    assert RANDOM_CONTRACTS[name](np.asarray(got)), "port"


def test_static_random_ops_draw_their_own_streams():
    """Two ``rand`` calls in one program draw different numbers, and a
    rerun of the program under the same seeds draws the same."""
    tdy.disable_dygraph()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        a, b = TT.rand([4, 4]), TT.rand([4, 4])
    exe = tfluid.Executor(tfluid.CPUPlace())
    av, bv = exe.run(main, fetch_list=[a, b])
    av2, _ = exe.run(main, fetch_list=[a, b])
    assert not np.allclose(av, bv)
    assert av.min() >= 0 and av.max() < 1


# --- the rest: plain Python over shapes ------------------------------------
def test_python_helpers_match_reference():
    for T, dy, enter in ((JT, jdy, jdy.enable_dygraph),
                         (TT, tdy, lambda: tdy.enable_dygraph(
                             tfluid.CPUPlace()))):
        enter()
        try:
            x = dy.to_variable(A["x"])
            assert T.numel(x) == 12
            assert T.broadcast_shape([1, 4], [3, 1]) == [3, 4]
            assert T.is_tensor(x) and not T.is_tensor(5)
            T.set_printoptions(precision=6)
        finally:
            dy.disable_dygraph()
    np.set_printoptions(precision=8)


def test_var_refuses_dynamic_reduced_dims():
    tdy.disable_dygraph()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.data("vx", [-1, 5])
        with pytest.raises(ValueError, match="static sizes"):
            TT.var(x)


def test_to_tensor_places_on_the_tracer_or_the_named_place():
    tdy.enable_dygraph(tfluid.CPUPlace())
    try:
        v = TT.to_tensor(A["x"], stop_gradient=False)
        assert v.value().device.type == "cpu" and not v.stop_gradient
        w = TT.to_tensor(A["x"], place=tfluid.CPUPlace())
        assert w.value().device.type == "cpu"
    finally:
        tdy.disable_dygraph()


# --- every tensor function and every op this slice ported has a case -------
ITEM2_TENSOR_OPS = (
    "addmm allclose bernoulli cholesky cross cumsum diag_v2 dist dot "
    "equal_all expand_v2 flip greater_equal greater_than histogram "
    "index_sample index_select inverse isfinite_v2 isinf_v2 isnan_v2 kron "
    "less_equal logical_and logical_not logical_or logical_xor logit "
    "masked_select matmul_v2 meshgrid multinomial mv not_equal p_norm "
    "randint randperm reduce_all reduce_any reduce_max reduce_min "
    "reduce_prod roll tile trace tril_triu unbind where_index reshape").split()

# functions whose case goes by another name (or is in a contract test)
_CASE_OF = {"arange": "arange", "bernoulli": "bernoulli", "rand": "rand",
            "randn": "randn", "randint": "randint", "randperm": "randperm",
            "multinomial": "multinomial", "normal": "normal",
            "uniform": "uniform", "standard_normal": "standard_normal",
            "unsqueeze": "squeeze", "numel": None, "broadcast_shape": None,
            "is_tensor": None, "set_printoptions": None}


def test_every_tensor_function_has_a_case():
    import types
    names = {n for n in dir(TT) if not n.startswith("_")
             and callable(getattr(TT, n))
             and not isinstance(getattr(TT, n), types.ModuleType)}
    cased = {name for (_, name) in CASES} | set(RANDOM_CONTRACTS)
    missing = sorted(n for n in names
                     if n not in cased and n not in _CASE_OF)
    assert not missing, missing


def test_item2_ops_registered():
    """Every op the tensor namespace reaches is registered (each has a
    case above; ``reshape`` is ``VarBase.reshape``'s, held in
    tests/test_torch_grad.py's module and tests/test_torch_tensor.py's
    operator case below)."""
    assert [op for op in ITEM2_TENSOR_OPS if not has_op(op)] == []


def test_varbase_operators_match_reference():
    """``VarBase``'s operators, each through its op as the reference's."""
    out = []
    for dy, enter in ((jdy, jdy.enable_dygraph),
                      (tdy, lambda: tdy.enable_dygraph(tfluid.CPUPlace()))):
        enter()
        try:
            x, y = dy.to_variable(A["x"]), dy.to_variable(A["pos"])
            m = dy.to_variable(A["m"])
            res = [x / y, 2.0 / y, y ** 2.0, 2.0 ** x, x // y, x % y,
                   x > y, x < y, x >= y, x <= y, x @ m, -x,
                   x.reshape([4, 3]), x[1], x[:, 1:3]]
            out.append(([_as_np(r) for r in res], len(x),
                        bool(dy.to_variable(np.array([2.0], "float32")))))
        finally:
            dy.disable_dygraph()
    (want, wl, wb), (got, gl, gb) = out
    _same(got, want, "operators")
    assert gl == wl == 3 and gb == wb is True
