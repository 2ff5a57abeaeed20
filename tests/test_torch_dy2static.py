"""Converted control flow of paddle_tpu_torch's dygraph-to-static tier
(dygraph/dygraph_to_static/) against paddle_tpu's.

Each case is written once and built in both packages under their own
``declarative``; both run on the CPU from the same numpy inputs and give
the same values (float32 within rtol 1e-5, atol 1e-6; ids and counts
exactly), or raise the same kind of error.  The reference lowers a
tensor predicate to ``lax.cond`` / ``lax.while_loop`` inside its jit; the
port reads it on the host (``dy2static.host_reads``) and runs the branch
or trip eagerly.  Cases are held forward only: ``lax.while_loop`` cannot
be reverse-differentiated in the reference.
"""
import numpy as np
import pytest

import jax

from paddle_tpu.dygraph import base as jdy
from paddle_tpu.dygraph import jit_static as jjs
from paddle_tpu.dygraph.layers import Layer as JLayer
import paddle_tpu.fluid.layers as JL
import paddle_tpu.jit as jjit

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.dygraph import base as tdy
from paddle_tpu_torch.dygraph import jit_static as tjs
from paddle_tpu_torch.dygraph.layers import Layer as TLayer
from paddle_tpu_torch.fluid import trace as ttrace
import paddle_tpu_torch.fluid.layers as TL
import paddle_tpu_torch.jit as tjit

jax.config.update("jax_platforms", "cpu")

PKGS = {"ref": (jdy, jjs.declarative, JL, JLayer),
        "port": (tdy, tjs.declarative, TL, TLayer)}


@pytest.fixture(autouse=True)
def dygraph_mode():
    jdy.enable_dygraph()
    tdy.enable_dygraph(tfluid.CPUPlace())
    yield
    jdy.disable_dygraph()
    tdy.disable_dygraph()


def _host_reads():
    return ttrace.metrics().counter("dy2static.host_reads").value


# --- the cases of tests/test_jit_static.py's TestAstControlFlow ------------
def _tensor_if(dec, L):
    @dec
    def f(x):
        if L.reduce_mean(x) > 0:
            y = x * 2.0
        else:
            y = x + 10.0
        return y
    return f


def _tensor_while(dec, L):
    @dec
    def grow(s):
        n = 0.0
        while s < 100.0:
            s = s * 2.0
            n = n + 1.0
        return s, n
    return grow


def _tensor_range(dec, L):
    @dec
    def repeat_sum(x, n):
        acc = x * 0.0
        for i in range(n):
            acc = acc + x
        return acc
    return repeat_sum


def _python_predicates(dec, L):
    @dec
    def f(x, flag=True):
        if flag:
            y = x * 2.0
        else:
            y = x - 1.0
        k = 0
        while k < 3:
            y = y + 1.0
            k = k + 1
        return y
    return f


def _greedy_decode(dec, L):
    @dec
    def decode(tok, w, n):
        i = 0.0
        while i < n:
            logits = L.gather(w, tok)
            tok = L.argmax(logits, axis=-1)
            i = i + 1.0
        return tok
    return decode


def _while_call(dec, L):
    @dec
    def f(s):
        while L.reduce_mean(s) < 8.0:
            s = s * 2.0
        return s
    return f


def _negative_step(dec, L):
    @dec
    def f(x):
        acc = x * 0.0
        for i in range(5, 0, -1):
            acc = acc + x * float(i)
        return acc
    return f


def _nested_if(dec, L):
    @dec
    def f(x):
        if L.reduce_mean(x) > 0:
            if L.reduce_max(x) > 2.0:
                y = x * 10.0
            else:
                y = x * 2.0
        else:
            y = x - 1.0
        return y
    return f


def _loop_var_after(dec, L):
    @dec
    def f(x):
        for i in range(3):
            x = x + 1.0
        return x * float(i)
    return f


def _f32(v):
    return np.asarray(v, "float32")


TABLE = np.random.RandomState(0).randn(6, 6).astype("float32")
CASES = {
    "tensor_if_pos": (_tensor_if, [np.full((2, 3), 1.0, "float32")], {}),
    "tensor_if_neg": (_tensor_if, [np.full((2, 3), -1.0, "float32")], {}),
    "tensor_while_7_trips": (_tensor_while, [_f32(1.0)], {}),
    "tensor_while_1_trip": (_tensor_while, [_f32(60.0)], {}),
    "tensor_while_0_trips": (_tensor_while, [_f32(200.0)], {}),
    "tensor_range_3": (_tensor_range, [np.ones((2, 2), "float32"),
                                       np.int32(3)], {}),
    "tensor_range_5": (_tensor_range, [np.ones((2, 2), "float32"),
                                       np.int32(5)], {}),
    "python_predicates": (_python_predicates, [np.zeros(2, "float32")], {}),
    "python_predicates_false": (_python_predicates,
                                [np.zeros(2, "float32")], {"flag": False}),
    "greedy_decode": (_greedy_decode, [np.array([2], "int64"), TABLE,
                                       _f32(4.0)], {}),
    "while_condition_call": (_while_call, [np.full(2, 1.0, "float32")], {}),
    "negative_step_range": (_negative_step, [np.ones(2, "float32")], {}),
    "nested_if_big": (_nested_if, [np.full(2, 3.0, "float32")], {}),
    "nested_if_small": (_nested_if, [np.full(2, 1.0, "float32")], {}),
    "nested_if_neg": (_nested_if, [np.full(2, -1.0, "float32")], {}),
    "loop_var_after_loop": (_loop_var_after, [np.ones(2, "float32")], {}),
}


def _run(pkg, build, inputs, kwargs):
    dy, dec, L, _ = PKGS[pkg]
    f = build(dec, L)
    out = f(*[dy.to_variable(np.asarray(a)) for a in inputs], **kwargs)
    outs = out if isinstance(out, (list, tuple)) else [out]
    return [np.asarray(o._value if pkg == "ref" else o.numpy())
            for o in outs], f


@pytest.mark.parametrize("case", sorted(CASES))
def test_control_flow_matches_reference(case):
    build, inputs, kwargs = CASES[case]
    ref, _ = _run("ref", build, inputs, kwargs)
    port, _ = _run("port", build, inputs, kwargs)
    assert len(ref) == len(port)
    for r, p in zip(ref, port):
        if np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(p.ravel(), r.ravel())
        else:
            np.testing.assert_allclose(p.reshape(r.shape), r, rtol=1e-5,
                                       atol=1e-6)


def test_tensor_if_serves_both_branches_from_one_build():
    fs = {}
    for pkg in PKGS:
        dy, dec, L, _ = PKGS[pkg]
        fs[pkg] = f = _tensor_if(dec, L)
        for v in (1.0, -1.0):
            f(dy.to_variable(np.full((2, 3), v, "float32")))
    for f in fs.values():
        assert len(f._own_cache) == 1
        assert next(iter(f._own_cache.values()))["cell"]["traces"] == 1


@pytest.mark.parametrize("start,trips", [(1.0, 7), (60.0, 1), (200.0, 0)])
def test_host_reads_a_trip_plus_one(start, trips):
    _, dec, L, _ = PKGS["port"]
    f = _tensor_while(dec, L)
    before = _host_reads()
    _, n = f(tdy.to_variable(_f32(start)))
    assert float(n.numpy()) == trips
    assert _host_reads() - before == trips + 1


def test_tensor_if_reads_once():
    _, dec, L, _ = PKGS["port"]
    f = _tensor_if(dec, L)
    x = tdy.to_variable(np.ones((2, 3), "float32"))
    f(x)                        # the first call also runs the other branch
    before = _host_reads()
    f(x)
    assert _host_reads() - before == 1


# --- the reference's diagnostics: the same programs fail --------------------
def _unbound_read(dec, L):
    @dec
    def bad(s):
        while s < 10.0:
            t = t + 1.0          # noqa: F821 — read-before-write
            s = s + t
        return s
    return bad


def _one_python_branch(dec, L):
    @dec
    def f(x, flag=False):
        if flag:
            y = x * 2.0
        return y
    return f


def _one_tensor_branch(dec, L):
    @dec
    def f(x):
        if L.reduce_mean(x) > 0:
            z = x * 2.0
        return z
    return f


def _branch_shapes(dec, L):
    @dec
    def f(x):
        if L.reduce_mean(x) > 0:
            y = x * 2.0
        else:
            y = L.reshape(x, [-1])
        return y
    return f


def _loop_shapes(dec, L):
    @dec
    def f(x, n):
        i = 0.0
        while i < n:
            x = L.concat([x, x], axis=0)
            i = i + 1.0
        return x
    return f


def _loop_var_unbound(dec, L):
    @dec
    def f(x, n):
        for i in range(n):
            x = x + 1.0
        return x * i
    return f


FAILURES = {
    "unbound_read_in_loop": (_unbound_read, [_f32(1.0)],
                             UnboundLocalError),
    "one_python_branch": (_one_python_branch, [np.ones(2, "float32")],
                          (NameError, UnboundLocalError)),
    "one_tensor_branch": (_one_tensor_branch, [np.ones(2, "float32")],
                          ValueError),
    "branch_shapes": (_branch_shapes, [np.ones((2, 3), "float32")],
                      TypeError),
    "loop_shapes": (_loop_shapes, [np.ones((2, 3), "float32"), _f32(2.0)],
                    TypeError),
    "loop_var_unbound_after_tensor_range": (
        _loop_var_unbound, [np.ones(2, "float32"), np.int32(3)],
        (NameError, UnboundLocalError)),
}


@pytest.mark.parametrize("case", sorted(FAILURES))
@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_same_programs_fail(case, pkg):
    build, inputs, error = FAILURES[case]
    with pytest.raises(error):
        _run(pkg, build, inputs, {})


def test_super_method_falls_back():
    outs = {}
    for pkg in PKGS:
        dy, dec, L, Layer = PKGS[pkg]

        class Base(Layer):
            def forward(self, x):
                return x + 1.0

        class Child(Base):
            @dec
            def forward(self, x, flag=True):
                if flag:
                    y = super().forward(x)
                else:
                    y = x
                return y

        out = Child()(dy.to_variable(np.zeros(2, "float32")))
        outs[pkg] = np.asarray(out._value if pkg == "ref" else out.numpy())
    np.testing.assert_array_equal(outs["port"], outs["ref"])
    np.testing.assert_array_equal(outs["port"], [1.0, 1.0])


# --- ProgramTranslator, not_to_static, convert_call ------------------------
def _plain(x):
    return x * 2


def test_program_translator_and_not_to_static():
    for jit in (jjit, tjit):
        pt = jit.ProgramTranslator()
        assert pt is jit.ProgramTranslator.get_instance()
        pt.enable(False)
        assert pt.get_func(_plain) is _plain
        pt.enable(True)
        assert pt.get_output(_plain, 3) == 6
    assert tjit.ProgramTranslator().get_code(_tensor_if) == \
        jjit.ProgramTranslator().get_code(_tensor_if)

    def g(x):
        return x + 1

    for jit in (jjit, tjit):
        assert jit.not_to_static(g) is g
        assert jit.dy2static.convert_call(g) is g
        assert jit.dy2static.convert_call(len) is len


def test_dy2static_namespace_matches_reference():
    names = {m: sorted(n for n in dir(m) if not n.startswith("_"))
             for m in (jjit.dy2static, tjit.dy2static)}
    assert names[tjit.dy2static] == names[jjit.dy2static]
    assert tjit.dy2static.__all__ == jjit.dy2static.__all__


@pytest.mark.parametrize("values", [(True, 1.0), (3, 4.5)])
def test_helpers_on_python_values(values):
    a, b = values
    for jit in (jjit, tjit):
        d = jit.dy2static
        assert d.convert_logical_and(lambda: a, lambda: b) == (a and b)
        assert d.convert_logical_or(lambda: a, lambda: b) == (a or b)
        assert d.convert_logical_not(a) == (not a)
        assert d.convert_shape_compare(1, "<", 2, "<=", 2) is True
        assert d.convert_var_dtype(b, "int") == int(b)
        assert d.convert_len([a, b]) == 2
