"""The training slice as a whole: paddle_tpu_torch against paddle_tpu.

Both packages build the small static BERT training program (vocab 64,
hidden 32, 4 heads, seq 16, 2 layers, dropout 0, padding mask on, Adam
lr 1e-3) and train it through ``Executor.run(CompiledProgram(main, bs))``
with ``fuse_attention`` and ``fuse_optimizer`` on.  The JAX side runs its
startup program; the port takes every persistable of that scope (params,
moments, beta powers, learning rate) through ``interop.scope_from_numpy``
and runs on ``CPUPlace()``, where the fused attention op and its grad
take the plain version and ``fused_adam`` its plain branch.

Tolerances: gradients rtol 1e-4 and atol 1e-6 x the largest gradient
magnitude of any parameter, losses rtol 1e-4, moments rtol 1e-4 and atol
1e-6 x the largest magnitude of that moment over all parameters — the two
libraries sum float32 products in different orders, nothing more.  The
scale is taken over all parameters because the key projection's bias
has a zero gradient in exact arithmetic (softmax ignores a shift shared
by a row's scores): both packages give it rounding noise of about
1e-12, which a per-tensor scale would compare with itself.  The port's
own kernel-tier contracts (the rewrites against the unrewritten program)
are held bit for bit.
"""
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.core import Scope as JScope, scope_guard
from paddle_tpu.fluid.framework import reset_unique_name as j_reset
from paddle_tpu.models.static_graphs import \
    build_bert_train_program as j_build

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.fluid import trace as ttrace
from paddle_tpu_torch.fluid.framework import reset_unique_name as t_reset
from paddle_tpu_torch.models.static_graphs import \
    build_bert_train_program as t_build, bert_demo_feed

SMALL = dict(vocab=64, hidden=32, heads=4, seq=16, layers=2, dropout=0.0,
             lr=1e-3)
STEPS = 5


def _strategy(fluid, attention=True, optimizer=True):
    bs = fluid.BuildStrategy()
    bs.fuse_attention = attention
    bs.fuse_optimizer = optimizer
    return bs


def _op_stream(program):
    return [(op.type, op.inputs, op.outputs)
            for op in program.global_block().ops]


def _grad_names(main):
    return [p.name + "@GRAD" for p in main.all_parameters()]


def _feed(with_mask=True, seed=0):
    return bert_demo_feed(np.random.RandomState(seed), batch=8,
                          seq=SMALL["seq"], vocab=SMALL["vocab"],
                          with_mask=with_mask)


@pytest.fixture(scope="module")
def reference():
    """paddle_tpu's run: the op streams before and after both passes,
    the initial persistables, the first step's loss and gradients, the
    moments after it, and the losses of STEPS steps."""
    j_reset()
    main, startup, loss = j_build(**SMALL)
    before = _op_stream(main)
    startup_ops = _op_stream(startup)
    feed = _feed()
    grads = _grad_names(main)
    exe = jfluid.Executor()
    scope = JScope()
    with scope_guard(scope):
        exe.run(startup)
        persist = [n for n, v in main.global_block().vars.items()
                   if v.persistable and scope.find_var(n) is not None]
        init = {n: np.array(scope.find_var(n)) for n in persist}
        prog = jfluid.CompiledProgram(main, build_strategy=_strategy(jfluid))
        first = exe.run(prog, feed=feed, fetch_list=[loss] + grads)
        moments = {n: np.array(scope.find_var(n)) for n in persist
                   if "_moment" in n}
        losses = [float(np.asarray(first[0]).ravel()[0])]
        for _ in range(STEPS - 1):
            out = exe.run(prog, feed=feed, fetch_list=[loss])
            losses.append(float(np.asarray(out[0]).ravel()[0]))
    return dict(before=before, after=_op_stream(main), startup=startup_ops,
                init=init,
                grads=dict(zip(grads, first[1:])), moments=moments,
                losses=losses, feed=feed)


def _port_run(init, feed, steps, attention=True, optimizer=True,
              fetch_grads=False, with_mask=True, dropout=0.0):
    """The port's run from ``init``: (losses, first-step grads, the
    scope after step 1's moments, final scope arrays, main program)."""
    t_reset()
    main, _, loss = t_build(train=True, with_mask=with_mask,
                            **dict(SMALL, dropout=dropout))
    scope = interop.scope_from_numpy(init, tfluid.Scope(), tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    prog = tfluid.CompiledProgram(main, _strategy(tfluid, attention,
                                                  optimizer))
    grads = _grad_names(main) if fetch_grads else []
    losses, first_grads, moments = [], {}, {}
    for step in range(steps):
        out = exe.run(prog, feed=feed, fetch_list=[loss] + grads,
                      scope=scope)
        losses.append(float(out[0].ravel()[0]))
        if step == 0:
            first_grads = dict(zip(grads, out[1:]))
            moments = interop.scope_to_numpy(
                scope, [n for n in init if "_moment" in n])
    final = interop.scope_to_numpy(scope, list(init))
    return losses, first_grads, moments, final, main


def _close_all(got, want, rtol, atol_frac):
    """Each array of ``got`` against ``want`` with atol = atol_frac x the
    largest magnitude over all of ``want``'s arrays."""
    assert set(got) == set(want) and want
    scale = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        assert got[name].shape == np.shape(w), name
        np.testing.assert_allclose(np.asarray(got[name], np.float64),
                                   np.asarray(w, np.float64), rtol=rtol,
                                   atol=atol_frac * scale, err_msg=name)


def test_op_stream_matches_reference(reference):
    """Op types, slots and grad-var names, before and after both passes
    (one fused attention op and fused grad per layer, one fused_adam),
    and the startup program that fills the optimizer's state."""
    t_reset()
    main, startup, loss = t_build(train=True, **SMALL)
    assert _op_stream(main) == reference["before"]
    assert _op_stream(startup) == reference["startup"]
    # shape inference (meta tensors) got through every generic_grad
    assert all(v.shape is not None for v in main.global_block().vars.values())
    rewrites = ttrace.metrics().counter("kernel_tier.fuse_attention.rewrites")
    buckets = ttrace.metrics().counter("kernel_tier.fuse_optimizer.rewrites")
    r0, b0 = rewrites.value, buckets.value
    tfluid.CompiledProgram(main, _strategy(tfluid))._apply_ir_passes(
        [loss.name])
    assert _op_stream(main) == reference["after"]
    assert rewrites.value - r0 == SMALL["layers"]
    assert buckets.value - b0 == 1
    types = [op.type for op in main.global_block().ops]
    assert types.count("fused_multihead_attention") == SMALL["layers"]
    assert types.count("fused_adam") == 1
    for absent in ("softmax", "adam"):
        assert absent not in types


def test_first_step_gradients_match_reference(reference):
    _, grads, _, _, _ = _port_run(reference["init"], reference["feed"], 1,
                                  fetch_grads=True)
    _close_all(grads, reference["grads"], 1e-4, 1e-6)


def test_losses_and_moments_match_reference(reference):
    losses, _, moments, _, _ = _port_run(reference["init"],
                                         reference["feed"], STEPS)
    np.testing.assert_allclose(losses, reference["losses"], rtol=1e-4)
    assert losses[-1] < losses[0]
    for which in ("_moment1_", "_moment2_"):
        _close_all({n: m for n, m in moments.items() if which in n},
                   {n: m for n, m in reference["moments"].items()
                    if which in n}, 1e-4, 1e-6)


@pytest.mark.parametrize("dropout,with_mask", [
    (0.0, True), (0.1, True), (0.0, False), (0.1, False)])
def test_fuse_attention_training_rewrite_is_bit_identical(reference,
                                                          dropout, with_mask):
    """The rewritten program (fused op + fused grad) trains exactly as
    the naive chain does on the host: same losses, same parameters.  An
    absorbed dropout op's seed regenerates the same mask."""
    feed = _feed(with_mask=with_mask)
    off = _port_run(reference["init"], feed, 3, attention=False,
                    optimizer=False, with_mask=with_mask, dropout=dropout)
    on = _port_run(reference["init"], feed, 3, attention=True,
                   optimizer=False, with_mask=with_mask, dropout=dropout)
    assert [op.type for op in on[4].global_block().ops].count(
        "fused_multihead_attention") == SMALL["layers"]
    assert on[0] == off[0]
    for name in off[3]:
        assert np.array_equal(on[3][name], off[3][name]), name


def test_fuse_optimizer_bucket_is_bit_identical(reference):
    """One fused_adam over the flattened bucket updates every param,
    moment and beta power exactly as the per-param adam ops do."""
    off = _port_run(reference["init"], reference["feed"], 3,
                    attention=True, optimizer=False)
    on = _port_run(reference["init"], reference["feed"], 3,
                   attention=True, optimizer=True)
    assert [op.type for op in on[4].global_block().ops].count(
        "fused_adam") == 1
    assert on[0] == off[0]
    for name in off[3]:
        assert np.array_equal(on[3][name], off[3][name]), name


def test_fill_constant_and_global_var_layers_match_reference():
    """``layers.fill_constant`` and ``layers.create_global_var`` (the
    optimizers' state) append the reference's ops to the main and
    startup programs."""
    def build(fluid, reset):
        reset()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            out = fluid.layers.fill_constant([2, 3], "float32", 0.5)
            var = fluid.layers.create_global_var([1], 1e-3, "float32",
                                                 persistable=True)
        return main, startup, out, var

    jm, js, jout, jvar = build(jfluid, j_reset)
    tm, ts, tout, tvar = build(tfluid, t_reset)
    assert _op_stream(tm) == _op_stream(jm)
    assert _op_stream(ts) == _op_stream(js)
    for op_t, op_j in zip(tm.global_block().ops + ts.global_block().ops,
                          jm.global_block().ops + js.global_block().ops):
        assert op_t.attrs == op_j.attrs
    assert (tout.name, tout.shape, tout.stop_gradient) == \
        (jout.name, jout.shape, jout.stop_gradient)
    assert (tvar.name, tvar.persistable, tvar.stop_gradient) == \
        (jvar.name, jvar.persistable, jvar.stop_gradient)
