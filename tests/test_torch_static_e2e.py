"""The static book tier end to end: paddle_tpu_torch against paddle_tpu.

First the six cases of ``tests/test_static_e2e.py`` on the port, on
``CPUPlace()``, with the same programs, data, step counts and
assertions: fit-a-line (SGD), MNIST LeNet (Adam, 40 steps of the seeded
synthetic digits), batch norm's moving statistics, save and load of the
persistables, ``clone(for_test=True)``, Momentum with
``GradientClipByGlobalNorm``.

Then both packages side by side.  LeNet at the repo's width (1x28x28,
conv 6@3x3 pad 1, pool, conv 16@5x5, pool, fc 120, fc 10) takes the
reference's startup values through ``interop.scope_from_numpy`` and
trains 3 steps in both: losses rtol 1e-4, the first step's gradients
within 1e-4 of the largest, the weights after one SGD step rtol 1e-5.
Adam's first steps are close to ``sign(g)·lr``, so weights after several
Adam steps are not compared.  In the port the kernel-tier program (one
``fused_adam``, its plain version on the CPU) is held bit for bit against
the plain program.  Shape bucketing: a ragged step padded to its bucket
against the unpadded step in the port (rtol 1e-4, atol 1e-5, the
reference's own tolerance), and the port's padded run against the
reference's padded run at the same tolerance.  Save and load round-trip
within the port and across packages in both directions.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.core import Scope as JScope, scope_guard
from paddle_tpu.fluid.framework import reset_unique_name as j_reset

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import trace as ttrace
from paddle_tpu_torch.fluid.clip import GradientClipByGlobalNorm

fluid = tfluid


@pytest.fixture(autouse=True)
def fresh_port_programs():
    """Each test gets the port's fresh default programs, global scope and
    name counters (the reference's come from conftest.py)."""
    prev = (tframework._main_program, tframework._startup_program,
            tcore._global_scope)
    tframework._main_program = tframework.Program()
    tframework._startup_program = tframework.Program()
    tcore._global_scope = tcore.Scope()
    tframework.reset_unique_name()
    yield
    (tframework._main_program, tframework._startup_program,
     tcore._global_scope) = prev


def _blob_data(rng, n=64):
    labels = rng.randint(0, 10, n).astype("int64")
    images = rng.randn(n, 1, 28, 28).astype("float32") * 0.3
    for i in range(n):
        y = labels[i]
        images[i, 0, y:y + 8, y:y + 8] += 2.0
    return images, labels[:, None]


# ---------------------------------------------------------------------------
# the six cases of tests/test_static_e2e.py, on the port
# ---------------------------------------------------------------------------

def test_fit_a_line(rng):
    x = fluid.data("x", [-1, 13])
    y = fluid.data("y", [-1, 1])
    pred = fluid.layers.fc(x, 1)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    fluid.optimizer.SGDOptimizer(0.01).minimize(loss)

    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())

    w_true = rng.randn(13, 1).astype("float32")
    xs = rng.randn(256, 13).astype("float32")
    ys = xs @ w_true + 0.01 * rng.randn(256, 1).astype("float32")
    losses = []
    for step in range(100):
        lv, = exe.run(feed={"x": xs, "y": ys}, fetch_list=[loss])
        losses.append(float(lv))
    assert losses[-1] < losses[0] * 0.1, losses[::20]


def test_recognize_digits_lenet(rng):
    img = fluid.data("img", [-1, 1, 28, 28])
    label = fluid.data("label", [-1, 1], dtype="int64")
    conv1 = fluid.layers.conv2d(img, 6, 3, padding=1, act="relu")
    pool1 = fluid.layers.pool2d(conv1, 2, "max", 2)
    conv2 = fluid.layers.conv2d(pool1, 16, 5, act="relu")
    pool2 = fluid.layers.pool2d(conv2, 2, "max", 2)
    fc1 = fluid.layers.fc(fluid.layers.flatten(pool2), 120, act="relu")
    logits = fluid.layers.fc(fc1, 10)
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, label))
    acc = fluid.layers.accuracy(logits, label)
    fluid.optimizer.AdamOptimizer(1e-3).minimize(loss)

    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    images, labels = _blob_data(rng)
    for step in range(40):
        lv, av = exe.run(feed={"img": images, "label": labels},
                         fetch_list=[loss, acc])
    assert float(lv) < 0.5
    assert float(av) > 0.9


def test_batch_norm_running_stats_update(rng):
    x = fluid.data("x", [-1, 4, 3, 3])
    out = fluid.layers.batch_norm(x, momentum=0.5)
    loss = fluid.layers.mean(out)
    fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    scope = fluid.global_scope()
    bn_mean_name = [n for n in scope.local_var_names() if ".w" in n or True]
    data = rng.randn(8, 4, 3, 3).astype("float32") + 5.0
    exe.run(feed={"x": data}, fetch_list=[loss])
    # after one step the moving mean must move toward ~5
    prog = fluid.default_main_program()
    mean_vars = [v.name for v in prog.global_block().vars.values()
                 if v.persistable and "batch_norm" in v.name]
    moved = False
    for n in mean_vars:
        val = np.asarray(scope.find_var(n))
        if val.shape == (4,) and np.abs(val).mean() > 0.5:
            moved = True
    assert moved, "moving mean did not update"


def test_save_load_persistables(tmp_path, rng):
    x = fluid.data("x", [-1, 8])
    out = fluid.layers.fc(x, 4)
    loss = fluid.layers.mean(out)
    fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    xs = rng.randn(4, 8).astype("float32")
    exe.run(feed={"x": xs}, fetch_list=[loss])

    scope = fluid.global_scope()
    params = {n: np.asarray(scope.find_var(n))
              for n in scope.local_var_names()}
    fluid.save_persistables(exe, str(tmp_path))

    # perturb then restore
    for n in params:
        scope.set_var(n, params[n] * 0 + 99.0)
    fluid.load_persistables(exe, str(tmp_path))
    for n, want in params.items():
        np.testing.assert_allclose(np.asarray(scope.find_var(n)), want,
                                   err_msg=n)


def test_program_clone_for_test_drops_grads(rng):
    x = fluid.data("x", [-1, 8])
    out = fluid.layers.fc(x, 4)
    loss = fluid.layers.mean(out)
    fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    prog = fluid.default_main_program()
    test_prog = prog.clone(for_test=True)
    types = [op.type for op in test_prog.global_block().ops]
    assert "generic_grad" not in types
    assert "sgd" not in types


def test_exponential_decay_training(rng):
    """Multiple optimizers with gradient clipping."""
    x = fluid.data("x", [-1, 10])
    y = fluid.data("y", [-1, 1])
    h = fluid.layers.fc(x, 16, act="tanh")
    pred = fluid.layers.fc(h, 1)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    opt = fluid.optimizer.MomentumOptimizer(
        0.05, 0.9, grad_clip=GradientClipByGlobalNorm(1.0))
    opt.minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    xs = rng.randn(64, 10).astype("float32")
    ys = (xs.sum(1, keepdims=True) > 0).astype("float32")
    first = None
    for step in range(50):
        lv, = exe.run(feed={"x": xs, "y": ys}, fetch_list=[loss])
        if first is None:
            first = float(lv)
    assert float(lv) < first


# ---------------------------------------------------------------------------
# both packages from one init
# ---------------------------------------------------------------------------

def _lenet(pkg, optimizer="adam", bn=False):
    """LeNet as ``test_recognize_digits_lenet`` builds it; with ``bn``,
    conv1 has no bias and a ``batch_norm`` follows it (a bias there would
    have a gradient of rounding noise alone, which Adam scales up to
    ``lr``); returns (loss, acc)."""
    img = pkg.data("img", [-1, 1, 28, 28])
    label = pkg.data("label", [-1, 1], dtype="int64")
    conv1 = pkg.layers.conv2d(img, 6, 3, padding=1,
                              bias_attr=False if bn else None,
                              act=None if bn else "relu")
    if bn:
        conv1 = pkg.layers.batch_norm(conv1, act="relu")
    pool1 = pkg.layers.pool2d(conv1, 2, "max", 2)
    conv2 = pkg.layers.conv2d(pool1, 16, 5, act="relu")
    pool2 = pkg.layers.pool2d(conv2, 2, "max", 2)
    fc1 = pkg.layers.fc(pkg.layers.flatten(pool2), 120, act="relu")
    logits = pkg.layers.fc(fc1, 10)
    loss = pkg.layers.mean(
        pkg.layers.softmax_with_cross_entropy(logits, label))
    acc = pkg.layers.accuracy(logits, label)
    if optimizer == "adam":
        pkg.optimizer.AdamOptimizer(1e-3).minimize(loss)
    else:
        pkg.optimizer.SGDOptimizer(0.1).minimize(loss)
    return loss, acc


def _mlp(pkg, bn=False):
    """tests/test_shape_bucketing.py's classifier (with its batch-norm
    variant); returns (loss, per-row loss)."""
    x = pkg.data("x", [-1, 32])
    y = pkg.data("y", [-1, 1], dtype="int64")
    if bn:
        h = pkg.layers.batch_norm(pkg.layers.fc(x, 16))
        lr = 0.05
    else:
        h = pkg.layers.fc(x, 16, act="relu")
        lr = 0.1
    per_row = pkg.layers.softmax_with_cross_entropy(pkg.layers.fc(h, 10), y)
    loss = pkg.layers.mean(per_row)
    pkg.optimizer.SGDOptimizer(lr).minimize(loss)
    return loss, per_row


def _build(pkg, build, **kw):
    (j_reset if pkg is jfluid else tframework.reset_unique_name)()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        fetches = build(pkg, **kw)
    return main, startup, fetches


def _persistables(main, scope):
    return {n: np.array(scope.find_var(n))
            for n, v in main.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


def _grad_names(main):
    return [p.name + "@GRAD" for p in main.all_parameters()
            if p.trainable]


def _reference(build, feeds, bucketing=False, grads=False, **kw):
    """paddle_tpu's run: (initial persistables, per-step fetches, first
    step's gradients, final persistables)."""
    main, startup, fetches = _build(jfluid, build, **kw)
    main._hints["shape_bucketing"] = bucketing
    gnames = _grad_names(main) if grads else []
    exe = jfluid.Executor()
    with scope_guard(JScope()):
        exe.run(startup)
        scope = jfluid.global_scope()
        init = _persistables(main, scope)
        outs, first = [], {}
        for i, feed in enumerate(feeds):
            got = exe.run(main, feed=feed, fetch_list=list(fetches) + gnames)
            outs.append([np.asarray(o) for o in got[:len(fetches)]])
            if i == 0:
                first = dict(zip(gnames, map(np.asarray,
                                             got[len(fetches):])))
        final = _persistables(main, scope)
    return init, outs, first, final


def _port(build, init, feeds, bucketing=False, grads=False,
          kernel_tier=False, **kw):
    """The port's run from ``init`` on the CPU: (per-step fetches, first
    step's gradients, final persistables, main program)."""
    main, _, fetches = _build(tfluid, build, **kw)
    main._hints["shape_bucketing"] = bucketing
    gnames = _grad_names(main) if grads else []
    scope = interop.scope_from_numpy(init, tfluid.Scope(), tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    prog = main
    if kernel_tier:
        bs = tfluid.BuildStrategy()
        bs.kernel_tier = True
        prog = tfluid.CompiledProgram(main, bs)
    outs, first = [], {}
    for i, feed in enumerate(feeds):
        got = exe.run(prog, feed=feed, fetch_list=list(fetches) + gnames,
                      scope=scope)
        outs.append(got[:len(fetches)])
        if i == 0:
            first = dict(zip(gnames, got[len(fetches):]))
    return outs, first, _persistables(main, scope), main


def _digits(n, seed=0, steps=3):
    images, labels = _blob_data(np.random.RandomState(seed), n)
    return [{"img": images, "label": labels}] * steps


def _close_all(got, want, rtol, atol_frac):
    """Each array of ``got`` against ``want``, atol = atol_frac x the
    largest magnitude over all of ``want``'s arrays."""
    assert set(got) == set(want) and want
    scale = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(np.asarray(got[name], np.float64),
                                   np.asarray(w, np.float64), rtol=rtol,
                                   atol=atol_frac * scale, err_msg=name)


@pytest.fixture(scope="module")
def lenet_reference():
    feeds = _digits(64)
    init, outs, first, _ = _reference(_lenet, feeds, grads=True)
    return feeds, init, outs, first


def test_lenet_matches_reference(lenet_reference):
    """3 Adam steps from the reference's init: losses rtol 1e-4 and the
    first step's gradients within 1e-4 of the largest."""
    feeds, init, ref_outs, ref_grads = lenet_reference
    outs, grads, _, main = _port(_lenet, init, feeds, grads=True)
    assert [p.name for p in main.all_parameters()] == \
        [n[:-len("@GRAD")] for n in ref_grads]
    np.testing.assert_allclose([float(o[0]) for o in outs],
                               [float(o[0]) for o in ref_outs], rtol=1e-4)
    np.testing.assert_allclose([float(o[1]) for o in outs],
                               [float(o[1]) for o in ref_outs])
    _close_all(grads, ref_grads, rtol=1e-4, atol_frac=1e-4)


def test_lenet_sgd_step_weights_match_reference():
    """One SGD step from one init: every weight within rtol 1e-5."""
    feeds = _digits(32, seed=1, steps=1)
    init, _, _, ref_final = _reference(_lenet, feeds, optimizer="sgd")
    _, _, final, _ = _port(_lenet, init, feeds, optimizer="sgd")
    _close_all(final, ref_final, rtol=1e-5, atol_frac=1e-7)


def test_lenet_kernel_tier_matches_plain_program(lenet_reference):
    """The kernel tier buckets LeNet's eight Adam updates into one
    fused_adam; on the CPU it takes the plain version, bit for bit the
    per-param updates."""
    feeds, init, _, _ = lenet_reference
    rewrites = ttrace.metrics().counter("kernel_tier.fuse_optimizer.rewrites")
    before = rewrites.value
    tier_outs, _, tier_final, tier_main = _port(_lenet, init, feeds,
                                                kernel_tier=True)
    assert rewrites.value - before == 1
    types = [op.type for op in tier_main.global_block().ops]
    assert types.count("fused_adam") == 1 and "adam" not in types
    outs, _, final, _ = _port(_lenet, init, feeds)
    for a, b in zip(tier_outs, outs):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    for n in final:
        assert np.array_equal(tier_final[n], final[n]), n


def test_clip_case_kernel_tier_buckets_momentum():
    """GradientClipByGlobalNorm puts elementwise ops between the grads and
    the momentum updates; the kernel tier still makes one fused_momentum,
    bit for bit the per-param updates."""
    def build(pkg):
        x = pkg.data("x", [-1, 10])
        y = pkg.data("y", [-1, 1])
        h = pkg.layers.fc(x, 16, act="tanh")
        pred = pkg.layers.fc(h, 1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.MomentumOptimizer(
            0.05, 0.9,
            grad_clip=pkg.clip.GradientClipByGlobalNorm(1.0)).minimize(loss)
        return (loss,)

    rng = np.random.RandomState(5)
    xs = rng.randn(64, 10).astype("float32")
    feeds = [{"x": xs, "y": (xs.sum(1, keepdims=True) > 0)
              .astype("float32")}] * 3
    init, ref_outs, _, ref_final = _reference(build, feeds)
    tier_outs, _, tier_final, main = _port(build, init, feeds,
                                           kernel_tier=True)
    types = [op.type for op in main.global_block().ops]
    assert types.count("fused_momentum") == 1 and "momentum" not in types
    outs, _, final, _ = _port(build, init, feeds)
    for n in final:
        assert np.array_equal(tier_final[n], final[n]), n
    np.testing.assert_allclose([float(o[0]) for o in outs],
                               [float(o[0]) for o in ref_outs], rtol=1e-4)
    _close_all(final, ref_final, rtol=1e-4, atol_frac=1e-5)


# ---------------------------------------------------------------------------
# shape bucketing: padded rows masked out
# ---------------------------------------------------------------------------

BUCKET_TOL = dict(rtol=1e-4, atol=1e-5)


def _ragged(sizes, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(sum(sizes), 32).astype("float32")
    Y = rng.randint(0, 10, (sum(sizes), 1)).astype("int64")
    feeds, off = [], 0
    for n in sizes:
        feeds.append({"x": X[off:off + n], "y": Y[off:off + n]})
        off += n
    return feeds


@pytest.mark.parametrize("bn,sizes", [(False, [32, 32, 32, 7]),
                                      (True, [32, 32, 5])],
                         ids=["ragged_tail", "batch_norm_stats"])
def test_bucketed_mlp_matches_unpadded_and_reference(bn, sizes):
    """The ragged tail padded to its power-of-two bucket: losses, the
    per-row fetch's true row count, every parameter and the batch-norm
    moving statistics match the unpadded run and the reference's padded
    run."""
    feeds = _ragged(sizes)
    init, ref_outs, _, ref_final = _reference(_mlp, feeds, bucketing=True,
                                              bn=bn)
    padded, _, p_final, _ = _port(_mlp, init, feeds, bucketing=True, bn=bn)
    plain, _, u_final, _ = _port(_mlp, init, feeds, bn=bn)
    assert [len(o[1]) for o in padded] == sizes
    for got, want in ((padded, plain), (padded, ref_outs)):
        np.testing.assert_allclose([float(o[0]) for o in got],
                                   [float(o[0]) for o in want],
                                   **BUCKET_TOL)
    for want in (u_final, ref_final):
        assert set(p_final) == set(want)
        for k in want:
            np.testing.assert_allclose(p_final[k], want[k], **BUCKET_TOL,
                                       err_msg=k)
    if bn:
        assert any("batch_norm" in k for k in p_final)


@pytest.mark.parametrize("bn", [False, True], ids=["lenet", "lenet_bn"])
def test_bucketed_lenet_matches_unpadded(bn):
    """LeNet (and its batch-norm variant) on 10 rows padded to 16 against
    the unpadded 10-row steps, moving statistics included."""
    feeds = _digits(10, seed=3, steps=2)
    init, _, _, _ = _reference(_lenet, feeds[:0], bn=bn)
    padded, _, p_final, _ = _port(_lenet, init, feeds, bucketing=True,
                                  bn=bn)
    plain, _, u_final, _ = _port(_lenet, init, feeds, bn=bn)
    for a, b in zip(padded, plain):
        np.testing.assert_allclose(a[0], b[0], **BUCKET_TOL)
        np.testing.assert_allclose(a[1], b[1], **BUCKET_TOL)
    for k in u_final:
        np.testing.assert_allclose(p_final[k], u_final[k], **BUCKET_TOL,
                                   err_msg=k)


def _metrics_program(pkg):
    """accuracy and a normalized sigmoid loss over a padded batch
    (tests/test_shape_bucketing.py's accuracy case)."""
    x = pkg.data("x", [-1, 8])
    y = pkg.data("y", [-1, 1], dtype="int64")
    logits = pkg.layers.fc(x, 4)
    acc = pkg.layers.accuracy(pkg.layers.softmax(logits), y)
    onehot = pkg.layers.cast(pkg.layers.one_hot(y, 4), "float32")
    sce = pkg.layers.reduce_sum(
        pkg.layers.sigmoid_cross_entropy_with_logits(logits, onehot,
                                                     normalize=True))
    return acc, sce


def test_accuracy_and_sigmoid_loss_mask_padded_rows():
    rng = np.random.RandomState(11)
    feeds = [{"x": rng.randn(7, 8).astype("float32"),
              "y": rng.randint(0, 4, (7, 1)).astype("int64")}]
    init, ref_outs, _, _ = _reference(_metrics_program, feeds,
                                      bucketing=True)
    padded, _, _, _ = _port(_metrics_program, init, feeds, bucketing=True)
    plain, _, _, _ = _port(_metrics_program, init, feeds)
    for got in (plain, ref_outs):
        np.testing.assert_allclose(np.ravel(padded[0][0]),
                                   np.ravel(got[0][0]), rtol=1e-6)
        np.testing.assert_allclose(np.ravel(padded[0][1]),
                                   np.ravel(got[0][1]), rtol=1e-5)


def test_param_dim0_aliasing_bucket_not_masked():
    """A parameter whose dim 0 equals the bucket (an 8x8 fc weight, 7 rows
    padded to 8) is neither masked in a reduction nor sliced when
    fetched."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.data("x", [-1, 8])
        h = tfluid.layers.fc(x, 8)
        w = [p for p in main.all_parameters()
             if tuple(p.shape) == (8, 8)][0]
        reg = tfluid.layers.reduce_mean(w * w)
        loss = tfluid.layers.mean(h) + reg
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    xv = -np.abs(np.random.RandomState(13).randn(7, 8)).astype("float32")
    l0, w0 = exe.run(main, feed={"x": xv}, fetch_list=[loss, w],
                     scope=scope)
    main._hints["shape_bucketing"] = True
    l1, w1 = exe.run(main, feed={"x": xv}, fetch_list=[loss, w],
                     scope=scope)
    np.testing.assert_allclose(np.ravel(l0), np.ravel(l1), rtol=1e-6)
    assert np.asarray(w1).shape == (8, 8), "persistable fetch sliced"
    np.testing.assert_allclose(w0, w1)


# ---------------------------------------------------------------------------
# save and load, the scope, the plan cache
# ---------------------------------------------------------------------------

def _fc_net(pkg, size=4):
    x = pkg.data("x", [-1, 8])
    loss = pkg.layers.mean(pkg.layers.fc(x, size))
    pkg.optimizer.SGDOptimizer(0.1).minimize(loss)
    return (loss,)


def _trained_port_net(size=4):
    main, startup, (loss,) = _build(tfluid, _fc_net, size=size)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    exe.run(main, feed={"x": np.ones((4, 8), "float32")}, fetch_list=[loss])
    return main, exe


def test_port_archive_loads_in_reference(tmp_path):
    main, exe = _trained_port_net()
    tfluid.save_persistables(exe, str(tmp_path), main)
    want = interop.scope_to_numpy(tfluid.global_scope(),
                                  tfluid.global_scope().local_var_names())
    jmain, _, _ = _build(jfluid, _fc_net)
    with scope_guard(JScope()):
        jfluid.load_persistables(jfluid.Executor(), str(tmp_path), jmain)
        got = _persistables(jmain, jfluid.global_scope())
    assert set(got) == set(want) and got
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_reference_archive_loads_in_port(tmp_path):
    jmain, jstartup, (jloss,) = _build(jfluid, _fc_net)
    with scope_guard(JScope()):
        jexe = jfluid.Executor()
        jexe.run(jstartup)
        jexe.run(jmain, feed={"x": np.ones((4, 8), "float32")},
                 fetch_list=[jloss])
        jfluid.save_persistables(jexe, str(tmp_path), jmain)
        want = _persistables(jmain, jfluid.global_scope())
    main, _, _ = _build(tfluid, _fc_net)
    tfluid.load_persistables(tfluid.Executor(tfluid.CPUPlace()),
                             str(tmp_path), main)
    got = interop.scope_to_numpy(tfluid.global_scope(), list(want))
    assert set(got) == set(want) and got
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
        assert isinstance(tfluid.global_scope().find_var(n), torch.Tensor)


def test_strict_load_names_missing_and_mismatched_vars(tmp_path):
    main, exe = _trained_port_net(size=4)
    tfluid.save_persistables(exe, str(tmp_path), main)
    wider, _, _ = _build(tfluid, _fc_net, size=5)     # same names, fc 8x5
    with pytest.raises(ValueError, match=r"fc\.w_0: archive shape \[8, 4\] "
                                         r"!= var shape \[8, 5\]"):
        tfluid.load_vars(exe, str(tmp_path), wider, strict=True)
    with pytest.raises(ValueError, match="Missing vars: extra_var"):
        tfluid.load_vars(exe, str(tmp_path), main,
                         vars=["fc.w_0", "extra_var"], strict=True)
    tfluid.load_vars(exe, str(tmp_path), main, strict=True)   # satisfied


def test_scope_erase_local_names_and_child_scope():
    scope = tfluid.Scope()
    scope.set_var("a", torch.ones(2))
    scope.set_var("b", torch.zeros(3))
    assert scope.local_var_names() == ["a", "b"]
    child = scope.new_scope()
    child.set_var("c", torch.ones(1))
    assert child.local_var_names() == ["c"]
    assert child.find_var("a") is scope.find_var("a")
    assert child.parent is scope and scope.find_var("c") is None
    scope.erase("a")
    scope.erase("missing")
    assert scope.local_var_names() == ["b"] and child.find_var("a") is None


def test_run_without_program_cache_leaves_plans_alone():
    main, startup, (loss,) = _build(tfluid, _fc_net)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    test_prog = main.clone(for_test=True)
    feed = {"x": np.random.RandomState(2).randn(3, 8).astype("float32")}
    uncached, = exe.run(test_prog, feed=feed, fetch_list=[loss],
                        use_program_cache=False)
    assert not any(k[0] == id(test_prog) for k in exe._plans)
    cached, = exe.run(test_prog, feed=feed, fetch_list=[loss])
    plans = list(exe._plans)
    again, = exe.run(test_prog, feed=feed, fetch_list=[loss],
                     use_program_cache=False)
    assert list(exe._plans) == plans
    np.testing.assert_array_equal(uncached, cached)
    np.testing.assert_array_equal(again, cached)
