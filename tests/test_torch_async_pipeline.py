"""The async step window of paddle_tpu_torch, held to the reference's
contract (``tests/test_async_pipeline.py``): ``FetchHandle``
materialisation, the bounded window's backpressure, dispatch errors on
their own future, and windowed steps against the sync loop, on the CPU.
The reference's donation-alias guard has no counterpart: no
state-writing lowering of the port writes a scope tensor in place, which
``TestAliasGuard`` holds, so a lazy fetch of state keeps its step's
value.  The reference's ``steps_per_dispatch=K``
(a ``lax.scan`` of K steps) has no port yet and must raise, not degrade.

Values are compared exactly: a windowed loop runs the same ops on the
same tensors as the sync loop.  Parity with the reference itself: the
lazy losses of an MLP trained from the reference's weights within
rtol 1e-5.
"""
import threading
import time
import types

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import core as jcore
from paddle_tpu.fluid.framework import reset_unique_name as j_reset

import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.distributed.ps import box as tbox
from paddle_tpu_torch.fluid import core, trace
from paddle_tpu_torch.fluid.async_pipeline import (AsyncStepRunner,
                                                   FetchHandle, StepFuture)
from paddle_tpu_torch.fluid.framework import reset_unique_name
from paddle_tpu_torch.models.static_graphs import (build_ctr_train_program,
                                                   ctr_demo_feed)

HOST = fluid.CPUPlace()


def _build_mlp(pkg=fluid, reset=reset_unique_name, lr=0.1, opt="SGD"):
    reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.data("x", [-1, 16])
        y = pkg.data("y", [-1, 1], dtype="int64")
        h = pkg.layers.fc(x, 32, act="relu")
        logits = pkg.layers.fc(h, 10)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        getattr(pkg.optimizer, opt + "Optimizer")(
            lr, **({"momentum": 0.9} if opt == "Momentum" else {})
        ).minimize(loss)
    return main, startup, loss


def _feeds(n, batch=8, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(batch, 16).astype("float32"),
             "y": rng.randint(0, 10, (batch, 1)).astype("int64")}
            for _ in range(n)]


def _params(scope, program):
    return {p.name: scope.find_var(p.name).numpy()
            for p in program.all_parameters()}


def _started(main, startup):
    scope = core.Scope()
    exe = fluid.Executor(HOST)
    exe.run(startup, scope=scope)
    return exe, scope


def _sync_run(feeds):
    main, startup, loss = _build_mlp()
    exe, scope = _started(main, startup)
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in feeds]
    return losses, _params(scope, main)


class TestFetchHandle:
    def test_materialisation_protocols(self):
        h = FetchHandle(np.arange(6, dtype="float32").reshape(2, 3),
                        name="t")
        assert h.shape == (2, 3) and h.dtype == np.float32 and h.ndim == 2
        assert not h.is_materialized()
        assert float(FetchHandle(np.float32(2.5))) == 2.5
        assert int(FetchHandle(np.int64(7))) == 7
        np.testing.assert_array_equal(np.asarray(h),
                                      np.arange(6).reshape(2, 3))
        assert h.is_materialized()
        assert h.numpy() is h.persist()

    def test_torch_tensor_handle(self):
        import torch
        h = FetchHandle(torch.arange(4, dtype=torch.float32), name="t")
        assert h.shape == (4,) and h.dtype == np.float32
        assert h.raw.dtype == torch.float32
        np.testing.assert_array_equal(h.numpy(), [0, 1, 2, 3])
        assert isinstance(h.raw, np.ndarray)     # host copy cached


class TestLazyFetchesFromRun:
    def test_return_numpy_false_yields_handles(self):
        main, startup, loss = _build_mlp()
        exe, scope = _started(main, startup)
        lazy = exe.run(main, feed=_feeds(1)[0], fetch_list=[loss],
                       scope=scope, return_numpy=False)
        assert isinstance(lazy[0], FetchHandle)
        assert lazy[0].name == loss.name
        assert lazy[0]._event is None          # host tensors: no event

    def test_lazy_values_match_sync(self):
        feeds = _feeds(4)
        sync_losses, _ = _sync_run(feeds)
        main, startup, loss = _build_mlp()
        exe, scope = _started(main, startup)
        lazy = [float(exe.run(main, feed=f, fetch_list=[loss], scope=scope,
                              return_numpy=False)[0]) for f in feeds]
        assert lazy == sync_losses

    def test_lazy_losses_match_the_reference(self):
        """The MLP from the reference's weights: its sync losses against
        the port's lazy ones, rtol 1e-5."""
        feeds = _feeds(4, seed=7)
        main, startup, loss = _build_mlp(jfluid, j_reset)
        with jcore.scope_guard(jcore.Scope()):
            exe = jfluid.Executor()
            exe.run(startup)
            scope = jcore.global_scope()
            init = {p.name: np.asarray(scope.find_var(p.name))
                    for p in main.all_parameters()}
            want = [float(np.ravel(exe.run(main, feed=f,
                                           fetch_list=[loss])[0])[0])
                    for f in feeds]
        main, startup, loss = _build_mlp()
        exe, scope = _started(main, startup)
        interop.scope_from_numpy(init, scope, HOST)
        got = [float(exe.run(main, feed=f, fetch_list=[loss], scope=scope,
                             return_numpy=False)[0]) for f in feeds]
        np.testing.assert_allclose(got, want, rtol=1e-5)


class _FakeDeviceRunner(AsyncStepRunner):
    """Runner whose 'device' is a background thread completing one step
    every ``step_time`` seconds, each handle's event its step's
    completion: the backpressure contract without any device timing."""

    def __init__(self, max_inflight, step_time=0.02):
        prog = types.SimpleNamespace(_hints={})
        super().__init__(executor=None, program=prog, fetch_list=["v"],
                         max_inflight=max_inflight, steps_per_dispatch=1)
        self.step_time = step_time
        self.outstanding = 0
        self.peak = 0
        self._lock = threading.Lock()

    def _dispatch_feeds(self, feeds):
        with self._lock:
            self.outstanding += 1
            self.peak = max(self.peak, self.outstanding)
        done = threading.Event()

        def complete():
            time.sleep(self.step_time)
            with self._lock:
                self.outstanding -= 1
            done.set()
        threading.Thread(target=complete, daemon=True).start()
        event = types.SimpleNamespace(synchronize=done.wait)
        return [[FetchHandle(np.zeros(1), event=event)] for _ in feeds]


class TestBackpressure:
    def test_window_bounds_outstanding_steps(self):
        r = _FakeDeviceRunner(max_inflight=2)
        futs = [r.submit({"i": i}) for i in range(8)]
        r.drain()
        assert r.peak <= 2
        assert all(f.dispatched for f in futs)

    def test_window_of_one_serialises(self):
        r = _FakeDeviceRunner(max_inflight=1)
        for i in range(5):
            r.submit({"i": i})
        r.drain()
        assert r.peak <= 1

    def test_host_wait_and_dispatch_metrics_recorded(self):
        m = trace.metrics()
        hw0 = m.histogram("executor.host_wait_seconds").stats()["count"]
        dp0 = m.histogram("executor.dispatch_seconds").stats()["count"]
        r = _FakeDeviceRunner(max_inflight=2)
        for i in range(6):
            r.submit({"i": i})
        r.drain()
        assert m.histogram("executor.dispatch_seconds").stats()["count"] \
            - dp0 == 6
        assert m.histogram("executor.host_wait_seconds").stats()["count"] \
            - hw0 == 6
        assert m.gauge("executor.inflight_peak").value >= 2

    def test_default_window_is_the_flag(self):
        assert core.get_flag("max_inflight_steps") == 2
        r = _FakeDeviceRunner(max_inflight=None)
        assert r.max_inflight == 2


class TestDispatchErrors:
    def test_error_surfaces_on_its_own_future(self):
        main, startup, loss = _build_mlp()
        exe, scope = _started(main, startup)
        r = AsyncStepRunner(exe, main, [loss], scope=scope, max_inflight=2)
        good = _feeds(3)
        f0 = r.submit(good[0])
        f_bad = r.submit({"nonsense": np.zeros((2, 2), "float32")})
        f2 = r.submit(good[1])
        assert np.isfinite(float(f0[0]))
        with pytest.raises(KeyError):
            f_bad.handles()
        assert np.isfinite(float(f2[0]))
        r.drain()

    def test_unconsumed_error_raises_on_drain(self):
        main, startup, loss = _build_mlp()
        exe, scope = _started(main, startup)
        r = AsyncStepRunner(exe, main, [loss], scope=scope, max_inflight=2)
        r.submit({"nonsense": np.zeros((2, 2), "float32")})
        with pytest.raises(KeyError):
            r.drain()
        r.drain()               # consumed: a second drain is clean

    def test_abort_drops_nothing_dispatched_and_never_raises(self):
        main, startup, loss = _build_mlp()
        exe, scope = _started(main, startup)
        r = AsyncStepRunner(exe, main, [loss], scope=scope)
        r.submit({"nonsense": np.zeros((2, 2), "float32")})
        r.submit(_feeds(1)[0])
        r.abort()
        assert r.inflight == 0 and r.pending == 0
        r.drain()


def _state_step(kind):
    """A small train program whose step runs ``kind``, a lowering that
    writes persistable state: (program to run, main, feed, fetch list,
    scope), started on the host."""
    rng = np.random.RandomState(11)
    bs = None
    reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    if kind in ("sgd", "momentum", "adam"):
        main, startup, loss = _build_mlp(
            opt={"sgd": "SGD", "momentum": "Momentum", "adam": "Adam"}[kind])
        feed = _feeds(1)[0]
    elif kind in ("fused_adam", "fused_momentum"):
        main, startup, loss = build_ctr_train_program(
            slots=2, optimizer=kind.removeprefix("fused_"))
        feed = ctr_demo_feed(rng, batch=8, slots=2)
        bs = fluid.BuildStrategy()
        bs.kernel_tier = True
    elif kind in ("batch_norm", "fused_bn_activation"):
        with fluid.program_guard(main, startup):
            x = fluid.data("img", [-1, 3, 6, 6])
            h = fluid.layers.conv2d(x, 4, 3)
            h = fluid.layers.batch_norm(h, act="relu")
            loss = fluid.layers.mean(h)
            fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
        feed = {"img": rng.randn(4, 3, 6, 6).astype("float32")}
        if kind == "fused_bn_activation":
            bs = fluid.BuildStrategy()
            bs.fuse_bn_act_ops = True
    else:                                           # pull_box_sparse
        tbox.reset_box_wrappers()
        with fluid.program_guard(main, startup):
            ids = fluid.data("ids", [-1, 2], dtype="int64")
            label = fluid.data("label", [-1, 1])
            box = tbox.get_box_wrapper("t_inplace", dim=4,
                                       init_kind="gaussian", init_scale=0.1)
            emb = fluid.layers.pull_box_sparse(ids, 4,
                                               table_name="t_inplace")
            pred = fluid.layers.fc(fluid.layers.reshape(emb, [-1, 8]), 1)
            loss = fluid.layers.mean(
                fluid.layers.square_error_cost(pred, label))
            fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
        raw = rng.randint(0, 2 ** 40, (8, 2), dtype=np.int64)
        raw[4:] = raw[:4]                           # repeated ids
        cache = box.begin_pass(raw)
        feed = {"ids": box.slots_of(raw.reshape(-1)).reshape(8, 2),
                "label": rng.rand(8, 1).astype("float32")}
    exe, scope = _started(main, startup)
    if kind == "pull_box_sparse":
        scope.set_var("t_inplace@HBMCACHE", cache)
    prog = main if bs is None else fluid.CompiledProgram(main,
                                                         build_strategy=bs)
    return exe, prog, main, feed, [loss], scope


class TestAliasGuard:
    """The reference persists lazy fetches of donated buffers before the
    next dispatch.  The port's guard is that no lowering writes state in
    place: each written persistable is rebound to a new tensor, and the
    tensor a handle holds keeps its step's value."""

    @pytest.mark.parametrize("kind", (
        "sgd", "momentum", "adam", "fused_adam", "fused_momentum",
        "batch_norm", "fused_bn_activation", "pull_box_sparse"))
    def test_no_lowering_writes_a_persistable_in_place(self, kind):
        exe, prog, main, feed, fetch, scope = _state_step(kind)
        # the first run seeds host values (the box cache) onto the device
        exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
        assert kind in [op.type for op in main.global_block().ops]
        names = [n for n, v in main.global_block().vars.items()
                 if v.persistable and isinstance(scope.find_var(n),
                                                 torch.Tensor)]
        before = {n: scope.find_var(n) for n in names}
        copies = {n: t.clone() for n, t in before.items()}
        for _ in range(2):
            exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
        for n in names:
            assert torch.equal(before[n], copies[n]), n
        written = [n for n in names if scope.find_var(n) is not before[n]]
        assert written and any(not torch.equal(scope.find_var(n), copies[n])
                               for n in written)
        tbox.reset_box_wrappers()

    def test_guarded_window_matches_sync_loop(self):
        """A window that fetches a parameter its update writes equals the
        sync loop bit for bit, with no guard."""
        def build():
            reset_unique_name()
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup):
                x = fluid.data("x", [-1, 4])
                h = fluid.layers.fc(x, 4)
                loss = fluid.layers.mean(h)
                fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
            return main, startup, loss, main.all_parameters()[0].name

        rng = np.random.RandomState(1)
        feeds = [{"x": rng.randn(4, 4).astype("float32")}
                 for _ in range(7)]
        main, startup, loss, w = build()
        exe, scope = _started(main, startup)
        sync = [exe.run(main, feed=f, fetch_list=[loss, w], scope=scope)
                for f in feeds]
        main, startup, loss, w = build()
        exe, scope = _started(main, startup)
        r = AsyncStepRunner(exe, main, [loss, w], scope=scope,
                            max_inflight=3)
        futs = [r.submit(f) for f in feeds]
        r.drain()
        got = [f.result() for f in futs]
        for (sl, sw), (gl, gw) in zip(sync, got):
            np.testing.assert_array_equal(sl, gl)
            np.testing.assert_array_equal(sw, gw)


class TestAsyncParity:
    def test_inflight_window_bit_identical_to_sync(self):
        feeds = _feeds(10, seed=3)
        sync_losses, sync_params = _sync_run(feeds)
        main, startup, loss = _build_mlp()
        exe, scope = _started(main, startup)
        r = AsyncStepRunner(exe, main, [loss], scope=scope, max_inflight=3)
        futs = [r.submit(f) for f in feeds]
        r.drain()
        assert [float(f[0]) for f in futs] == sync_losses
        for k, v in _params(scope, main).items():
            np.testing.assert_array_equal(sync_params[k], v)

    def test_run_async_api_and_drain(self):
        feeds = _feeds(5, seed=4)
        sync_losses, _ = _sync_run(feeds)
        main, startup, loss = _build_mlp()
        exe, scope = _started(main, startup)
        futs = [exe.run_async(main, feed=f, fetch_list=[loss], scope=scope)
                for f in feeds]
        assert all(isinstance(f, StepFuture) for f in futs)
        exe.drain_async()
        assert [float(f[0]) for f in futs] == sync_losses
        exe.close()             # drains again without error

    def test_lazy_view_reads_without_forcing(self):
        feeds = _feeds(3, seed=5)
        sync_losses, _ = _sync_run(feeds)
        main, startup, loss = _build_mlp()
        exe, scope = _started(main, startup)
        r = AsyncStepRunner(exe, main, [loss], scope=scope)
        lazy = [r.submit(f).lazy(0) for f in feeds]
        r.drain()
        assert [float(x) for x in lazy] == sync_losses


@pytest.mark.parametrize("how", ("argument", "hint", "flag"))
def test_steps_per_dispatch_above_one_raises(how):
    main, startup, loss = _build_mlp()
    exe, scope = _started(main, startup)
    kw = {}
    if how == "argument":
        kw["steps_per_dispatch"] = 2
    elif how == "hint":
        main._hints["steps_per_dispatch"] = 2
    else:
        core.set_flags({"FLAGS_steps_per_dispatch": 2})
    try:
        with pytest.raises(NotImplementedError, match="queue A item 2"):
            AsyncStepRunner(exe, main, [loss], scope=scope, **kw)
        with pytest.raises(NotImplementedError):
            exe.run_async(main, feed=_feeds(1)[0], fetch_list=[loss],
                          scope=scope, **kw)
    finally:
        core.set_flags({"FLAGS_steps_per_dispatch": 1})
        main._hints.pop("steps_per_dispatch", None)
    assert AsyncStepRunner(exe, main, [loss]).steps_per_dispatch == 1
