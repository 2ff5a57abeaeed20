"""The BoxPS CTR slice: paddle_tpu_torch against paddle_tpu.

The four PS ops (``pull_box_sparse``, ``push_box_sparse``,
``pull_sparse``, ``push_dense``) run the same numpy inputs through the
JAX lowering and the port's, forward and through ``generic_grad``.  The
BoxPS wrapper's pass lifecycle, and its caches against the reference's
from one seed (the numpy initializer draws the same rows in the same
order in both packages) and after ``interop.box_from_numpy`` carries a
state across.  The reference's ``tests/test_box_ps.py`` programs trained
by ``Executor.train_from_dataset`` in both packages from one state, box
against a dense embedding in the port, pipelined passes
(``train_passes``) against the serial loop in the port, and
``BoxPSOptimizer``.  Then ``bench.py:547 main_ctr``'s program at its
``--quick`` width (6 slots, dim 8, batch 64) through both of its legs
(``fuse_elewise_add_act_ops`` + ``constant_folding``, then
``BuildStrategy.amp``) in both packages: op streams, ``ops_per_step``
and the amp cast count equal.  Last, the executor's repairs this path
needs: a numpy scope value reaches the device once, and ``close()``
drains the open ``run_async`` windows.

Tolerances: op values rtol=atol=1e-5 (the libraries sum in different
orders); losses across packages rtol 1e-5 (``tests/test_box_ps.py:146``'s
bound); caches and host rows from one seed exactly; pipelined against
serial in the port bit for bit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu.distributed.ps import box as jbox
from paddle_tpu.fluid import trace as jtrace
from paddle_tpu.fluid.core import global_scope as j_global_scope
from paddle_tpu.fluid.framework import prune_ops as j_prune
from paddle_tpu.fluid.framework import reset_unique_name as j_reset
from paddle_tpu.fluid.initializer import ConstantInitializer as JConst
from paddle_tpu.fluid.param_attr import ParamAttr as JParamAttr
from paddle_tpu.ops import registry as jreg

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.distributed import trainer as ttrainer
from paddle_tpu_torch.distributed.ps import box as tbox
from paddle_tpu_torch.fluid import trace as ttrace
from paddle_tpu_torch.fluid.core import global_scope as t_global_scope
from paddle_tpu_torch.fluid.executor import Executor as TExecutor
from paddle_tpu_torch.fluid.framework import prune_ops as t_prune
from paddle_tpu_torch.fluid.framework import reset_unique_name as t_reset
from paddle_tpu_torch.fluid.initializer import ConstantInitializer as TConst
from paddle_tpu_torch.fluid.param_attr import ParamAttr as TParamAttr
from paddle_tpu_torch.ops import registry as treg

HOST = tfluid.CPUPlace()
TOL = dict(rtol=1e-5, atol=1e-5)
R = np.random.RandomState(41)

PKG = {
    "ref": dict(fluid=jfluid, box=jbox, reset=j_reset, prune=j_prune,
                trace=jtrace, scope=j_global_scope, ParamAttr=JParamAttr,
                Const=JConst),
    "port": dict(fluid=tfluid, box=tbox, reset=t_reset, prune=t_prune,
                 trace=ttrace, scope=t_global_scope, ParamAttr=TParamAttr,
                 Const=TConst),
}


@pytest.fixture(autouse=True)
def _clean_registries():
    jbox.reset_box_wrappers()
    tbox.reset_box_wrappers()
    yield
    jbox.reset_box_wrappers()
    tbox.reset_box_wrappers()


def _place(name):
    return PKG[name]["fluid"].CPUPlace()


# -- 1. the ops ---------------------------------------------------------------
def _f(*shape):
    return np.asarray(R.randn(*shape), "float32")


def _run_op(op_type, ins, attrs):
    j = jreg.get_op(op_type).fn(
        {s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
        dict(attrs), jreg.LoweringContext())
    t = treg.get_op(op_type).fn(
        {s: [torch.from_numpy(np.array(a)) for a in v]
         for s, v in ins.items()}, dict(attrs), treg.LoweringContext())
    assert set(j) == set(t), op_type
    for slot in j:
        assert len(j[slot]) == len(t[slot])
        for a, b in zip(j[slot], t[slot]):
            a, b = np.asarray(a), b.numpy()
            assert a.shape == b.shape, (op_type, slot)
            np.testing.assert_allclose(b, a, **TOL,
                                       err_msg=f"{op_type}.{slot}")


def _ids(*shape, high=12):
    return R.randint(0, high, shape).astype("int64")


OPS = {
    "pull_box_sparse": ({"W": [_f(12, 4)],
                         "Ids": [_ids(5, 3), _ids(7)]}, {"size": 4}),
    "pull_sparse": ({"W": [_f(12, 4)], "Ids": [_ids(6, 2)]}, {}),
    "push_box_sparse": ({"W": [_f(12, 4)], "Ids": [_ids(9), _ids(3)],
                         "Grad": [_f(9, 4), _f(3, 4)]}, {}),
    "push_dense": ({"Ids": [_f(3, 4), _f(2)]}, {}),
}


@pytest.mark.parametrize("op_type", sorted(OPS))
def test_ps_op_forward_matches_reference(op_type):
    ins, attrs = OPS[op_type]
    _run_op(op_type, ins, attrs)


@pytest.mark.parametrize("op_type", ("pull_box_sparse", "pull_sparse"))
def test_ps_pull_gradient_matches_reference(op_type):
    """generic_grad's dW: a scatter-add of every position's cotangent
    (duplicate ids sum) into a dense zero table."""
    ins, attrs = OPS[op_type]
    g = {"I_" + s: v for s, v in ins.items()}
    g["G_Out"] = [_f(*ids.shape, 4) for ids in ins["Ids"]]
    _run_op("generic_grad", g,
            {"fwd_type": op_type, "fwd_attrs": dict(attrs),
             "in_slots": list(ins), "grad_slots": ["W"]})


# -- 2. the wrapper -------------------------------------------------------------
def test_pass_lifecycle_roundtrip_with_a_tensor_cache():
    box = tbox.BoxPSWrapper(4, init_kind="zeros")
    ids = np.array([7, 3, 7, 2**40 + 5], np.int64)   # 64-bit id space
    cache = box.begin_pass(ids)
    assert cache.shape == (4, 4)            # 3 unique -> pow2 pad
    assert box.pass_size == 3
    slots = box.slots_of(np.array([3, 7, 2**40 + 5], np.int64))
    assert sorted(slots.tolist()) == [0, 1, 2]
    assert slots.dtype == np.int64
    trained = torch.from_numpy(cache.copy())
    trained[int(slots[1])] = torch.tensor([1., 2., 3., 4.])
    box.end_pass(trained)                    # a torch tensor, as trained
    assert box.host_rows() == 3
    assert box.pass_size == 0 and box.cache_rows == 0
    cache2 = box.begin_pass(np.array([7], np.int64))
    np.testing.assert_array_equal(cache2[0], [1, 2, 3, 4])


def test_unknown_id_raises_and_sharded_is_not_ported():
    box = tbox.BoxPSWrapper(2, init_kind="zeros")
    with pytest.raises(RuntimeError):
        box.slots_of(np.array([1], np.int64))
    box.begin_pass(np.array([1, 2, 3], np.int64))
    with pytest.raises(KeyError):
        box.slots_of(np.array([4], np.int64))
    with pytest.raises(NotImplementedError):
        tbox.BoxPSWrapper.sharded(4)
    with pytest.raises(ValueError):
        tbox.get_box_wrapper("t_dim", dim=4)
        tbox.get_box_wrapper("t_dim", dim=8)


def test_host_exceeds_any_cache():
    box = tbox.BoxPSWrapper(8, init_kind="gaussian")
    rng = np.random.RandomState(0)
    total = set()
    for _ in range(6):
        ids = rng.randint(0, 2**40, 500).astype(np.int64)
        cache = box.begin_pass(ids)
        assert cache.shape[0] <= 512
        box.end_pass(cache)
        total.update(np.unique(ids).tolist())
    assert box.host_rows() == len(total) > 2500


def _passes(seed=4):
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, 2**40, 40).astype(np.int64)
    return [np.concatenate([shared[i * 10:i * 10 + 30],
                            rng.randint(0, 2**40, 50).astype(np.int64)])
            for i in range(3)]


@pytest.mark.parametrize("route", ("same seed", "carried state"))
def test_cache_equals_the_reference_from_one_seed(route):
    """Three passes sharing ids, each "trained" by adding the pass index:
    every cache the port stages is ``np.array_equal`` to the
    reference's.  "carried state" starts the port from the reference's
    state after pass 1 (``interop.box_from_numpy``: host rows, the
    initializer's RandomState, the open pass)."""
    kw = dict(init_kind="gaussian", init_scale=0.01, seed=3)
    jb, tb = jbox.BoxPSWrapper(8, **kw), tbox.BoxPSWrapper(8, **kw)
    for i, ids in enumerate(_passes()):
        jc = jb.begin_pass(ids)
        if i == 1 and route == "carried state":
            tb = tbox.BoxPSWrapper(8, **kw)
            host = np.array(sorted(jb.host._slot_of), np.int64)
            interop.box_from_numpy(
                tb, host, jb.host.pull(host), pass_ids=jb._pass_ids,
                cache_rows=jb.cache_rows,
                rng_state=jb.host.init.rng.get_state())
            tc = jc.copy()
        else:
            tc = tb.begin_pass(ids)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tb.slots_of(ids), jb.slots_of(ids))
        jb.end_pass(jc + i)
        tb.end_pass(torch.from_numpy(tc + i))
    got, want = interop.box_to_numpy(tb), jb.host
    np.testing.assert_array_equal(got["host_ids"],
                                  np.array(sorted(want._slot_of), np.int64))
    np.testing.assert_array_equal(got["host_vals"],
                                  want.pull(got["host_ids"]))


def test_table_matches_the_reference_and_files_cross(tmp_path):
    """The value store from one seed: pulls (rows created in id order),
    sgd pushes with repeated ids, ``set_rows``; then each package loads
    the other's ``save``, bit for bit."""
    from paddle_tpu.distributed.ps.table import CommonSparseTable as JT
    from paddle_tpu.distributed.ps.table import Initializer as JI
    from paddle_tpu_torch.distributed.ps.table import CommonSparseTable
    from paddle_tpu_torch.distributed.ps.table import Initializer
    j = JT(4, "sgd", 0.1, initializer=JI("gaussian", 0.1, 5))
    t = CommonSparseTable(4, "sgd", 0.1, initializer=Initializer(
        "gaussian", 0.1, 5))
    ids = np.array([5, 2**40 + 1, 9, 5], np.int64)
    g = _f(4, 4)
    for tbl in (j, t):
        tbl.pull(ids[::-1])
        tbl.push(ids, g)
        tbl.set_rows(np.array([7], np.int64), np.ones((1, 4), "float32"))
    np.testing.assert_array_equal(t.all_ids(), j.all_ids())
    np.testing.assert_array_equal(t.pull(t.all_ids()), j.pull(j.all_ids()))
    t.save(tmp_path / "port")
    j.save(tmp_path / "ref")
    u, k = CommonSparseTable(4), JT(4)
    u.load(tmp_path / "ref")
    k.load(tmp_path / "port")
    np.testing.assert_array_equal(u.pull(u.all_ids()), j.pull(j.all_ids()))
    np.testing.assert_array_equal(k.pull(k.all_ids()), t.pull(t.all_ids()))
    for tbl in (CommonSparseTable(4, "ftrl"), JT(4, "ftrl")):
        with pytest.raises(ValueError, match="unknown accessor"):
            tbl.push(ids, g)


# -- 3. programs trained from a dataset ------------------------------------------
def _write_ctr_files(tmp_path, rng, n_files=2, lines=32):
    """tests/test_box_ps.py's MultiSlot files: one id slot (ids < 50),
    four dense features, a label."""
    paths = []
    tmp_path.mkdir(parents=True, exist_ok=True)
    for i in range(n_files):
        rows = []
        for _ in range(lines):
            sid = rng.randint(0, 50)
            feat = rng.randn(4)
            label = float(feat.sum() > 0)
            rows.append("1 %d 4 %f %f %f %f 1 %f"
                        % (sid, *feat.tolist(), label))
        p = tmp_path / f"part{i}.txt"
        p.write_text("\n".join(rows) + "\n")
        paths.append(str(p))
    return paths


def _seed_fc(scope, names):
    """Numpy values into the scope, as the reference's test seeds them
    (the port's executor moves them to its device on the first run)."""
    rng = np.random.RandomState(123)
    for n in names:
        cur = scope.find_var(n)
        scope.set_var(n, (rng.randn(*np.shape(cur)) * 0.1)
                      .astype(np.float32))


def _build_box_program(pkg, table, tag, use_box=True):
    P = PKG[pkg]
    fluid = P["fluid"]
    P["reset"]()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.data(f"ids_{tag}", [-1, 1], dtype="int64")
        feat = fluid.data(f"feat_{tag}", [-1, 4])
        label = fluid.data(f"label_{tag}", [-1, 1])
        if use_box:
            P["box"].get_box_wrapper(table, dim=4, init_kind="zeros")
            emb = fluid.layers.pull_box_sparse(ids, 4, table_name=table)
        else:
            emb = fluid.layers.embedding(
                ids, [50, 4], param_attr=P["ParamAttr"](
                    name=f"{tag}_emb", initializer=P["Const"](0.0)))
        emb = fluid.layers.reshape(emb, [-1, 4])
        h = fluid.layers.concat([emb, feat], axis=1)
        pred = fluid.layers.fc(h, 1, act="sigmoid",
                               param_attr=P["ParamAttr"](name=f"{tag}_w"),
                               bias_attr=P["ParamAttr"](name=f"{tag}_b"))
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(pred, label))
        fluid.optimizer.SGDOptimizer(0.5).minimize(loss)
    exe = fluid.Executor(_place(pkg))
    exe.run(startup)
    _seed_fc(P["scope"](), [f"{tag}_w", f"{tag}_b"])
    return exe, main, loss, (ids, feat, label)


def _dataset(pkg, paths, use_vars):
    ds = PKG[pkg]["fluid"].DatasetFactory().create_dataset(
        "InMemoryDataset")
    ds.set_batch_size(8)
    ds.set_use_var(list(use_vars))
    ds.set_filelist(paths)
    ds.load_into_memory()
    return ds


def _train(pkg, tmp_path, table, tag, use_box=True, epochs=3):
    paths = _write_ctr_files(tmp_path, np.random.RandomState(5))
    exe, main, loss, uv = _build_box_program(pkg, table, tag, use_box)
    ds = _dataset(pkg, paths, uv)
    losses = []
    for _ in range(epochs):
        res = exe.train_from_dataset(main, ds, fetch_list=[loss],
                                     print_period=1000)
        losses.append(float(np.asarray(res[0][0]).ravel()[0]))
    return losses


def test_box_program_trains_as_the_reference(tmp_path):
    """Same files, same fc weights (seeded), zero-initialised box rows:
    the losses of three train_from_dataset passes within rtol 1e-5, and
    the host rows after them too."""
    ref = _train("ref", tmp_path / "r", "t_ref", "rb")
    got = _train("port", tmp_path / "p", "t_port", "pb")
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    assert got[-1] < got[0]
    jb, tb = jbox.get_box_wrapper("t_ref"), tbox.get_box_wrapper("t_port")
    assert tb.pass_size == 0 and tb.host_rows() == jb.host_rows() > 0
    ids = np.array(sorted(jb.host._slot_of), np.int64)
    np.testing.assert_allclose(tb.host.pull(ids), jb.host.pull(ids),
                               rtol=1e-5, atol=1e-6)


def test_box_matches_dense_embedding_in_the_port(tmp_path):
    dense = _train("port", tmp_path / "d", None, "dn", use_box=False)
    box = _train("port", tmp_path / "b", "t_eq", "bx", use_box=True)
    np.testing.assert_allclose(box, dense, rtol=1e-5, atol=1e-7)
    assert box[-1] < box[0]
    # the numpy weights _seed_fc put in the scope are tensors now
    assert isinstance(t_global_scope().find_var("bx_w"), torch.Tensor)


def _pass_datasets(tmp_path, use_vars, n_passes=3):
    rng = np.random.RandomState(11)
    out = []
    for p in range(n_passes):
        paths = _write_ctr_files(tmp_path / f"pass{p}", rng)
        out.append(_dataset("port", paths, use_vars))
    return out


def test_pipelined_passes_bit_identical_to_serial(tmp_path):
    """train_passes (pass N+1 staged while pass N trains; ids shared
    between passes patched from the trained values) against the serial
    begin/end loop: losses and host rows bit for bit."""
    exe, main, loss, uv = _build_box_program("port", "t_serial", "ser")
    serial = [float(np.asarray(exe.train_from_dataset(
        main, ds, fetch_list=[loss], print_period=1000)[0][0]).ravel()[0])
        for ds in _pass_datasets(tmp_path / "s", uv)]
    host_s = tbox.get_box_wrapper("t_serial").host
    ids = host_s.all_ids()
    exe2, main2, loss2, uv2 = _build_box_program("port", "t_pipe", "pipe")
    res = exe2.train_passes(main2, _pass_datasets(tmp_path / "p", uv2),
                            fetch_list=[loss2], print_period=1000)
    piped = [float(np.asarray(r[0][0]).ravel()[0]) for r in res]
    assert piped == serial
    box = tbox.get_box_wrapper("t_pipe")
    np.testing.assert_array_equal(box.host.all_ids(), ids)
    np.testing.assert_array_equal(box.host.pull(ids), host_s.pull(ids))
    assert piped[-1] < piped[0]
    stats = exe2._last_trainer_stats.as_dict()
    assert stats["steps"] == 8 and stats["total_s"] > 0


def test_trainer_refuses_the_hooks_it_lacks(tmp_path):
    exe, main, loss, uv = _build_box_program("port", "t_hooks", "hk")
    ds = _dataset("port", _write_ctr_files(tmp_path,
                                           np.random.RandomState(2)), uv)
    with pytest.raises(NotImplementedError):
        ttrainer.run_from_dataset(exe, main, ds, [loss],
                                  checkpoint_manager=object(),
                                  checkpoint_every=2)
    with pytest.raises(ValueError):
        exe.train_passes(tfluid.Program(), [ds])


def test_boxps_optimizer_minimizes_through_the_box_path():
    t_reset()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        ids = tfluid.data("ids_bpo", [-1, 2], dtype="int64")
        label = tfluid.data("label_bpo", [-1, 1])
        tbox.get_box_wrapper("t_bpo", dim=4, init_kind="zeros")
        emb = tfluid.layers.pull_box_sparse(ids, 4, table_name="t_bpo")
        pred = tfluid.layers.fc(tfluid.layers.reshape(emb, [-1, 8]), 1)
        loss = tfluid.layers.mean(
            tfluid.layers.square_error_cost(pred, label))
        tfluid.optimizer.BoxPSOptimizer(
            tfluid.optimizer.SGDOptimizer(0.1),
            cut_list=[[emb], [loss]]).minimize(loss)
    assert main._hints["boxps_pipeline"]["cuts"] == 2
    assert main._hints["box_plan"] == {"table": "t_bpo",
                                       "cache": "t_bpo@HBMCACHE",
                                       "dim": 4, "ids": ["ids_bpo"]}
    exe = tfluid.Executor(HOST)
    exe.run(startup)
    box = tbox.get_box_wrapper("t_bpo")
    idv = np.array([[1, 2], [3, 4]], np.int64)
    t_global_scope().set_var("t_bpo@HBMCACHE", box.begin_pass(idv))
    feed = {"ids_bpo": box.slots_of(idv.reshape(-1)).reshape(2, 2),
            "label_bpo": np.ones((2, 1), "float32")}
    l0, = exe.run(main, feed=feed, fetch_list=[loss])
    l1, = exe.run(main, feed=feed, fetch_list=[loss])
    box.end_pass(t_global_scope().find_var("t_bpo@HBMCACHE"))
    assert float(l1) < float(l0)



@pytest.mark.parametrize("knob", (
    dict(place_list=["cpu", "gpu"]), dict(concurrency_list=[1, 1]),
    dict(queue_size=8), dict(sync_steps=2), dict(start_cpu_core_id=4)),
    ids=lambda k: next(iter(k)))
def test_boxps_optimizer_refuses_the_section_knobs(knob):
    """The port runs no per-section thread pools: a section knob away
    from its default raises instead of being dropped."""
    with pytest.raises(NotImplementedError, match=next(iter(knob))):
        tfluid.optimizer.BoxPSOptimizer(tfluid.optimizer.SGDOptimizer(0.1),
                                        **knob)


def test_pull_box_sparse_layer_refuses_a_second_table_or_size():
    t_reset()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        ids = tfluid.data("ids_two", [-1, 2], dtype="int64")
        tfluid.layers.pull_box_sparse(ids, 4, table_name="a")
        n_ops = len(main.global_block().ops)
        with pytest.raises(ValueError):
            tfluid.layers.pull_box_sparse(ids, 4, table_name="b")
        with pytest.raises(ValueError):
            tfluid.layers.pull_box_sparse(ids, 8, table_name="a")
        assert len(main.global_block().ops) == n_ops
    w = main.global_block().var("a@HBMCACHE")
    assert w.persistable and w.shape == (-1, 4)
    assert not startup.global_block().ops    # begin_pass seeds it


# -- 4. bench.py's main_ctr program ----------------------------------------------
QUICK = dict(slots=6, dim=8, batch=64)
FULL = dict(slots=26, dim=16, batch=4096)


def _bench_program(pkg, slots, dim):
    """bench.py:571-589, built in either package."""
    P = PKG[pkg]
    fluid = P["fluid"]
    P["reset"]()
    P["box"].reset_box_wrappers()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.data("ids", [-1, slots], dtype="int64")
        dense = fluid.data("dense", [-1, 13])
        label = fluid.data("label", [-1, 1])
        box = P["box"].get_box_wrapper("bench_box", dim=dim,
                                       init_kind="gaussian", init_scale=0.01)
        emb = fluid.layers.pull_box_sparse(ids, dim, table_name="bench_box")
        flat = fluid.layers.reshape(emb, [-1, slots * dim])
        deep = fluid.layers.concat([flat, dense], axis=1)
        h = fluid.layers.fc(deep, 256, act="relu")
        h = fluid.layers.fc(h, 128, act="relu")
        wide = fluid.layers.fc(dense, 1)
        logit = fluid.layers.fc(h, 1) + wide
        loss = fluid.layers.mean(
            fluid.layers.sigmoid_cross_entropy_with_logits(logit, label))
        fluid.optimizer.SGDOptimizer(0.01).minimize(loss)
    return main, startup, loss, box


def _stream(program):
    return [(op.type, op.inputs, op.outputs,
             op.attrs.get("__amp_cast__"), op.attrs.get("functor_list"))
            for op in program.global_block().ops]


def _strategies(fluid):
    bs = fluid.BuildStrategy()
    bs.fuse_elewise_add_act_ops = True
    bs.constant_folding = True
    bs2 = fluid.BuildStrategy()
    bs2.amp = True
    return bs, bs2


def _ops_before(pkg, main, loss):
    gb = main.global_block()
    return len(PKG[pkg]["prune"](
        gb, [op for op in gb.ops if op.type not in ("feed", "fetch")],
        targets=[loss.name], keep_state_writes=True))


@pytest.mark.parametrize("width", ("quick", "full"))
def test_bench_ctr_passes_rewrite_as_the_reference(width):
    """Both legs' rewrites, applied without running: the fused program
    and the amp program op for op (types, slots, folded casts, functor
    lists) and var for var (dtypes), 42 -> 38 ops, and one amp cast
    count, at --quick width and at bench.py's full width."""
    w = QUICK if width == "quick" else FULL
    out = {}
    for pkg in ("ref", "port"):
        fluid = PKG[pkg]["fluid"]
        main, _, loss, _ = _bench_program(pkg, w["slots"], w["dim"])
        before = _ops_before(pkg, main, loss)
        bs, bs2 = _strategies(fluid)
        fluid.CompiledProgram(main, build_strategy=bs)._apply_ir_passes(
            [loss.name])
        fused = _stream(main)
        after = _ops_before(pkg, main, loss)
        m = PKG[pkg]["trace"].metrics()
        c0 = m.counter("amp.ops_cast").value
        fluid.CompiledProgram(main, build_strategy=bs2)._apply_ir_passes(
            [loss.name])
        out[pkg] = dict(before=before, after=after, fused=fused,
                        amp=_stream(main),
                        amp_after=_ops_before(pkg, main, loss),
                        cast=m.counter("amp.ops_cast").value - c0,
                        dtypes={n: v.dtype for n, v
                                in main.global_block().vars.items()})
    ref, got = out["ref"], out["port"]
    assert (got["before"], got["after"], got["amp_after"]) == (42, 38, 38)
    for k in ("before", "after", "fused", "amp", "amp_after", "cast",
              "dtypes"):
        assert got[k] == ref[k], k
    assert got["cast"] == 32
    assert sum(op[0] == "fused_elemwise_activation" for op in got["fused"]) \
        == 2


def test_bench_ctr_legs_run_as_the_reference():
    """bench.py's two BoxPS legs at --quick width through
    ``AsyncStepRunner(...).submit(f).lazy(0)`` in both packages, from one
    state (the reference's fc weights carried over, the cache staged from
    one seed): ``executor.ops_per_step`` 38 on both legs, the same amp
    cast count, the fp32 losses within rtol 1e-5 and the bf16 first loss
    within the reference's bound of the fp32 one (rtol 0.05, atol 0.05,
    tests/test_amp_plane.py:123); after end_pass the host rows equal the
    trained cache."""
    q = QUICK
    rng = np.random.RandomState(0)
    all_ids = rng.randint(0, 2 ** 40, (4, q["batch"], q["slots"]),
                          dtype=np.int64)
    dense = [rng.randn(q["batch"], 13).astype("float32") for _ in range(4)]
    labels = [rng.randint(0, 2, (q["batch"], 1)).astype("float32")
              for _ in range(4)]
    init = None
    out = {}
    for pkg in ("ref", "port"):
        P = PKG[pkg]
        fluid = P["fluid"]
        main, startup, loss, box = _bench_program(pkg, q["slots"], q["dim"])
        scope = fluid.Scope()
        exe = fluid.Executor(_place(pkg))
        exe.run(startup, scope=scope)
        params = [p.name for p in main.all_parameters()
                  if not p.name.endswith("@HBMCACHE")]
        if init is None:
            init = {n: np.asarray(scope.find_var(n)) for n in params}
        else:
            interop.scope_from_numpy(init, scope, HOST)
        cache = box.begin_pass(all_ids)
        scope.set_var("bench_box@HBMCACHE", cache)
        feeds = [{"ids": box.slots_of(all_ids[b].reshape(-1)).reshape(
                      q["batch"], q["slots"]),
                  "dense": dense[b], "label": labels[b]} for b in range(4)]
        m = P["trace"].metrics()
        bs, bs2 = _strategies(fluid)
        runner = fluid.AsyncStepRunner(
            exe, fluid.CompiledProgram(main, build_strategy=bs), [loss],
            scope=scope)
        fp32 = [runner.submit(f).lazy(0) for f in feeds[:3]]
        runner.drain()
        ops = int(m.gauge("executor.ops_per_step").value)
        c0 = m.counter("amp.ops_cast").value
        amp = fluid.AsyncStepRunner(
            exe, fluid.CompiledProgram(main, build_strategy=bs2), [loss],
            scope=scope)
        bf16 = [amp.submit(feeds[3]).lazy(0)]
        amp.drain()
        trained = np.asarray(scope.find_var("bench_box@HBMCACHE"),
                             np.float32)
        box.end_pass(scope.find_var("bench_box@HBMCACHE"))
        host = box.host.pull(np.unique(all_ids))
        out[pkg] = dict(fp32=[float(x) for x in fp32],
                        bf16=[float(x) for x in bf16], ops=ops,
                        amp_ops=int(m.gauge("executor.ops_per_step").value),
                        cast=m.counter("amp.ops_cast").value - c0)
        np.testing.assert_array_equal(host, trained[:len(host)])
        assert box.pass_size == 0
    ref, got = out["ref"], out["port"]
    assert got["ops"] == ref["ops"] == 38
    assert got["amp_ops"] == ref["amp_ops"] == 38
    assert got["cast"] == ref["cast"] == 32
    np.testing.assert_allclose(got["fp32"], ref["fp32"], rtol=1e-5)
    assert got["fp32"][-1] < got["fp32"][0]
    np.testing.assert_allclose(got["bf16"], ref["bf16"], rtol=0.05,
                               atol=0.05)


# -- 5. the executor's repairs --------------------------------------------------
def test_numpy_scope_value_reaches_the_device_once(monkeypatch):
    """A numpy cache seeded into the scope is copied to the executor's
    device by the first run that reads it and written back as a tensor:
    two steps make exactly one such copy."""
    main, startup, loss, box = _bench_program("port", 2, 4)
    exe = tfluid.Executor(HOST)
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    ids = np.arange(8, dtype=np.int64).reshape(4, 2) + 2 ** 40
    cache = box.begin_pass(ids)
    scope.set_var("bench_box@HBMCACHE", cache)
    copies = []
    real = TExecutor._to_device

    def counting(self, v, dtype=None):
        if isinstance(v, np.ndarray) and v.shape == cache.shape:
            copies.append(v)
        return real(self, v, dtype)

    monkeypatch.setattr(TExecutor, "_to_device", counting)
    feed = {"ids": box.slots_of(ids.reshape(-1)).reshape(4, 2),
            "dense": np.ones((4, 13), "float32"),
            "label": np.ones((4, 1), "float32")}
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        assert isinstance(scope.find_var("bench_box@HBMCACHE"), torch.Tensor)
    assert len(copies) == 1
    assert int(ttrace.metrics().gauge("executor.ops_per_step").value) == 42


def test_close_drains_open_runners():
    main, startup, loss, box = _bench_program("port", 2, 4)
    exe = tfluid.Executor(HOST)
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    ids = np.arange(8, dtype=np.int64).reshape(4, 2)
    scope.set_var("bench_box@HBMCACHE", box.begin_pass(ids))
    feed = {"ids": box.slots_of(ids.reshape(-1)).reshape(4, 2),
            "dense": np.ones((4, 13), "float32"),
            "label": np.ones((4, 1), "float32")}
    futs = [exe.run_async(main, feed=feed, fetch_list=[loss], scope=scope)
            for _ in range(3)]
    runner = next(iter(exe._async_runners.values()))
    assert runner.inflight >= 1
    exe.close()
    assert runner.inflight == 0 and not exe._async_runners
    assert all(np.isfinite(float(f[0])) for f in futs)
