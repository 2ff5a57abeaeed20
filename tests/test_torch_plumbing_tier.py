"""The plumbing tail of the op catalog in paddle_tpu_torch against
paddle_tpu (op types 437 -> 488): the tensor-array and LoD ops, the file
ops (``save``, ``save_combine``, ``load``, ``load_combine``), the queues,
the copy and selected-rows ops, the sparse-table ops with the full
``CommonSparseTable``, the last thirteen of ``misc_ops`` and
``nondiff_reasons``.

- Each tensor op type on seeded numpy inputs in both packages
  (``OP_CASES``): outputs within rtol 1e-5 (and 1e-5 of the output's
  largest value), integers equal; ``generic_grad`` from one random
  cotangent within rtol 1e-4 where the reference registers a gradient.
  The reference runs one jitted program a case.  The op sweep
  (``test_torch_op_sweep.py``) takes the first case of each type its
  probes cannot feed from here.
- The array and rank-table ops, whose inputs are lists and tables; the
  file ops across packages (each reads the other's files); the queues;
  the sparse-table ops on fresh registries; the random
  ``*_batch_size_like`` ops held to ground rule 5's contract.
- ``CommonSparseTable`` against the reference's table: the three
  accessors over repeated ids, ``push_delta``, the row-state plane,
  eviction, the dirty set, save and load across packages.
- ``chip_smoke``'s checkpoint of the small static BERT program (hidden
  32, 2 layers) through ``save_combine``/``load_combine`` and
  ``save``/``load`` programs: the resumed losses equal the uninterrupted
  ones bit for bit, a load without Adam's moments misses, and the
  reference's resumed run agrees within 1e-5 relative.
- The ``fluid.layers`` builders of the slice in static programs of both
  packages, and each reference quirk the port copies, held in both.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
import paddle_tpu.ops as jops
from paddle_tpu.distributed.ps import table as jtable
from paddle_tpu.fluid.core import Scope as JScope, scope_guard as jguard
from paddle_tpu.fluid.framework import reset_unique_name as j_reset
from paddle_tpu.models.static_graphs import \
    build_bert_train_program as j_build
from paddle_tpu.ops import nondiff_reasons as jreasons
from paddle_tpu.ops import plumbing_ops as jplumb
from paddle_tpu.ops import registry as jreg

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.distributed.ps import table as ttable
from paddle_tpu_torch.fluid.framework import reset_unique_name as t_reset
from paddle_tpu_torch.models.static_graphs import \
    build_bert_train_program as t_build, bert_demo_feed
from paddle_tpu_torch.ops import nondiff_reasons as treasons
from paddle_tpu_torch.ops import plumbing_ops as tplumb
from paddle_tpu_torch.ops import registry as treg

import chip_smoke as C
from test_torch_fused_tier import (_jnp, _ref_fn, _torch,
                                   assert_outputs_match, check_generic_grad,
                                   grad_inputs)

jax.config.update("jax_platforms", "cpu")

RTOL = 1e-5

PLUMBING_OPS = (
    "array_to_lod_tensor", "coalesce_tensor", "delete_var", "dequeue",
    "distributed_lookup_table", "empty", "enqueue", "fake_init", "fill",
    "get_tensor_from_selected_rows", "load", "load_combine",
    "lod_tensor_to_array", "lookup_sparse_table_init",
    "lookup_sparse_table_read", "lookup_sparse_table_write",
    "max_sequence_len", "memcpy", "memcpy_d2h", "memcpy_h2d",
    "merge_lod_tensor", "merge_selected_rows", "queue_generator",
    "rnn_memory_helper", "save", "save_combine", "shrink_rnn_memory",
    "slice_multi_tensor", "split_ids", "split_lod_tensor",
    "split_selected_rows", "tensor_array_to_tensor",
    "uniform_random_batch_size_like",
    # misc_ops' last thirteen
    "diag", "elementwise_heaviside", "fill_diagonal",
    "gaussian_random_batch_size_like", "lod_reset", "minus",
    "modified_huber_loss", "pad_constant_like", "positive_negative_pair",
    "proximal_adagrad", "proximal_gd", "shuffle_channel", "spp",
    # catalog_tail_ops' sparse-table five
    "pull_sparse_v2", "lookup_sparse_table_fuse_sgd",
    "lookup_sparse_table_fuse_adam", "lookup_sparse_table_merge",
    "lookup_sparse_table_grad_split")

SMALL = dict(vocab=64, hidden=32, heads=4, seq=16, layers=2, dropout=0.0,
             lr=1e-3)
RESUME_RTOL = 1e-5

R = np.random.RandomState(29)


def _f(*shape, scale=1.0):
    return (R.randn(*shape) * scale).astype("float32")


def _ids(high, *shape):
    return R.randint(0, high, shape).astype("int64")


def _with_zeros(x, share=0.3):
    x = x.copy()
    x[R.rand(*x.shape) < share] = 0.0
    return x


_MASK = np.array([[1], [0], [1], [1], [0]], "int64")

# {label: (op, inputs, attrs)}; the first case of a type is the one the
# op sweep takes when its probes cannot feed the type
OP_CASES = {
    "split_lod_tensor": ("split_lod_tensor", {"X": _f(5, 3, 2),
                                              "Mask": _MASK}, {}),
    "merge_lod_tensor": ("merge_lod_tensor", {"InTrue": _f(5, 3),
                                              "InFalse": _f(5, 3),
                                              "Mask": _MASK}, {}),
    "rnn_memory_helper": ("rnn_memory_helper", {"X": _f(4, 6)}, {}),
    "empty": ("empty", {}, {"shape": [2, 3], "dtype": "float32"}),
    "empty, int64": ("empty", {}, {"shape": [4], "dtype": "int64"}),
    "fill": ("fill", {}, {"value": [1.5, -2.0, 3.0, 4.0, 5.0, 6.25],
                          "shape": [2, 3], "dtype": "float32"}),
    "fake_init": ("fake_init", {}, {"shape": [3, 4]}),
    "delete_var": ("delete_var", {}, {}),
    **{op: (op, {"X": _f(3, 4)}, {})
       for op in ("memcpy", "memcpy_h2d", "memcpy_d2h",
                  "merge_selected_rows", "get_tensor_from_selected_rows")},
    "coalesce_tensor": ("coalesce_tensor",
                        {"Input": [_f(2, 3), _f(4), _f(1, 2, 2)]}, {}),
    "coalesce_tensor, an integer input": (
        "coalesce_tensor", {"Input": [_ids(5, 3), _f(2)]}, {}),
    "split_selected_rows": ("split_selected_rows", {"X": _f(6, 3)},
                            {"height_sections": [2, 4]}),
    "split_selected_rows, num": ("split_selected_rows", {"X": _f(6, 3)},
                                 {"num": 3}),
    "slice_multi_tensor": ("slice_multi_tensor",
                           {"X": [_f(6, 2), _f(6, 3)]},
                           {"begin": 1, "end": 4}),
    "split_ids": ("split_ids", {"Ids": np.array([5, 2, 9, 4, 7, 3, 12],
                                                "int64")}, {"num": 3}),
    "minus": ("minus", {"X": _f(3, 4), "Y": _f(3, 4)}, {}),
    "elementwise_heaviside": ("elementwise_heaviside",
                              {"X": _with_zeros(_f(4, 5)), "Y": _f(4, 5)},
                              {}),
    "modified_huber_loss": ("modified_huber_loss",
                            {"X": _f(8, 1, scale=2.0),
                             "Y": R.randint(0, 2, (8, 1)).astype("float32")},
                            {}),
    "fill_diagonal": ("fill_diagonal", {"X": _f(3, 4)}, {"value": 2.5}),
    "fill_diagonal, batched": ("fill_diagonal", {"X": _f(2, 3, 3)}, {}),
    "pad_constant_like": ("pad_constant_like", {"X": _f(4, 5),
                                                "Y": _f(2, 3)},
                          {"pad_value": 1.5}),
    "spp, max": ("spp", {"X": _f(2, 3, 7, 5)}, {"pyramid_height": 3}),
    "spp, avg": ("spp", {"X": _f(2, 3, 7, 5)},
                 {"pyramid_height": 2, "pooling_type": "avg"}),
    "shuffle_channel": ("shuffle_channel", {"X": _f(2, 6, 3, 3)},
                        {"group": 3}),
    "positive_negative_pair": (
        "positive_negative_pair",
        {"Score": np.round(_f(12, 1), 1),
         "Label": R.randint(0, 3, (12, 1)).astype("float32"),
         "QueryID": np.repeat(np.arange(3), 4).reshape(12, 1)
         .astype("int64")}, {}),
    "diag": ("diag", {"Diagonal": _f(4)}, {}),
    "lod_reset": ("lod_reset", {"X": _f(3, 4), "Y": _ids(4, 3)}, {}),
    "proximal_gd": ("proximal_gd",
                    {"Param": _f(4, 3), "Grad": _f(4, 3),
                     "LearningRate": np.array([0.1], "float32")},
                    {"l1": 0.1, "l2": 0.2}),
    "proximal_adagrad": ("proximal_adagrad",
                         {"Param": _f(4, 3), "Grad": _f(4, 3),
                          "Moment": np.abs(_f(4, 3)),
                          "LearningRate": np.array([0.1], "float32")},
                         {"l1": 0.1, "l2": 0.2}),
    "lookup_sparse_table_merge": (
        "lookup_sparse_table_merge",
        {"Ids": np.array([7, 3, 7, 9, 3, 7], "int64"), "Grad": _f(6, 3)},
        {}),
    "lookup_sparse_table_grad_split": (
        "lookup_sparse_table_grad_split",
        {"Ids": np.array([7, 3, 8, 9, 4], "int64"), "Grad": _f(5, 3)},
        {"num": 2}),
    "pull_sparse_v2": ("pull_sparse_v2",
                       {"W": _f(10, 4), "Ids": [_ids(10, 3, 2),
                                                _ids(10, 4)]}, {}),
}

# the op types no OP_CASES entry feeds: lists, rank tables, files,
# queues, registries of tables and random draws, each held below
HELD_APART = ("array_to_lod_tensor", "lod_tensor_to_array",
              "tensor_array_to_tensor", "max_sequence_len",
              "shrink_rnn_memory", "save", "save_combine", "load",
              "load_combine", "queue_generator", "enqueue", "dequeue",
              "lookup_sparse_table_init", "lookup_sparse_table_read",
              "lookup_sparse_table_write", "distributed_lookup_table",
              "lookup_sparse_table_fuse_sgd", "lookup_sparse_table_fuse_adam",
              "uniform_random_batch_size_like",
              "gaussian_random_batch_size_like")


def test_the_51_op_types_are_registered():
    assert len(set(PLUMBING_OPS)) == 51
    assert set(PLUMBING_OPS) <= set(treg.all_ops()) & set(jreg.all_ops())
    assert len(treg.all_ops()) == 488
    assert set(PLUMBING_OPS) == {op for op, _, _ in OP_CASES.values()} \
        | set(HELD_APART)


def test_the_port_lacks_only_the_collective_tail():
    """488 of the reference's 522 types: what is missing is exactly
    ``collective_ops``' 32, ``c_mixallgather`` and ``localsgd_select``."""
    collective = {t for t, d in jreg._OP_REGISTRY.items()
                  if d.fn.__module__ == "paddle_tpu.ops.collective_ops"}
    assert len(collective) == 32
    assert len(jops.builtin_ops()) == 522
    assert set(jops.builtin_ops()) - set(treg.all_ops()) == \
        collective | {"c_mixallgather", "localsgd_select"}


_RUNS = {}


def _run_case(case):
    """The reference's outputs of ``OP_CASES[case]`` and, where it
    registers a gradient, ``generic_grad``'s attrs, inputs and the
    reference's result: forward and gradient one jitted program."""
    if case not in _RUNS:
        op, ins, attrs = OP_CASES[case]
        fwd, grad = _ref_fn(op, attrs), None
        if not jreg.get_op(op).differentiable:
            ref = jax.jit(fwd)(_jnp(ins))
        else:
            gattrs, gins = grad_inputs(op, ins, attrs,
                                       jax.eval_shape(fwd, _jnp(ins)))
            gfn = _ref_fn("generic_grad", gattrs)
            ref, want = jax.jit(lambda i, g: (fwd(i), gfn(g)))(
                _jnp(ins), _jnp(gins))
            grad = gattrs, gins, want
        _RUNS[case] = ref, grad
    return _RUNS[case]


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_forward_matches_reference(case):
    op, ins, attrs = OP_CASES[case]
    port = treg.get_op(op).fn(_torch(ins), dict(attrs),
                              treg.LoweringContext())
    assert_outputs_match(_run_case(case)[0], port, RTOL, case)


GRAD_CASES = sorted(c for c, (op, _, _) in OP_CASES.items()
                    if jreg.get_op(op).differentiable)


@pytest.mark.parametrize("case", GRAD_CASES)
def test_generic_grad_matches_reference(case):
    op = OP_CASES[case][0]
    assert treg.get_op(op).differentiable
    assert tuple(treg.get_op(op).nondiff_inputs) == \
        tuple(jreg.get_op(op).nondiff_inputs)
    check_generic_grad(*_run_case(case)[1])


# --- tensor arrays and rank tables -------------------------------------------
def _both(op, ins_j, ins_t, attrs=None):
    return (jreg.get_op(op).fn(ins_j, dict(attrs or {}),
                               jreg.LoweringContext()),
            treg.get_op(op).fn(ins_t, dict(attrs or {}),
                               treg.LoweringContext()))


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def test_tensor_array_ops_match_reference():
    """lod_tensor_to_array (one entry a row), array_to_lod_tensor (with a
    0-d entry and a hole), tensor_array_to_tensor concatenated and
    stacked, OutIndex each entry's extent."""
    x = _f(3, 2, 4)
    ref, port = _both("lod_tensor_to_array", {"X": [jnp.asarray(x)]},
                      {"X": [torch.from_numpy(x)]})
    assert len(port["Out"][0]) == len(ref["Out"][0]) == 3
    for w, g in zip(ref["Out"][0], port["Out"][0]):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    entries = [_f(2, 4), None, _f(1, 4)]
    scalar = [np.float32(1.5), _f(2)]
    for arr, attrs, op in (
            (entries, {}, "array_to_lod_tensor"),
            (scalar, {}, "array_to_lod_tensor"),
            (entries, {"axis": 0}, "tensor_array_to_tensor"),
            ([_f(2, 3), _f(2, 5)], {"axis": 1}, "tensor_array_to_tensor"),
            ([_f(2, 3), _f(2, 3)], {"axis": 1, "use_stack": True},
             "tensor_array_to_tensor")):
        ref, port = _both(
            op, {"X": [[None if a is None else jnp.asarray(a)
                        for a in arr]]},
            {"X": [[None if a is None else torch.tensor(a) for a in arr]]},
            attrs)
        assert_outputs_match(ref, port, 0.0, f"{op} {attrs}")


def _rank_tables(x):
    ref, port = _both("lod_rank_table", {"X": [jnp.asarray(x)]},
                      {"X": [torch.from_numpy(x)]})
    return ref["Out"][0], port["Out"][0]


@pytest.mark.parametrize("step", [0, 2, 5])
def test_rank_table_ops_match_reference(step):
    """max_sequence_len, and shrink_rnn_memory forward and through
    generic_grad at a step inside the padded length and at its end (one
    row stays), the index read from I or from ``__index__``."""
    x, mem = _f(3, 5, 2), _f(3, 4)
    jt, tt = _rank_tables(x)
    ref, port = _both("max_sequence_len", {"RankTable": [jt]},
                      {"RankTable": [tt]})
    assert_outputs_match(ref, port, 0.0, "max_sequence_len")
    for attrs in ({}, {"__index__": step}):
        i = np.array([step if not attrs else 99], "int64")
        ref, port = _both(
            "shrink_rnn_memory",
            {"X": [jnp.asarray(mem)], "I": [jnp.asarray(i)],
             "RankTable": [jt]},
            {"X": [torch.from_numpy(mem)], "I": [torch.from_numpy(i)],
             "RankTable": [tt]}, attrs)
        assert_outputs_match(ref, port, 0.0, f"shrink_rnn_memory {attrs}")
    cot = _f(*np.shape(ref["Out"][0]))
    gattrs = {"fwd_type": "shrink_rnn_memory", "fwd_attrs": {},
              "grad_slots": ["X"], "in_slots": ["X", "I", "RankTable"]}
    i = np.array([step], "int64")
    want = jreg.get_op("generic_grad").fn(
        {"I_X": [jnp.asarray(mem)], "I_I": [jnp.asarray(i)],
         "I_RankTable": [jt], "G_Out": [jnp.asarray(cot)]}, dict(gattrs),
        jreg.LoweringContext())
    got = treg.get_op("generic_grad").fn(
        {"I_X": [torch.from_numpy(mem)], "I_I": [torch.from_numpy(i)],
         "I_RankTable": [tt], "G_Out": [torch.from_numpy(cot)]},
        dict(gattrs), treg.LoweringContext())
    assert_outputs_match(want, got, RTOL, "shrink_rnn_memory generic_grad")


# --- save and load -----------------------------------------------------------
def _save_with(pkg, op, arrays, path):
    """Each package's lowering of ``op`` over ``arrays`` (called
    directly: the reference's executor prunes a save op, see
    test_save_programs_write_in_the_port_only)."""
    if pkg == "ref":
        jreg.get_op(op).fn({"X": [jnp.asarray(a) for a in arrays]},
                           {"file_path": path}, jreg.LoweringContext())
    else:
        treg.get_op(op).fn({"X": [torch.from_numpy(a) for a in arrays]},
                           {"file_path": path}, treg.LoweringContext())


def _load_with(pkg, op, path):
    if pkg == "ref":
        out = jreg.get_op(op).fn({}, {"file_path": path},
                                 jreg.LoweringContext())
    else:
        out = treg.get_op(op).fn({}, {"file_path": path},
                                 treg.LoweringContext())
    return [_np(o) for o in out["Out"]]


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("op", ["save_combine", "save"])
def test_files_cross_packages(op, writer, tmp_path):
    """A file the one package's ``save``/``save_combine`` writes loads
    through the other's ``load``/``load_combine`` byte for byte: one
    ``np.savez`` file, the arrays by position, ``.npz`` appended to a path
    that lacks it."""
    arrays = [_f(3, 4), np.arange(6, dtype="int32").reshape(2, 3),
              _f(1)][: 1 if op == "save" else 3]
    path = str(tmp_path / "sub" / "ckpt")
    _save_with(writer, op, arrays, path)
    assert os.listdir(tmp_path / "sub") == ["ckpt.npz"]
    with np.load(path + ".npz") as f:
        assert f.files == [f"arr_{i}" for i in range(len(arrays))]
    reader = "port" if writer == "ref" else "ref"
    got = _load_with(reader, op.replace("save", "load"), path)
    assert len(got) == len(arrays)
    for g, w in zip(got, arrays):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_load_rereads_and_a_missing_file_raises(tmp_path):
    """``fluid.layers.load``'s op reads the file on every run, in both
    packages, so a run after a save sees the new values; the port raises
    on a missing file."""
    path = str(tmp_path / "w")
    got = {}
    for pkg, fluid, reset in (("ref", jfluid, j_reset),
                              ("port", tfluid, t_reset)):
        reset()
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            out = main.global_block().create_var(
                name="w", shape=[2, 3], dtype="float32", persistable=True)
            fluid.layers.load(out, path)
        runs = []
        for k in range(2):
            np.savez(path + ".npz", np.full((2, 3), k, "float32"))
            if pkg == "ref":
                with jguard(JScope()):
                    runs.append(np.asarray(jfluid.Executor().run(
                        main, fetch_list=[out])[0]))
            else:
                runs.append(tfluid.Executor(tfluid.CPUPlace()).run(
                    main, fetch_list=[out], scope=tfluid.Scope())[0])
        got[pkg] = runs
        assert [op.type for op in main.global_block().ops] == ["load"]
    for pkg in got:
        np.testing.assert_array_equal(got[pkg][0], np.zeros((2, 3)))
        np.testing.assert_array_equal(got[pkg][1], np.ones((2, 3)))
    with pytest.raises(FileNotFoundError):
        _load_with("port", "load_combine", str(tmp_path / "missing"))


def test_save_programs_write_in_the_port_only(tmp_path):
    """A program of one ``save_combine`` op: the port's executor runs it
    and writes the file; the reference's prunes the op (it has no
    output and is not among the side-effect op types), so its save
    programs write nothing (ROADMAP queue C)."""
    w = _f(2, 3)
    for pkg, fluid, reset in (("ref", jfluid, j_reset),
                              ("port", tfluid, t_reset)):
        reset()
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            fluid.layers.create_parameter([2, 3], "float32", name="w")
        prog = C.checkpoint_program(fluid, main, ["w"],
                                    str(tmp_path / pkg), True)
        if pkg == "ref":
            scope = JScope()
            scope.set_var("w", jnp.asarray(w))
            with jguard(scope):
                jfluid.Executor().run(prog)
        else:
            scope = interop.scope_from_numpy({"w": w}, tfluid.Scope(),
                                             tfluid.CPUPlace())
            tfluid.Executor(tfluid.CPUPlace()).run(prog, scope=scope)
    assert not (tmp_path / "ref").exists()
    with np.load(tmp_path / "port" / "__params__.npz") as f:
        np.testing.assert_array_equal(f["arr_0"], w)


# --- queues ------------------------------------------------------------------
def test_queue_ops_match_reference():
    """queue_generator, enqueue and dequeue in both packages: the values
    come back in order, cast to ``dtype``; the port queues a snapshot, so
    an in-place update after the enqueue does not reach the queue; a
    ``shape`` other than the tensor's raises in the port."""
    xs = [_f(2, 3) for _ in range(3)]
    jctx, tctx = jreg.LoweringContext(), treg.LoweringContext()
    for reg, ctx in ((jreg, jctx), (treg, tctx)):
        reg.get_op("queue_generator").fn({}, {"names": ["q29"],
                                              "capacity": 4}, ctx)
    for x in xs:
        jreg.get_op("enqueue").fn({"X": [jnp.asarray(x)]},
                                  {"queue_name": "q29"}, jctx)
        t = torch.from_numpy(x.copy())
        treg.get_op("enqueue").fn({"X": [t]}, {"queue_name": "q29"}, tctx)
        t.add_(100.0)
    attrs = {"queue_name": "q29", "shape": [2, 3], "dtype": "float16"}
    for x in xs:
        ref, port = _both("dequeue", {}, {}, attrs)
        assert port["Out"][0].dtype == torch.float16
        assert_outputs_match(ref, port, 0.0, "dequeue")
        np.testing.assert_array_equal(_np(port["Out"][0]),
                                      x.astype("float16"))
    treg.get_op("enqueue").fn({"X": [torch.from_numpy(xs[0])]},
                              {"queue_name": "q29"}, tctx)
    with pytest.raises(ValueError, match="shape"):
        treg.get_op("dequeue").fn({}, dict(attrs, shape=[3, 2]), tctx)


# --- the sparse tables -------------------------------------------------------
@pytest.fixture
def tables():
    """Empty table registries in both packages, emptied again after."""
    jplumb._SPARSE_TABLES.clear()
    tplumb._SPARSE_TABLES.clear()
    yield jplumb._SPARSE_TABLES, tplumb._SPARSE_TABLES
    jplumb._SPARSE_TABLES.clear()
    tplumb._SPARSE_TABLES.clear()


def _table_ops(reg, conv, ops):
    """Run [(op, inputs, attrs)] through ``reg``; the outputs as numpy."""
    ctx = reg.LoweringContext()
    outs = []
    for op, ins, attrs in ops:
        o = reg.get_op(op).fn({k: [conv(a) for a in v]
                               for k, v in ins.items()}, dict(attrs), ctx)
        outs.append({k: [_np(a) for a in v] for k, v in o.items()})
    return outs


def _both_tables(ops):
    return (_table_ops(jreg, jnp.asarray, ops),
            _table_ops(treg, torch.from_numpy, ops))


def _same_tables(jt, tt):
    assert sorted(jt) == sorted(tt)
    for name in jt:
        a, b = jt[name], tt[name]
        assert (a.optimizer, a.lr, a.dim) == (b.optimizer, b.lr, b.dim)
        ids = a.all_ids()
        np.testing.assert_array_equal(b.all_ids(), ids)
        sa, sb = a.row_state(ids), b.row_state(ids)
        for k in sa:
            np.testing.assert_allclose(sb[k], sa[k], rtol=1e-6, atol=1e-7,
                                       err_msg=f"{name} {k}")


def test_sparse_table_ops_match_reference(tables):
    """A pass's order over two tables: made, pulled by
    ``distributed_lookup_table`` and read, set by the write, pushed by
    both fused pushes (repeated ids) and read again; every output and
    every row, moment and step of both tables as the reference's."""
    ids = np.array([[4, 9, 4], [2, 9, 7]], "int64")
    flat = ids.reshape(-1)
    g = _f(6, 3)
    ops = [
        ("lookup_sparse_table_init", {}, {"table_name": "a", "dim": 3,
                                          "optimizer": "sgd", "lr": 0.5}),
        ("distributed_lookup_table", {"Ids": [ids]},
         {"table_names": ["a"], "dim": 3}),
        ("lookup_sparse_table_write", {"Ids": [flat[:3]],
                                       "Value": [_f(3, 3)]},
         {"table_name": "a"}),
        ("lookup_sparse_table_read", {"Ids": [flat]},
         {"table_name": "a", "dim": 3}),
        ("lookup_sparse_table_fuse_sgd", {"Ids": [flat], "Grad": [g]},
         {"table_name": "a", "lr": 0.25}),
        ("lookup_sparse_table_fuse_adam", {"Ids": [flat], "Grad": [g]},
         {"table_name": "b", "lr": 0.01}),
        ("lookup_sparse_table_fuse_adam", {"Ids": [flat[::-1].copy()],
                                           "Grad": [g * 2]},
         {"table_name": "b", "lr": 0.01}),
        ("distributed_lookup_table", {"Ids": [ids]},
         {"table_name": "b", "dim": 3}),
        ("lookup_sparse_table_read", {"Ids": [flat]},
         {"table_name": "a", "dim": 3}),
    ]
    ref, port = _both_tables(ops)
    for (op, _, _), w, p in zip(ops, ref, port):
        assert sorted(w) == sorted(p), op
        for k in w:
            for a, b in zip(w[k], p[k]):
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7,
                                           err_msg=op)
    assert port[1]["Out"][0].shape == (2, 3, 3)
    _same_tables(*tables)
    assert tables[1]["b"].optimizer == "adam"


def test_get_table_quirk_held_in_both(tables):
    """``_get_table`` makes a table once and ignores a later optimizer
    or rate: ``fuse_adam`` on a table ``lookup_sparse_table_init`` made
    with sgd at lr 1 runs sgd at lr 1; only ``fuse_sgd`` resets the
    rate, which a later ``fuse_adam`` then keeps."""
    flat = np.array([3, 5], "int64")
    g = _f(2, 2)
    ops = [("lookup_sparse_table_init", {}, {"table_name": "q", "dim": 2}),
           ("lookup_sparse_table_fuse_adam", {"Ids": [flat], "Grad": [g]},
            {"table_name": "q", "lr": 0.001}),
           ("lookup_sparse_table_read", {"Ids": [flat]},
            {"table_name": "q", "dim": 2}),
           ("lookup_sparse_table_fuse_sgd", {"Ids": [flat], "Grad": [g]},
            {"table_name": "q", "lr": 0.1}),
           ("lookup_sparse_table_fuse_adam", {"Ids": [flat], "Grad": [g]},
            {"table_name": "q", "lr": 0.001}),
           ("lookup_sparse_table_read", {"Ids": [flat]},
            {"table_name": "q", "dim": 2})]
    ref, port = _both_tables(ops)
    for k in (2, 5):
        np.testing.assert_allclose(port[k]["Out"][0], ref[k]["Out"][0],
                                   rtol=1e-6)
    np.testing.assert_allclose(port[2]["Out"][0], -g, rtol=1e-6)
    np.testing.assert_allclose(port[5]["Out"][0], -1.2 * g, rtol=1e-6)
    for reg in tables:
        assert (reg["q"].optimizer, reg["q"].lr) == ("sgd", 0.1)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
def test_common_sparse_table_matches_reference(optimizer, tmp_path):
    """The accessors over repeated ids from one seed, ``push_delta``,
    ``set_rows``, the row-state plane in both directions, the dirty set,
    eviction with compaction, then save and load across packages, bit for
    bit (rows grown past the first capacity)."""
    j = jtable.CommonSparseTable(4, optimizer, 0.1, capacity=4,
                                 initializer=jtable.Initializer("uniform",
                                                                0.1, 3))
    t = ttable.CommonSparseTable(4, optimizer, 0.1, capacity=4,
                                 initializer=ttable.Initializer("uniform",
                                                                0.1, 3))
    rng = np.random.RandomState(4)
    for step in range(3):
        ids = rng.randint(0, 12, 9).astype("int64")
        g = rng.randn(9, 4).astype("float32")
        for tbl in (j, t):
            tbl.pull(ids[::-1])
            tbl.push(ids, g)
            tbl.push_delta(ids[:4], g[:4])
    for tbl in (j, t):
        tbl.set_rows(np.array([30], "int64"), np.ones((1, 4), "float32"))
    ids = j.all_ids()
    np.testing.assert_array_equal(t.all_ids(), ids)
    sj, st = j.row_state(ids), t.row_state(ids)
    assert sorted(st) == sorted(sj) == ["ids", "m", "t", "v", "vals"]
    for k in sj:
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    for (a, b) in zip(j.drain_dirty(), t.drain_dirty()):
        np.testing.assert_array_equal(b, a)
    assert [x.size for x in t.drain_dirty()] == [0, 0]
    assert j.evict_rows(ids[::3]) == t.evict_rows(ids[::3]) > 0
    np.testing.assert_array_equal(t.all_ids(), j.all_ids())
    np.testing.assert_array_equal(t.pull(t.all_ids()), j.pull(j.all_ids()))
    u = ttable.CommonSparseTable(4, optimizer, 0.1)
    u.set_row_state(j.row_state(j.all_ids()))
    k = jtable.CommonSparseTable(4, optimizer, 0.1)
    k.set_row_state(t.row_state(t.all_ids()))
    t.save(tmp_path / "port")
    j.save(tmp_path / "ref")
    v, w = ttable.CommonSparseTable(4, optimizer, 0.1), \
        jtable.CommonSparseTable(4, optimizer, 0.1)
    v.load(tmp_path / "ref")
    w.load(tmp_path / "port")
    for a, b in ((u, j), (k, t), (v, j), (w, t)):
        sa, sb = a.row_state(b.all_ids()), b.row_state(b.all_ids())
        for key in sb:
            np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)
    np.testing.assert_array_equal(v.drain_dirty()[0], j.all_ids())
    # one more push from the restored state moves both alike
    ids = j.all_ids()[[0, 1, 1]]
    g = rng.randn(3, 4).astype("float32")
    v.push(ids, g)
    j.push(ids, g)
    np.testing.assert_array_equal(v.pull(ids), j.pull(ids))


# --- random ops --------------------------------------------------------------
@pytest.mark.parametrize("op,attrs,mean,std", [
    ("uniform_random_batch_size_like",
     {"shape": [-1, 64], "min": -2.0, "max": 3.0}, 0.5, 5 / 12 ** 0.5),
    ("uniform_random_batch_size_like",
     {"shape": [7, -1, 64], "input_dim_idx": 1, "output_dim_idx": 0},
     0.0, 1 / 3 ** 0.5),
    ("gaussian_random_batch_size_like",
     {"shape": [-1, 64], "mean": 1.0, "std": 2.0}, 1.0, 2.0),
    ("gaussian_random_batch_size_like",
     {"shape": [7, 64], "input_dim_idx": 1, "output_dim_idx": 1},
     0.0, 1.0)])
def test_random_batch_size_like_contract(op, attrs, mean, std):
    """Ground rule 5: the reference's shape (uniform's reads
    ``input_dim_idx`` on both sides, the reference's quirk), dtype, range
    and moments within 4 standard errors; the same numbers for a seed and
    step, others for another seed."""
    x = _f(300, 40)
    ref = jreg.get_op(op).fn({"Input": [jnp.asarray(x)]}, dict(attrs),
                             jreg.LoweringContext(
                                 base_key=jax.random.PRNGKey(0)))["Out"][0]

    def draw(seed):
        return treg.get_op(op).fn(
            {"Input": [torch.from_numpy(x)]}, dict(attrs, op_seed=3),
            treg.LoweringContext(base_seed=seed))["Out"][0].numpy()

    a, b, c = draw(1), draw(1), draw(2)
    assert a.shape == np.shape(ref) and a.dtype == np.float32
    if op.startswith("uniform"):
        lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
        assert a.min() >= lo and a.max() < hi
    se = std / a.size ** 0.5
    assert abs(a.mean() - mean) < 4 * se
    assert abs(a.std() - std) < 4 * std / (2 * a.size) ** 0.5 + 0.02 * std
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


# --- nondiff reasons ---------------------------------------------------------
def test_nondiff_reasons_match_reference():
    """Every op type of the port carries the reference's category, and
    every non-differentiable one has one (generic_grad registers late, in
    fluid/backward.py, so both packages apply the reasons again)."""
    assert treasons.CATEGORIES == jreasons.CATEGORIES
    assert treasons.REASONS == jreasons.REASONS
    jreasons.apply_reasons()
    treasons.apply_reasons()
    for op in treg.all_ops():
        assert treg.get_op(op).nondiff_reason == \
            jreg.get_op(op).nondiff_reason, op
        if not treg.get_op(op).differentiable:
            assert treg.get_op(op).nondiff_reason, op


# --- the builders ------------------------------------------------------------
def _builders(fluid):
    """The slice's fluid.layers builders in one static program over
    _BUILDER_FEED; returns (program, {label: fetch var}, {label: var of
    random values})."""
    L = fluid.layers
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = fluid.data("x", [2, 6, 3, 3], "float32")
        a = fluid.data("a", [4, 4], "float32")
        b = fluid.data("b", [4, 4], "float32")
        y = fluid.data("y", [2, 3], "float32")
        vals = {
            "affine_channel": L.affine_channel(
                x, scale=L.assign(np.arange(6, dtype="float32")),
                bias=L.assign(np.ones(6, "float32")), act="relu"),
            "affine_channel, identity": L.affine_channel(x),
            "cond_value": L.cond_value(L.greater_than(a, b), a, b),
            "diag": L.diag(L.assign(np.arange(3, dtype="float32"))),
            "logical_xor": L.cast(L.logical_xor(L.greater_than(a, b),
                                                L.less_than(a, a * 0.5)),
                                  "float32"),
            "matmul_v2": L.matmul_v2(a, b, trans_y=True),
            "pad_constant_like": L.pad_constant_like(a, y, 2.0),
            "shuffle_channel": L.shuffle_channel(x, 3),
            "temporal_shift": L.temporal_shift(x, 2),
            "triu": L.triu(a, 1),
            **{f"unbind {i}": v for i, v in enumerate(L.unbind(a, 1))},
        }
        rand = {
            "uniform_random": L.uniform_random([5, 4], min=2.0, max=3.0),
            "gaussian_random": L.gaussian_random([5, 4]),
            "uniform_random_batch_size_like":
                L.uniform_random_batch_size_like(y, [-1, 7]),
            "gaussian_random_batch_size_like":
                L.gaussian_random_batch_size_like(y, [-1, 7]),
        }
        for name in ("lod_reset", "lod_append", "merge_selected_rows",
                     "get_tensor_from_selected_rows"):
            fn = getattr(L, name)
            assert (fn(a, 1) if name == "lod_append" else fn(a)) is a
    return main, vals, rand


_BUILDER_FEED = {"x": _f(2, 6, 3, 3), "a": _f(4, 4), "b": _f(4, 4),
                 "y": _f(2, 3)}


def test_builders_match_reference():
    """The op lists equal, the deterministic outputs within RTOL, the
    random ones of the reference's shapes (uniform in its range)."""
    got = {}
    for pkg, fluid, reset in (("ref", jfluid, j_reset),
                              ("port", tfluid, t_reset)):
        reset()
        main, vals, rand = _builders(fluid)
        feed = _BUILDER_FEED
        fetch = list(vals.values()) + list(rand.values())
        if pkg == "ref":
            with jguard(JScope()):
                out = jfluid.Executor().run(main, feed=feed,
                                            fetch_list=fetch)
        else:
            out = tfluid.Executor(tfluid.CPUPlace()).run(
                main, feed=feed, fetch_list=fetch, scope=tfluid.Scope())
        got[pkg] = ([op.type for op in main.global_block().ops],
                    dict(zip(list(vals) + list(rand),
                             [np.asarray(o) for o in out])))
    assert got["port"][0] == got["ref"][0]
    for k, w in got["ref"][1].items():
        g = got["port"][1][k]
        assert g.shape == w.shape, k
        if k in ("uniform_random", "gaussian_random",
                 "uniform_random_batch_size_like",
                 "gaussian_random_batch_size_like"):
            continue
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL, err_msg=k)
    u = got["port"][1]["uniform_random"]
    assert u.min() >= 2.0 and u.max() < 3.0


def test_tensor_array_to_tensor_builder_matches_reference():
    """``tensor_array_to_tensor`` over an array of three writes: the
    port's op on the array the program builds, the reference's concat of
    the writes it recorded; the same values."""
    got = {}
    for pkg, fluid, reset in (("ref", jfluid, j_reset),
                              ("port", tfluid, t_reset)):
        reset()
        L = fluid.layers
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            xs = [fluid.data(f"x{i}", [2, i + 1], "float32")
                  for i in range(3)]
            arr = L.create_array("float32")
            for i, x in enumerate(xs):
                L.array_write(x, L.fill_constant([1], "int64", i), arr)
            out, idx = L.tensor_array_to_tensor(arr, axis=1)
        feed = {f"x{i}": np.full((2, i + 1), i, "float32") for i in range(3)}
        if pkg == "ref":
            with jguard(JScope()):
                got[pkg] = jfluid.Executor().run(main, feed=feed,
                                                 fetch_list=[out, idx])
        else:
            got[pkg] = tfluid.Executor(tfluid.CPUPlace()).run(
                main, feed=feed, fetch_list=[out, idx],
                scope=tfluid.Scope())
    for w, g in zip(got["ref"], got["port"]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# --- the BERT checkpoint -----------------------------------------------------
def _strategy(fluid):
    bs = fluid.BuildStrategy()
    bs.fuse_attention = bs.fuse_optimizer = True
    return bs


@pytest.fixture(scope="module")
def bert(tmp_path_factory):
    """The reference's run of the small BERT program from its startup
    state: 4 steps uninterrupted, then 2, a checkpoint by its
    save_combine lowering (its executor prunes a save program), a fresh
    scope with the startup program, the load program, 2 more.  Returns
    the initial persistables, the feed, both runs' losses and the
    checkpoint names."""
    d = tmp_path_factory.mktemp("bert_ref")
    j_reset()
    main, startup, loss = j_build(**SMALL)
    feed = bert_demo_feed(np.random.RandomState(0), batch=8,
                          seq=SMALL["seq"], vocab=SMALL["vocab"])
    exe = jfluid.Executor()
    prog = jfluid.CompiledProgram(main, build_strategy=_strategy(jfluid))

    def steps(scope, n):
        with jguard(scope):
            return [float(np.asarray(exe.run(prog, feed=feed,
                                             fetch_list=[loss])[0]).ravel()[0])
                    for _ in range(n)]

    scope = JScope()
    with jguard(scope):
        exe.run(startup)
    names = C.checkpoint_vars(main, scope)
    init = {n: np.array(scope.find_var(n)) for n in names}

    def from_init():
        s = JScope()
        for n, v in init.items():
            s.set_var(n, jnp.asarray(v))
        return s

    want = steps(from_init(), C.CKPT_STEPS)
    scope = from_init()
    steps(scope, C.CKPT_AT)
    jreg.get_op("save_combine").fn(
        {"X": [scope.find_var(n) for n in names]},
        {"file_path": str(d / "__params__")}, jreg.LoweringContext())
    fresh = JScope()
    with jguard(fresh):
        exe.run(startup)
        exe.run(C.checkpoint_program(jfluid, main, names, str(d), False))
    resumed = steps(fresh, C.CKPT_STEPS - C.CKPT_AT)
    return dict(init=init, feed=feed, want=want, resumed=resumed,
                names=names, main=main)


def _port_built():
    t_reset()
    main, startup, loss = t_build(train=True, **SMALL)
    prog = tfluid.CompiledProgram(main, _strategy(tfluid))
    prog._apply_ir_passes([loss.name])
    return main, startup, prog, loss


@pytest.mark.parametrize("combine", [True, False])
def test_bert_checkpoint_round_trip(bert, combine, tmp_path):
    """The port resumed from a checkpoint after 2 of 4 steps through
    save_combine/load_combine (or save/load a var): steps 3 and 4 equal
    the uninterrupted run's bit for bit, and the reference's resumed run
    within RESUME_RTOL; the checkpoint is every persistable, sorted."""
    place = tfluid.CPUPlace()
    built = _port_built()
    main, _, prog, loss = built
    exe = tfluid.Executor(place)
    want = C.bert_train_steps(
        exe, prog, loss,
        interop.scope_from_numpy(bert["init"], tfluid.Scope(), place),
        bert["feed"], C.CKPT_STEPS)
    got, saved, _ = C.bert_resumed(tfluid, place, built, bert["init"],
                                   bert["feed"], str(tmp_path), combine)
    assert got == want[C.CKPT_AT:]
    assert sorted(saved) == list(saved) == bert["names"]
    assert len(saved) == 5 * len(main.all_parameters()) + 1
    np.testing.assert_allclose(got, bert["resumed"], rtol=RESUME_RTOL)
    np.testing.assert_allclose(want, bert["want"], rtol=RESUME_RTOL)
    files = os.listdir(tmp_path)
    assert files == ["__params__.npz"] if combine else \
        sorted(files) == sorted(n + ".npz" for n in saved)


def test_bert_checkpoint_twin_misses(bert, tmp_path):
    """A checkpoint without Adam's moment accumulators (what saving only
    the parameters gives): step 3's loss, computed before the first
    update the moments move, is the uninterrupted one; step 4's misses
    by more than 10 times the card-vs-host tolerance."""
    place = tfluid.CPUPlace()
    built = _port_built()
    _, _, prog, loss = built
    want = C.bert_train_steps(
        tfluid.Executor(place), prog, loss,
        interop.scope_from_numpy(bert["init"], tfluid.Scope(), place),
        bert["feed"], C.CKPT_STEPS)
    moments = [n for n in bert["names"] if "_moment" in n]
    assert len(moments) == 2 * len(built[0].all_parameters())
    twin, saved, _ = C.bert_resumed(tfluid, place, built, bert["init"],
                                    bert["feed"], str(tmp_path),
                                    skip=moments)
    assert not set(saved) & set(moments)
    assert twin[0] == want[C.CKPT_AT]
    assert abs(twin[1] - want[-1]) > C.CKPT_TWIN_MISS * abs(want[-1])


def test_port_checkpoint_loads_in_the_reference(bert, tmp_path):
    """The port's save_combine file of the BERT state after 2 steps, run
    through the reference's load program: every var byte for byte."""
    place = tfluid.CPUPlace()
    built = _port_built()
    _, saved, _ = C.bert_resumed(tfluid, place, built, bert["init"],
                                 bert["feed"], str(tmp_path))
    scope = JScope()
    with jguard(scope):
        jfluid.Executor().run(C.checkpoint_program(
            jfluid, bert["main"], bert["names"], str(tmp_path), False))
    for n, w in saved.items():
        g = np.asarray(scope.find_var(n))
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), n
