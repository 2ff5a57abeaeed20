"""The ProgramDesc wire format in paddle_tpu_torch against paddle_tpu.

The port writes and reads ``__model__`` with its own codec
(``paddle_tpu_torch/fluid/proto/framework_pb2.py``), since the card's
machine has no protobuf package.  Here it is held against the TPU
package's protoc-generated ``framework_pb2``, byte for byte:

* each message the reference serializes — the fixture's ``__model__``,
  LeNet, the 2-layer BERT program after ``fuse_attention``, the CTR
  program after ``fuse_sparse_embedding``, a ``while`` and a
  ``conditional_block`` program, one op carrying every ``AttrType`` —
  parses in the port and serializes to the same bytes; built field by
  field through the port's setters it gives the same bytes, and protobuf
  parses the port's bytes back to an equal message; the text format is
  ``text_format.MessageToString``'s;
* the IR round trip (bytes -> Program -> bytes) gives the same bytes in
  both packages, and the port builds each program with the reference's
  ops, inputs, outputs and attrs;
* tensor streams of every dtype (bfloat16 too, read without ml_dtypes),
  with and without LoD levels, and a combined params file.

Then every case of ``tests/test_proto_interop.py`` on the port, and a
model saved by either package loading in the other, outputs within fp32
rtol 1e-5 and atol 1e-6.
"""
import os
import sys

import numpy as np
import pytest
import torch
from google.protobuf import text_format

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import proto_serde as jserde
from paddle_tpu.fluid.proto import framework_pb2 as jfp

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import op_version_registry as opver
from paddle_tpu_torch.fluid import proto_serde
from paddle_tpu_torch.fluid.proto import framework_pb2 as fp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
import gen_ref_fc_model as fixture  # noqa: E402

FIXTURE_DIR = fixture.FIXTURE_DIR
fluid = tfluid
RTOL, ATOL = 1e-5, 1e-6


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


# ---------------------------------------------------------------------------
# the codec against protobuf
# ---------------------------------------------------------------------------

def _mirror(src, dst):
    """Fill the port message ``dst`` from the protobuf message ``src``
    through the port's setters, field by field."""
    for fd, value in src.ListFields():
        repeated = fd.is_repeated
        if fd.type == fd.TYPE_MESSAGE:
            if repeated:
                for m in value:
                    _mirror(m, getattr(dst, fd.name).add())
            else:
                _mirror(value, getattr(dst, fd.name))
        elif repeated:
            getattr(dst, fd.name).extend(list(value))
        else:
            setattr(dst, fd.name, value)
    return dst


def _assert_codec(data, cls="ProgramDesc"):
    """The port's codec gives protobuf's bytes and text for ``data``."""
    want = getattr(jfp, cls).FromString(data)
    got = getattr(fp, cls).FromString(data)
    assert got.SerializeToString() == data
    built = _mirror(want, getattr(fp, cls)())
    assert built.SerializeToString() == data
    assert built == got
    assert getattr(jfp, cls).FromString(built.SerializeToString()) == want
    assert fp.text_format(got) == text_format.MessageToString(want)


def _ops(data):
    """(type, inputs, outputs, attrs) of every op of every block."""
    pb = jfp.ProgramDesc.FromString(data)
    return [[(o.type, [(v.parameter, list(v.arguments)) for v in o.inputs],
              [(v.parameter, list(v.arguments)) for v in o.outputs],
              sorted(a.SerializeToString() for a in o.attrs))
             for o in b.ops] for b in pb.blocks]


def _fetch_of(main):
    """The logits var a BERT or CTR training program's loss reads."""
    op = [o for o in main.global_block().ops
          if o.type in ("softmax_with_cross_entropy",
                        "sigmoid_cross_entropy_with_logits")][0]
    return op.input("Logits" if "Logits" in op.inputs else "X")[0]


def _frozen_fused(pkg, build, feeds, flag):
    """``build``'s program in one package: startup run on the host,
    frozen at its logits, then the kernel-tier pass ``flag``."""
    from importlib import import_module
    serving = import_module(pkg.__name__.split(".")[0] + ".serving")
    main, startup, _ = build()
    fetch = _fetch_of(main)
    scope = pkg.Scope() if hasattr(pkg, "Scope") \
        else import_module(pkg.__name__ + ".core").Scope()
    with pkg.scope_guard(scope):
        pkg.Executor(pkg.CPUPlace()).run(startup)
        frozen = serving.freeze_program(main, feeds, [fetch])
        bs = pkg.BuildStrategy()
        setattr(bs, flag, True)
        pkg.CompiledProgram(frozen, bs)._apply_ir_passes([fetch])
    return frozen


def _bert(pkg):
    from importlib import import_module
    mod = import_module(pkg.__name__.split(".")[0]
                        + ".models.static_graphs")
    return _frozen_fused(pkg, lambda: mod.build_bert_train_program(layers=2),
                         ["ids", "attn_mask"], "fuse_attention")


def _ctr(pkg):
    from importlib import import_module
    mod = import_module(pkg.__name__.split(".")[0]
                        + ".models.static_graphs")
    return _frozen_fused(pkg, mod.build_ctr_train_program,
                         ["dense"] + [f"ids_{i}" for i in range(4)],
                         "fuse_sparse_embedding")


def _lenet(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        img = pkg.data("img", [-1, 1, 28, 28])
        conv1 = pkg.layers.conv2d(img, 6, 3, padding=1, act="relu")
        pool1 = pkg.layers.pool2d(conv1, 2, "max", 2)
        conv2 = pkg.layers.conv2d(pool1, 16, 5, act="relu")
        pool2 = pkg.layers.pool2d(conv2, 2, "max", 2)
        fc1 = pkg.layers.fc(pkg.layers.flatten(pool2), 120, act="relu")
        pkg.layers.fc(fc1, 10, act="softmax")
    return main


def _cond(pkg):
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        x = pkg.data("x", [1])
        c = pkg.layers.greater_than(
            pkg.layers.reduce_sum(x),
            pkg.layers.fill_constant([1], "float32", 0.0))
        pkg.layers.cond(c, lambda: x * 2.0, lambda: x - 1.0)
    return main


def _while(pkg):
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        i = pkg.layers.fill_constant([1], "int64", 0)
        n = pkg.layers.fill_constant([1], "int64", 10)
        pkg.layers.while_loop(lambda i: pkg.layers.less_than(i, n),
                              lambda i: [pkg.layers.increment(i)], [i])
    return main


PROGRAMS = {"lenet": _lenet, "bert_fuse_attention": _bert,
            "ctr_fuse_sparse_embedding": _ctr, "conditional_block": _cond,
            "while": _while}


def _both(name):
    """(reference bytes, port bytes) of PROGRAMS[name], each package
    from fresh name counters."""
    from paddle_tpu.fluid.framework import reset_unique_name
    reset_unique_name()
    ref = jserde.program_to_proto_bytes(PROGRAMS[name](jfluid))
    tframework.reset_unique_name()
    return ref, proto_serde.program_to_proto_bytes(PROGRAMS[name](tfluid))


def test_fixture_model_bytes():
    with open(os.path.join(FIXTURE_DIR, "__model__"), "rb") as f:
        data = f.read()
    _assert_codec(data)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_reference_program_bytes(name):
    ref, port = _both(name)
    _assert_codec(ref)
    _assert_codec(port)
    # the IR round trip gives the same bytes in both packages
    assert proto_serde.program_to_proto_bytes(
        proto_serde.program_from_proto_bytes(ref)) \
        == jserde.program_to_proto_bytes(jserde.program_from_proto_bytes(ref))
    # the port builds the reference's ops (vars may carry more shapes:
    # the port's shape inference knows some the reference leaves unset)
    assert _ops(port) == _ops(ref)
    types = [o.type for o in fp.ProgramDesc.FromString(ref).blocks[0].ops]
    if name == "bert_fuse_attention":
        assert types.count("fused_multihead_attention") == 2
    if name == "ctr_fuse_sparse_embedding":
        assert types.count("fused_embedding_pool") == 4
        assert "lookup_table_v2" not in types
    if name in ("conditional_block", "while"):
        pb = fp.ProgramDesc.FromString(ref)
        assert len(pb.blocks) > 1
        assert [a for b in pb.blocks for o in b.ops for a in o.attrs
                if a.type == fp.BLOCK]


def _every_attr(m):
    pb = m.ProgramDesc()
    b = pb.blocks.add()
    b.idx, b.parent_idx = 0, -1
    b.forward_block_idx = 3
    sub = pb.blocks.add()
    sub.idx, sub.parent_idx = 1, 0
    op = b.ops.add()
    op.type = "every_attr"
    op.is_target = True
    values = [("INT", "i", -5), ("FLOAT", "f", 0.1), ("STRING", "s", "é\n"),
              ("INTS", "ints", [-1, 0, 2 ** 31 - 1]),
              ("FLOATS", "floats", [1.5, -2.25e-8, float("inf")]),
              ("STRINGS", "strings", ["a", "", "b"]),
              ("BOOLEAN", "b", False), ("BOOLEANS", "bools", [True, False]),
              ("BLOCK", "block_idx", 1), ("LONG", "l", -2 ** 40),
              ("BLOCKS", "blocks_idx", [1, 0]),
              ("LONGS", "longs", [2 ** 62, -3])]
    for kind, field, value in values:
        a = op.attrs.add()
        a.name, a.type = kind.lower(), getattr(m, kind)
        if isinstance(value, list):
            getattr(a, field).extend(value)
        else:
            setattr(a, field, value)
    v = b.vars.add()
    v.name = "r"
    v.type.type = m.VarType.READER
    r = v.type.reader.lod_tensor.add()
    r.tensor.data_type = m.VarType.BF16
    r.lod_level = 2
    v = b.vars.add()
    v.name = "t"
    v.type.type = m.VarType.TUPLE
    v.type.tuple.element_type.extend([m.VarType.INT8, m.VarType.FP16])
    v = b.vars.add()
    v.name = "arr"
    v.type.type = m.VarType.LOD_TENSOR_ARRAY
    v.type.tensor_array.tensor.data_type = m.VarType.INT32
    v.type.tensor_array.tensor.dims.extend([-1, 7])
    pb.version.version = -1
    pair = pb.op_version_map.pair.add()
    pair.op_name = "every_attr"
    pair.op_version.version = 2
    return pb


def test_every_attr_type_bytes():
    want = _every_attr(jfp)
    data = want.SerializeToString()
    assert _every_attr(fp).SerializeToString() == data
    _assert_codec(data)
    assert sorted(fp.AttrType.keys()) == sorted(jfp.AttrType.keys())
    assert {k: getattr(fp.VarType, k) for k in jfp.VarType.Type.keys()} \
        == dict(jfp.VarType.Type.items())


@pytest.mark.parametrize("value", [True, 3, 2 ** 40, 0.5, "s", [], [True],
                                   [1, 2], [2 ** 40], [1, 0.5], ["a"],
                                   {"k": [1]}])
def test_set_attr_matches_reference(value):
    got, want = fp.OpDesc.Attr(), jfp.OpDesc.Attr()
    assert proto_serde._set_attr(got, "axis", value, "op") \
        == jserde._set_attr(want, "axis", value, "op")
    assert got.SerializeToString() == want.SerializeToString()
    assert proto_serde._get_attr(got) == jserde._get_attr(want)


def test_unknown_fields_are_skipped_and_packed_scalars_read():
    td = jfp.VarType.TensorDesc()
    td.data_type = jfp.VarType.FP32
    td.dims.extend([2, 3])
    # field 9 varint, field 10 length, field 11 fixed32, field 12 fixed64
    extra = b"\x48\x07" + b"\x52\x02ab" + b"\x5d\x00\x00\x00\x00" \
        + b"\x61" + b"\x00" * 8
    got = fp.VarType.TensorDesc.FromString(td.SerializeToString() + extra)
    assert got.SerializeToString() == td.SerializeToString()
    # dims sent packed (one length-delimited run) read as unpacked
    packed = b"\x08\x05\x12\x02\x02\x03"
    assert list(fp.VarType.TensorDesc.FromString(packed).dims) == [2, 3]


# ---------------------------------------------------------------------------
# tensor streams and combined params files
# ---------------------------------------------------------------------------

DTYPES = ("bool", "int16", "int32", "int64", "float16", "float32",
          "float64", "uint8", "int8", "bfloat16")


def _array(dtype, rng):
    if dtype == "bfloat16":
        import ml_dtypes
        return (rng.randn(3, 4) * 10).astype(ml_dtypes.bfloat16)
    return (rng.rand(3, 4) * 10).astype(dtype)


def _as_float32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("lod", [(), ([0, 2, 3],), ([0, 1, 3], [0, 2, 4, 5])],
                         ids=["no_lod", "lod1", "lod2"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tensor_stream_bytes(dtype, lod, rng):
    arr = _array(dtype, rng)
    data = jserde.serialize_lod_tensor(arr, lod)
    assert proto_serde.serialize_lod_tensor(arr, lod) == data
    got, got_lod, end = proto_serde.deserialize_lod_tensor(data)
    assert end == len(data) and got_lod == [list(level) for level in lod]
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == arr.shape
    np.testing.assert_array_equal(_as_float32(got), _as_float32(arr))
    # a torch tensor writes the same stream
    assert proto_serde.serialize_lod_tensor(got, lod) == data


def test_combined_params_bytes(tmp_path, rng):
    import ml_dtypes
    arrays = {"fc_0.w_0": rng.randn(4, 3).astype("float32"),
              "emb": rng.randn(5, 2).astype(ml_dtypes.bfloat16),
              "step": np.array([7], "int64"), "b": np.zeros(3, "float32")}
    p, q = str(tmp_path / "port"), str(tmp_path / "ref")
    proto_serde.save_combined_params(p, arrays)
    jserde.save_combined_params(q, arrays)
    with open(p, "rb") as f, open(q, "rb") as g:
        assert f.read() == g.read()
    got = proto_serde.load_combined_params(q, list(arrays))
    for k, v in arrays.items():
        np.testing.assert_array_equal(_as_float32(got[k]), _as_float32(v))


# ---------------------------------------------------------------------------
# tests/test_proto_interop.py, on the port
# ---------------------------------------------------------------------------

def _build_program():
    prog = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(prog, startup):
        x = fluid.data("x", [-1, 4])
        h = fluid.layers.fc(x, 8, act="relu")
        out = fluid.layers.fc(h, 3, act="softmax")
    return prog, startup, out


class TestProgramRoundTrip:
    def test_ops_vars_attrs_survive(self):
        prog, _, _ = _build_program()
        data = proto_serde.program_to_proto_bytes(prog)
        prog2 = proto_serde.program_from_proto_bytes(data)
        b1, b2 = prog.global_block(), prog2.global_block()
        assert [op.type for op in b1.ops] == [op.type for op in b2.ops]
        for op1, op2 in zip(b1.ops, b2.ops):
            assert op1.inputs == op2.inputs
            assert op1.outputs == op2.outputs
            for k, v in op1.attrs.items():
                if v is None:
                    continue
                got = op2.attrs[k]
                if isinstance(v, float):
                    assert got == pytest.approx(v, rel=1e-6)
                elif isinstance(v, (list, tuple)) \
                        and v and isinstance(v[0], float):
                    np.testing.assert_allclose(got, v, rtol=1e-6)
                else:
                    assert got == v or list(got) == list(v), k
        for name, v in b1.vars.items():
            v2 = b2.vars[name]
            assert v2.persistable == v.persistable, name
            if v.shape is not None:
                assert tuple(v2.shape) == tuple(v.shape), name

    def test_executes_identically_after_round_trip(self):
        prog, startup, out = _build_program()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        x = np.random.RandomState(0).randn(5, 4).astype("float32")
        (y1,) = exe.run(prog, feed={"x": x}, fetch_list=[out])
        prog2 = proto_serde.program_from_proto_bytes(
            proto_serde.program_to_proto_bytes(prog))
        (y2,) = exe.run(prog2, feed={"x": x}, fetch_list=[out.name])
        np.testing.assert_allclose(y1, y2, rtol=1e-6)

    def test_control_flow_block_attrs_survive(self):
        prog = _cond(fluid)
        data = proto_serde.program_to_proto_bytes(prog)
        prog2 = proto_serde.program_from_proto_bytes(data)
        assert len(prog2.blocks) == len(prog.blocks)
        cond_ops = [op for op in prog2.global_block().ops
                    if "true_block" in op.attrs]
        assert cond_ops
        for op in cond_ops:
            tb = op.attrs["true_block"]
            assert 0 < tb < len(prog2.blocks)
        pb = fp.ProgramDesc.FromString(data)
        block_attrs = [a for b in pb.blocks for o in b.ops
                       for a in o.attrs if a.type == fp.BLOCK]
        assert block_attrs, "block refs must be typed BLOCK on the wire"


class TestProgramProtoApi:
    def test_desc_to_string_parse(self):
        prog, _, out = _build_program()
        blob = prog.desc.SerializeToString()
        prog2 = fluid.Program.parse_from_string(blob)
        assert [o.type for o in prog2.global_block().ops] \
            == [o.type for o in prog.global_block().ops]
        text = prog.to_string(True)
        assert "blocks" in text and "ops" in text
        assert str(prog) == text
        assert text == text_format.MessageToString(
            jfp.ProgramDesc.FromString(blob))


class TestInferenceModelFormat:
    def test_save_load_run(self, tmp_path):
        prog, startup, out = _build_program()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        x = np.random.RandomState(1).randn(4, 4).astype("float32")
        (want,) = exe.run(prog, feed={"x": x}, fetch_list=[out])
        d = str(tmp_path / "model")
        fluid.io.save_inference_model(d, ["x"], [out], exe,
                                      main_program=prog)
        # __model__ parses with plain protobuf (the wire contract)
        pb = jfp.ProgramDesc()
        with open(os.path.join(d, "__model__"), "rb") as f:
            pb.ParseFromString(f.read())
        types = [op.type for op in pb.blocks[0].ops]
        assert types[0] == "feed" and types[-1] == "fetch"
        assert pb.op_version_map.pair
        prog2, feeds, fetches = fluid.io.load_inference_model(d, exe)
        assert feeds == ["x"]
        (got,) = exe.run(prog2, feed={"x": x},
                         fetch_list=[fetches[0].name])
        np.testing.assert_allclose(got, want, rtol=1e-6)

    def test_legacy_pickle_refused(self, tmp_path):
        import pickle
        d = tmp_path / "legacy"
        d.mkdir()
        with open(d / "__model__", "wb") as f:
            pickle.dump({"not": "a model"}, f)
        with pytest.raises(RuntimeError, match="pickle"):
            fluid.io.load_inference_model(str(d),
                                          fluid.Executor(fluid.CPUPlace()))


class TestReferenceFixture:
    def test_fixture_is_deterministic(self):
        with open(os.path.join(FIXTURE_DIR, "__model__"), "rb") as f:
            assert f.read() == fixture.build_model_bytes()

    def test_loads_and_runs(self):
        exe = fluid.Executor(fluid.CPUPlace())
        prog, feeds, fetches = fluid.io.load_inference_model(
            FIXTURE_DIR, exe)
        assert feeds == ["x"]
        x = np.random.RandomState(2).randn(6, 4).astype("float32")
        (got,) = exe.run(prog, feed={"x": x},
                         fetch_list=[fetches[0].name])
        np.testing.assert_allclose(got, fixture.expected_output(x),
                                   rtol=1e-5)

    def test_predictor_serves_fixture(self):
        from paddle_tpu_torch.inference import AnalysisConfig, \
            create_predictor
        cfg = AnalysisConfig(FIXTURE_DIR)
        cfg.disable_gpu()
        pred = create_predictor(cfg)
        x = np.random.RandomState(3).randn(2, 4).astype("float32")
        names = pred.get_input_names()
        pred.get_input_handle(names[0]).copy_from_cpu(x)
        pred.run()
        out = pred.get_output_handle(pred.get_output_names()[0])
        np.testing.assert_allclose(out.copy_to_cpu(),
                                   fixture.expected_output(x), rtol=1e-5)


class TestReferenceControlFlowLayout:
    """A reference-layout ProgramDesc with a while sub-block and a
    SELECTED_ROWS var parses into a structurally faithful Program."""

    def _build(self):
        pb = fp.ProgramDesc()
        b0 = pb.blocks.add()
        b0.idx, b0.parent_idx = 0, -1
        b1 = pb.blocks.add()
        b1.idx, b1.parent_idx = 1, 0
        v = b0.vars.add()
        v.name = "i"
        v.type.type = fp.VarType.LOD_TENSOR
        v.type.lod_tensor.tensor.data_type = fp.VarType.INT64
        v.type.lod_tensor.tensor.dims.extend([1])
        sr = b0.vars.add()
        sr.name = "emb_grad"
        sr.type.type = fp.VarType.SELECTED_ROWS
        sr.type.selected_rows.data_type = fp.VarType.FP32
        sr.type.selected_rows.dims.extend([100, 8])
        wop = b0.ops.add()
        wop.type = "while"
        pv = wop.inputs.add()
        pv.parameter = "X"
        pv.arguments.append("i")
        pv = wop.outputs.add()
        pv.parameter = "Out"
        pv.arguments.append("i")
        a = wop.attrs.add()
        a.name, a.type, a.block_idx = "sub_block", fp.BLOCK, 1
        inc = b1.ops.add()
        inc.type = "increment"
        pv = inc.inputs.add()
        pv.parameter = "X"
        pv.arguments.append("i")
        pv = inc.outputs.add()
        pv.parameter = "Out"
        pv.arguments.append("i")
        return pb

    def test_structure_round_trips(self):
        pb = self._build()
        prog = proto_serde.program_from_proto(pb)
        assert len(prog.blocks) == 2
        assert prog.blocks[1].parent_idx == 0
        (wop,) = prog.blocks[0].ops
        assert wop.type == "while" and wop.attrs["sub_block"] == 1
        assert prog.blocks[1].ops[0].type == "increment"
        sr = prog.global_block().vars["emb_grad"]
        assert tuple(sr.shape) == (100, 8) and sr.dtype == "float32"
        pb2 = proto_serde.program_to_proto(prog)
        battrs = [a for o in pb2.blocks[0].ops for a in o.attrs
                  if a.type == fp.BLOCK]
        assert battrs and battrs[0].block_idx == 1

    def test_out_of_order_blocks(self):
        pb = self._build()
        blocks = list(pb.blocks)
        del pb.blocks[:]
        pb.blocks.extend([blocks[1], blocks[0]])
        prog = proto_serde.program_from_proto(pb)
        assert prog.blocks[0].ops[0].type == "while"
        assert prog.blocks[1].ops[0].type == "increment"
        assert "i" not in prog.blocks[1].vars
        assert "i" in prog.blocks[0].vars


class TestTensorStreams:
    def test_lod_tensor_round_trip(self):
        arr = np.random.RandomState(0).randn(5, 7).astype("float32")
        buf = proto_serde.serialize_lod_tensor(arr, [[0, 2, 5]])
        got, got_lod, end = proto_serde.deserialize_lod_tensor(buf)
        assert end == len(buf)
        np.testing.assert_array_equal(got, arr)
        assert got_lod == [[0, 2, 5]]

    @pytest.mark.parametrize("dtype", ["float32", "float64", "int32",
                                       "int64", "uint8", "bool"])
    def test_dtypes(self, dtype):
        arr = (np.random.RandomState(1).rand(3, 4) * 10).astype(dtype)
        got, _, _ = proto_serde.deserialize_lod_tensor(
            proto_serde.serialize_lod_tensor(arr))
        np.testing.assert_array_equal(got, arr)

    def test_combined_params_round_trip(self, tmp_path):
        arrays = {"b": np.arange(3, dtype=np.float32),
                  "a": np.ones((2, 2), np.float32),
                  "c": np.zeros((1, 5), np.int64)}
        p = str(tmp_path / "params")
        proto_serde.save_combined_params(p, arrays)
        got = proto_serde.load_combined_params(p, list(arrays))
        for k in arrays:
            np.testing.assert_array_equal(got[k], arrays[k])

    def test_combined_trailing_bytes_detected(self, tmp_path):
        p = str(tmp_path / "params")
        proto_serde.save_combined_params(
            p, {"a": np.ones(2, np.float32), "b": np.ones(2, np.float32)})
        with pytest.raises(ValueError, match="trailing"):
            proto_serde.load_combined_params(p, ["a"])


def _one_dropout(version=None, op_type="dropout"):
    pb = fp.ProgramDesc()
    block = pb.blocks.add()
    block.idx, block.parent_idx = 0, -1
    op = block.ops.add()
    op.type = op_type
    if version is not None:
        pair = pb.op_version_map.pair.add()
        pair.op_name = op_type
        pair.op_version.version = version
    return pb, op


class TestOpVersionMap:
    def test_old_version_converted(self):
        pb, op = _one_dropout(0)
        pv = op.inputs.add()
        pv.parameter = "X"
        pv.arguments.append("x")
        pv = op.outputs.add()
        pv.parameter = "Out"
        pv.arguments.append("y")
        a = op.attrs.add()
        a.name, a.type, a.f = "dropout_prob", fp.FLOAT, 0.5
        prog = proto_serde.program_from_proto(pb)
        (dp,) = [o for o in prog.global_block().ops if o.type == "dropout"]
        assert dp.attrs["dropout_implementation"] == "downgrade_in_infer"

    def test_absent_map_treated_as_v0(self):
        pb, _ = _one_dropout()
        prog = proto_serde.program_from_proto(pb)
        assert prog.global_block().ops[0].attrs[
            "dropout_implementation"] == "downgrade_in_infer"

    def test_reference_version_pins_mirrored(self):
        assert opver.current_version("arg_max") == 1
        assert opver.current_version("momentum") == 1
        attrs = {}
        opver.check_and_convert("arg_max", attrs, 0)
        assert attrs == {"flatten": False}
        attrs = {}
        opver.check_and_convert("softplus", attrs, 0)
        assert attrs == {"beta": 1.0, "threshold": 20.0}
        attrs = {"flatten": True}
        opver.check_and_convert("arg_max", attrs, 1)
        assert attrs == {"flatten": True}

    def test_untracked_op_any_version_accepted(self):
        pb, _ = _one_dropout(1, "elementwise_add")
        prog = proto_serde.program_from_proto(pb)
        assert prog.global_block().ops[0].type == "elementwise_add"

    def test_empty_list_attr_is_ints_on_wire(self):
        pb_attr = fp.OpDesc.Attr()
        assert proto_serde._set_attr(pb_attr, "axes", [], "squeeze")
        assert pb_attr.type == fp.INTS

    def test_future_version_refused(self):
        pb, _ = _one_dropout(99)
        with pytest.raises(opver.OpVersionError, match="version 99"):
            proto_serde.program_from_proto(pb)

    def test_registry_is_the_references(self):
        from paddle_tpu.fluid import op_version_registry as jopver
        assert opver._VERSIONS == jopver._VERSIONS
        for key in jopver._CONVERTERS:
            a, b = {}, {}
            opver._CONVERTERS[key](a)
            jopver._CONVERTERS[key](b)
            assert a == b, key


class TestOpVersionCheckerUtils:
    def test_checker_reflects_registry(self):
        from paddle_tpu_torch.utils.op_version import OpLastCheckpointChecker
        c = OpLastCheckpointChecker()
        assert c.version("arg_max") == 1
        assert c.check_add("arg_max") == ["flatten"]
        assert c.check_add("softplus") == ["beta", "threshold"]
        assert c.check_add("softplus", "beta") == ["beta"]
        assert c.check_add("relu") == []


# ---------------------------------------------------------------------------
# a model saved by either package loads in the other
# ---------------------------------------------------------------------------

def _fc_model(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.data("x", [-1, 8])
        h = pkg.layers.fc(x, 16, act="relu")
        out = pkg.layers.fc(h, 3, act="softmax")
    return main, startup, out


@pytest.mark.parametrize("params_filename", [None, "params"])
def test_reference_export_loads_in_port(params_filename, tmp_path, rng):
    main, startup, out = _fc_model(jfluid)
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup)
    x = rng.randn(5, 8).astype("float32")
    (want,) = exe.run(main, feed={"x": x}, fetch_list=[out])
    d = str(tmp_path / "ref")
    jfluid.io.save_inference_model(d, ["x"], [out], exe, main_program=main,
                                   params_filename=params_filename)
    texe = fluid.Executor(fluid.CPUPlace())
    prog, feeds, fetches = fluid.io.load_inference_model(
        d, texe, params_filename=params_filename)
    assert feeds == ["x"] and [v.name for v in fetches] == [out.name]
    (got,) = texe.run(prog, feed={"x": x}, fetch_list=[out.name])
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("params_filename", [None, "params"])
def test_port_export_loads_in_reference(params_filename, tmp_path, rng):
    main, startup, out = _fc_model(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    x = rng.randn(5, 8).astype("float32")
    (want,) = exe.run(main, feed={"x": x}, fetch_list=[out])
    d = str(tmp_path / "port")
    fluid.io.save_inference_model(d, ["x"], [out], exe, main_program=main,
                                  params_filename=params_filename)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    prog, feeds, fetches = jfluid.io.load_inference_model(
        d, jexe, params_filename=params_filename)
    assert feeds == ["x"] and [v.name for v in fetches] == [out.name]
    (got,) = jexe.run(prog, feed={"x": x}, fetch_list=[out.name])
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=ATOL)


def test_per_var_files_load_in_both(tmp_path, rng):
    """The reference's per-var LoDTensor files (the fixture's layout),
    written by the port, load in both packages."""
    main, startup, out = _fc_model(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    x = rng.randn(3, 8).astype("float32")
    (want,) = exe.run(main, feed={"x": x}, fetch_list=[out])
    d = str(tmp_path / "pervar")
    fluid.io.save_inference_model(d, ["x"], [out], exe, main_program=main,
                                  program_only=True)
    scope = tcore.global_scope()
    for v in fluid.io.get_program_persistable_vars(main):
        with open(os.path.join(d, v.name), "wb") as f:
            f.write(proto_serde.serialize_lod_tensor(scope.find_var(v.name)))
    prog, _, fetches = fluid.io.load_inference_model(d, exe)
    (got,) = exe.run(prog, feed={"x": x}, fetch_list=[fetches[0].name])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jprog, _, jfetches = jfluid.io.load_inference_model(d, jexe)
    (jgot,) = jexe.run(jprog, feed={"x": x}, fetch_list=[jfetches[0].name])
    np.testing.assert_allclose(np.asarray(jgot), want, rtol=RTOL, atol=ATOL)
