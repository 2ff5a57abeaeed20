"""paddle_tpu_torch's IR against paddle_tpu's on the small static BERT.

Shape inference (the port runs lowerings on meta tensors, the reference
under jax.eval_shape), ``clone(for_test=True)``, and the frozen +
``fuse_attention`` op stream must agree op for op — if the port's shapes
were wrong, fuse_attention would decline in silence and the kernel would
never run.
"""
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import trace as jtrace
from paddle_tpu.models.static_graphs import \
    build_bert_train_program as j_build
from paddle_tpu.serving import freeze_program as j_freeze

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import trace as ttrace
from paddle_tpu_torch.models.static_graphs import \
    build_bert_train_program as t_build
from paddle_tpu_torch.serving import freeze_program as t_freeze

SMALL = dict(vocab=64, hidden=32, heads=4, seq=16, layers=2, dropout=0.1)


@pytest.fixture(autouse=True)
def _fresh_port_names():
    tframework.reset_unique_name()
    yield


def _both(**cfg):
    """(jax main, port main, logits name); both start from fresh name
    counters, so their var names agree.  The port builds the forward
    program (``train=False``), up to the logits."""
    jmain, _, _ = j_build(**cfg)
    tmain, _, logits = t_build(train=False, **cfg)
    return jmain, tmain, logits.name


def test_shape_inference_matches_reference():
    jmain, tmain, _ = _both(**SMALL)
    jb, tb = jmain.global_block(), tmain.global_block()
    # inference declined nowhere: every var of the port's program has a
    # shape, and the 4-d attention operands are all there
    assert all(tv.shape is not None for tv in tb.vars.values())
    assert sum(len(tv.shape) == 4 for tv in tb.vars.values()) >= \
        SMALL["layers"] * 8
    for name, tv in tb.vars.items():
        jv = jb.var(name)
        assert tv.shape == jv.shape, (name, tv.shape, jv.shape)
        if tv.dtype.startswith("float"):
            assert tv.dtype == jv.dtype, name
    # parameters: same names, same order, same shapes
    assert [(p.name, p.shape) for p in tmain.all_parameters()] == \
        [(p.name, p.shape) for p in jmain.all_parameters()]


def _program_with_training_tail(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", [-1, 4])
        h = fluid.layers.fc(x, 3, act="relu")
        out = fluid.layers.scale(h, scale=2.0)
        blk = main.global_block()
        w = main.all_parameters()[0]
        blk.append_op("relu_grad", inputs={"X": [h]},
                      outputs={"Out": ["h@GRAD"]})
        blk.append_op("scale", inputs={"X": [h]},
                      outputs={"Out": ["backward_only"]},
                      attrs={"scale": 3.0, "op_role": 1})
        blk.append_op("sgd", inputs={"Param": [w], "Grad": [w],
                                     "LearningRate": [w]},
                      outputs={"ParamOut": [w]})
    return main, out


def test_clone_for_test_drops_what_reference_drops():
    jmain, jout = _program_with_training_tail(jfluid)
    tframework.reset_unique_name()
    tmain, tout = _program_with_training_tail(tfluid)
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    jc, tc = jmain.clone(for_test=True), tmain.clone(for_test=True)
    kept = [op.type for op in tc.global_block().ops]
    assert kept == [op.type for op in jc.global_block().ops]
    assert "sgd" not in kept and "relu_grad" not in kept
    assert tc._hints["is_test"] is True
    assert tout.name == jout.name


def _fuse(freeze, compiled_cls, strategy_cls, main, logits):
    frozen = freeze(main, ["ids", "attn_mask"], [logits])
    bs = strategy_cls()
    bs.fuse_attention = True
    cp = compiled_cls(frozen, bs)
    cp._apply_ir_passes([logits])
    return frozen


@pytest.mark.parametrize("layers", [1, 2, 3])
def test_frozen_fused_op_stream_matches_reference(layers):
    cfg = dict(SMALL, layers=layers)
    jmain, tmain, logits = _both(**cfg)
    jc = jtrace.metrics().counter("kernel_tier.fuse_attention.rewrites")
    tc = ttrace.metrics().counter("kernel_tier.fuse_attention.rewrites")
    j0, t0 = jc.value, tc.value
    jf = _fuse(j_freeze, jfluid.CompiledProgram, jfluid.BuildStrategy,
               jmain, logits)
    tf = _fuse(t_freeze, tfluid.CompiledProgram, tfluid.BuildStrategy,
               tmain, logits)
    t_ops = [op.type for op in tf.global_block().ops]
    assert t_ops == [op.type for op in jf.global_block().ops]
    assert t_ops.count("fused_multihead_attention") == layers
    for absent in ("softmax", "dropout", "matmul", "relu"):
        assert absent not in t_ops
    assert tc.value - t0 == layers
    assert jc.value - j0 == layers
    # the fused ops carry the same attrs (scale, absorbed dropout)
    for jo, to in zip(jf.global_block().ops, tf.global_block().ops):
        if to.type == "fused_multihead_attention":
            assert to.inputs == jo.inputs and to.outputs == jo.outputs
            assert {k: v for k, v in to.attrs.items()} == \
                {k: v for k, v in jo.attrs.items()}
    assert tf._hints["is_test"] is True


def test_fuse_attention_declines_without_4d_shapes():
    _, tmain, logits = _both(**SMALL)
    frozen = t_freeze(tmain, ["ids", "attn_mask"], [logits])
    for v in frozen.global_block().vars.values():
        if v.name.startswith("transpose2"):
            v.shape = None                    # as if inference had failed
    bs = tfluid.BuildStrategy()
    bs.fuse_attention = True
    cp = tfluid.CompiledProgram(frozen, bs)
    cp._apply_ir_passes([logits])
    assert "fused_multihead_attention" not in \
        [op.type for op in frozen.global_block().ops]
