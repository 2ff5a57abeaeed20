"""The fused inference tier of paddle_tpu_torch against paddle_tpu (op
types 402 -> 437): Paddle Inference's fused ERNIE ops
(``fused_embedding_eltwise_layernorm``, ``fc``, ``multihead_matmul``,
``skip_layernorm``, ``fused_fc_elementwise_layernorm``), the rest of the
fused op family and the nn tail, the recurrent fusions, the catalog
tail's ``rnn``, ``attention_lstm``, ``bilateral_slice``,
``fusion_conv_inception`` and ``py_func``, and ``fusion_group``.

- Each op type on seeded numpy inputs in both packages (``OP_CASES``,
  every branch the lowerings have): outputs within rtol 1e-5 (and 1e-5
  of the output's largest value), integers equal; ``generic_grad`` from
  one random cotangent within rtol 1e-4 where the reference registers a
  gradient.  The op sweep (``test_torch_op_sweep.py``) takes the first
  case of each type its probes cannot feed from here.
- ``py_func``: one host callable registered in each package, the two
  lowerings and the two static programs of the builder equal; no copy
  on the host.
- ``chip_smoke.ernie_fused_program`` at vocab 64, hidden 32, 4 heads, 2
  layers, FFN 64, seq 16 in both packages from one reference
  ``BertModel``'s ``state_dict`` packed by ``ernie_fused_params``: the op
  lists equal, sequence and pooled outputs within rtol 1e-5 of each
  other and of the port's eager ``BertModel`` with the same weights
  (``interop.layer_from_numpy``, its dropouts off); the reference's
  ``save_inference_model`` of the program served by the port's
  ``load_inference_model`` and ``AnalysisPredictor``.
- The builders (``add_position_encoding``, ``fsp_matrix``,
  ``similarity_focus``, ``contrib.layers.correlation`` and
  ``bilateral_slice``) in static programs of both packages: op lists and
  outputs equal.
- Each reference quirk the port copies, held in both packages.
"""
import os
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.contrib.layers as jcl
import paddle_tpu.fluid as jfluid
from paddle_tpu.dygraph import base as jdy
from paddle_tpu.fluid.core import Scope as JScope, scope_guard as jguard
from paddle_tpu.fluid.framework import reset_unique_name as j_reset
from paddle_tpu.models.bert import BertModel as JBertModel
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops import catalog_tail_ops as jtail
from paddle_tpu.ops import registry as jreg

import paddle_tpu_torch.contrib.layers as tcl
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.dygraph import base as tdy
from paddle_tpu_torch.fluid.framework import reset_unique_name as t_reset
from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
from paddle_tpu_torch.models.bert import BertModel as TBertModel
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import catalog_tail_ops as ttail
from paddle_tpu_torch.ops import registry as treg

import chip_smoke as C

jax.config.update("jax_platforms", "cpu")

RTOL = 1e-5
GRAD_RTOL = 1e-4

FUSED_OPS = (
    "multihead_matmul", "fused_embedding_eltwise_layernorm", "fc",
    "skip_layernorm", "fused_fc_elementwise_layernorm",
    "add_position_encoding", "crop", "expand_as", "unpool", "segment_pool",
    "similarity_focus", "lstm_unit", "frobenius_norm", "fsp", "inplace_abn",
    "interpolate", "interpolate_v2", "correlation",
    "fused_bn_add_activation", "conv_fusion", "fusion_repeated_fc_relu",
    "fusion_squared_mat_sub", "fusion_transpose_flatten_concat",
    "fusion_seqexpand_concat_fc", "fusion_seqconv_eltadd_relu",
    "fusion_gru", "fusion_lstm", "multi_gru", "fused_embedding_fc_lstm",
    "rnn", "attention_lstm", "bilateral_slice", "fusion_conv_inception",
    "py_func", "fusion_group")

ERNIE_HOST = dict(vocab=64, hidden=32, heads=4, layers=2, ffn=64,
                  positions=16, types=2, seq=16)
BERT_HOST = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                 intermediate_size=64, max_position=16)
ROWS = 3

R = np.random.RandomState(28)


def _f(*shape, scale=1.0):
    return (R.randn(*shape) * scale).astype("float32")


def _ids(high, *shape):
    return R.randint(0, high, shape).astype("int64")


def _unpool_indices(n, c, h, w):
    """Each pooled cell's argmax inside its 2x2 window of a [2h, 2w]
    map."""
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    di, dj = R.randint(0, 2, (2, n, c, h, w))
    return ((2 * ii + di) * 2 * w + 2 * jj + dj).astype("int32")


_MASK = np.where(np.arange(16)[None, :] < np.array([[16], [9], [4]]),
                 0.0, -1e4).astype("float32").reshape(3, 1, 1, 16)
_BN = {"Scale": _f(3), "Bias": _f(3), "Mean": _f(3, scale=0.1),
       "Variance": np.abs(_f(3)) + 0.5}

# {label: (op, inputs, attrs)}; the first case of a type is the one the
# op sweep takes when its probes cannot feed the type
OP_CASES = {
    "multihead_matmul": ("multihead_matmul",
                         {"Input": _f(3, 16, 3 * 4 * 8), "BiasQK": _MASK},
                         {"head_number": 4, "alpha": 8 ** -0.5}),
    "multihead_matmul, no BiasQK, no alpha": (
        "multihead_matmul", {"Input": _f(2, 8, 3 * 2 * 16)},
        {"head_number": 2}),
    "fused_embedding_eltwise_layernorm": (
        "fused_embedding_eltwise_layernorm",
        {"Ids": [_ids(64, 3, 16), _ids(16, 3, 16), _ids(2, 3, 16)],
         "Embs": [_f(64, 32), _f(16, 32), _f(2, 32)], "Scale": _f(32),
         "Bias": _f(32)}, {"epsilon": 1e-5}),
    "fused_embedding_eltwise_layernorm, ids [B, T, 1]": (
        "fused_embedding_eltwise_layernorm",
        {"Ids": [_ids(20, 2, 5, 1), _ids(5, 2, 5, 1)],
         "Embs": [_f(20, 8), _f(5, 8)], "Scale": _f(8), "Bias": _f(8)},
        {"epsilon": 1e-12}),
    "fc, in_num_col_dims 2": ("fc", {"Input": _f(3, 16, 32),
                                     "W": _f(32, 48), "Bias": _f(48)},
                              {"in_num_col_dims": 2}),
    "fc, tanh (the pooler)": ("fc", {"Input": _f(3, 1, 32), "W": _f(32, 32),
                                     "Bias": _f(32)},
                              {"in_num_col_dims": 1,
                               "activation_type": "tanh"}),
    "fc, gelu (tanh form), no bias": ("fc", {"Input": _f(4, 6),
                                             "W": _f(6, 5)},
                                      {"activation_type": "gelu"}),
    "fc, relu": ("fc", {"Input": _f(4, 6), "W": _f(6, 5), "Bias": _f(5)},
                 {"activation_type": "relu"}),
    "skip_layernorm": ("skip_layernorm",
                       {"X": _f(3, 16, 32), "Y": _f(3, 16, 32),
                        "Scale": _f(32), "Bias": _f(32)},
                       {"epsilon": 1e-5}),
    "skip_layernorm, no scale or bias": ("skip_layernorm",
                                         {"X": _f(4, 6), "Y": _f(4, 6)},
                                         {}),
    "fused_fc_elementwise_layernorm": (
        "fused_fc_elementwise_layernorm",
        {"X": _f(48, 64), "W": _f(64, 32), "Bias0": _f(32),
         "Y": _f(48, 32), "Scale": _f(32), "Bias1": _f(32)},
        {"epsilon": 1e-5}),
    "fused_fc_elementwise_layernorm, 3-d X flattened by axis 0": (
        "fused_fc_elementwise_layernorm",
        {"X": _f(2, 4, 3), "W": _f(12, 5), "Y": _f(2, 5)}, {}),
    "add_position_encoding": ("add_position_encoding", {"X": _f(3, 16, 32)},
                              {"alpha": 0.5, "beta": 2.0}),
    "crop, Y and Offsets": ("crop", {"X": _f(4, 6, 5), "Y": _f(2, 3, 4),
                                     "Offsets": np.array([1, 2, 0],
                                                         "int32")}, {}),
    "crop, attrs": ("crop", {"X": _f(4, 6, 5)},
                    {"shape": [2, 3, 4], "offsets": [1, 1, 1]}),
    "expand_as": ("expand_as", {"X": _f(2, 3),
                                "target_tensor": _f(4, 6)}, {}),
    "unpool": ("unpool", {"X": _f(2, 3, 3, 4),
                          "Indices": _unpool_indices(2, 3, 3, 4)},
               {"unpooled_height": 6, "unpooled_width": 8}),
    **{f"segment_pool, {p}": ("segment_pool",
                              {"X": _f(7, 4),
                               "SegmentIds": np.array([0, 0, 1, 2, 2, 2,
                                                       3])},
                              {"pooltype": p})
       for p in ("SUM", "MEAN", "MAX", "MIN")},
    "similarity_focus": ("similarity_focus", {"X": _f(2, 3, 4, 5)},
                         {"axis": 1, "indexes": [0, 2]}),
    "similarity_focus, axis 2": ("similarity_focus", {"X": _f(2, 3, 4, 5)},
                                 {"axis": 2, "indexes": [1]}),
    "lstm_unit": ("lstm_unit", {"X": _f(4, 32), "C_prev": _f(4, 8)},
                  {"forget_bias": 0.5}),
    "frobenius_norm": ("frobenius_norm", {"X": _f(3, 4, 5)},
                       {"dim": [1, 2], "keep_dim": True}),
    "frobenius_norm, every axis": ("frobenius_norm", {"X": _f(3, 4)}, {}),
    "fsp": ("fsp", {"X": _f(2, 3, 4, 5), "Y": _f(2, 6, 4, 5)}, {}),
    "inplace_abn": ("inplace_abn", dict(_BN, X=_f(2, 3, 4, 5)),
                    {"activation": "leaky_relu"}),
    "inplace_abn, is_test, sigmoid": ("inplace_abn",
                                      dict(_BN, X=_f(2, 3, 4, 5)),
                                      {"activation": "sigmoid",
                                       "is_test": True}),
    "interpolate": ("interpolate", {"X": _f(2, 3, 4, 5)},
                    {"interp_method": "bilinear", "out_h": 7, "out_w": 3}),
    "interpolate_v2": ("interpolate_v2", {"X": _f(2, 3, 4, 5)},
                       {"interp_method": "nearest", "out_h": 8,
                        "out_w": 10}),
    "interpolate, bicubic": ("interpolate", {"X": _f(1, 2, 4, 4)},
                             {"interp_method": "bicubic", "out_h": 6,
                              "out_w": 5, "align_corners": True}),
    "correlation": ("correlation", {"Input1": _f(1, 4, 6, 7),
                                    "Input2": _f(1, 4, 6, 7)},
                    {"pad_size": 2, "kernel_size": 1,
                     "max_displacement": 2, "stride1": 1, "stride2": 2}),
    "fused_bn_add_activation": ("fused_bn_add_activation",
                                dict(_BN, X=_f(2, 3, 4, 5),
                                     Z=_f(2, 3, 4, 5)),
                                {"act_type": "relu"}),
    "conv_fusion": ("conv_fusion",
                    {"Input": _f(2, 4, 6, 6), "Filter": _f(5, 4, 3, 3),
                     "Bias": _f(5), "ResidualData": _f(2, 5, 6, 6)},
                    {"paddings": [1, 1], "activation": "sigmoid"}),
    "conv_fusion, relu, stride 2": ("conv_fusion",
                                    {"Input": _f(2, 4, 7, 7),
                                     "Filter": _f(3, 4, 3, 3)},
                                    {"strides": [2, 2]}),
    "fusion_repeated_fc_relu": ("fusion_repeated_fc_relu",
                                {"X": _f(4, 2, 3),
                                 "W": [_f(6, 8), _f(8, 5)],
                                 "Bias": [_f(8), _f(5)]}, {}),
    "fusion_squared_mat_sub": ("fusion_squared_mat_sub",
                               {"X": _f(4, 6), "Y": _f(6, 5)},
                               {"scalar": 0.5}),
    "fusion_transpose_flatten_concat": (
        "fusion_transpose_flatten_concat",
        {"X": [_f(2, 4, 3, 3), _f(2, 6, 2, 2)]},
        {"trans_axis": [0, 2, 3, 1], "flatten_axis": 1, "concat_axis": 1}),
    "fusion_seqexpand_concat_fc": (
        "fusion_seqexpand_concat_fc",
        {"X": [_f(2, 5, 4), _f(2, 3), _f(2, 6)], "FCWeight": _f(13, 7),
         "FCBias": _f(7)}, {"fc_activation": "tanh"}),
    "fusion_seqconv_eltadd_relu": (
        "fusion_seqconv_eltadd_relu",
        {"X": _f(2, 6, 4), "Filter": _f(12, 5), "Bias": _f(5)},
        {"contextLength": 3, "contextStart": -1}),
    "fusion_gru": ("fusion_gru", {"X": _f(2, 5, 4), "WeightX": _f(4, 24),
                                  "WeightH": _f(8, 24, scale=0.3),
                                  "Bias": _f(1, 24), "H0": _f(2, 8)}, {}),
    "fusion_lstm": ("fusion_lstm", {"X": _f(2, 5, 4), "WeightX": _f(4, 32),
                                    "WeightH": _f(8, 32, scale=0.3),
                                    "Bias": _f(1, 32), "H0": _f(2, 8),
                                    "C0": _f(2, 8)}, {}),
    "fusion_lstm, peepholes": ("fusion_lstm",
                               {"X": _f(2, 5, 4), "WeightX": _f(4, 32),
                                "WeightH": _f(8, 32, scale=0.3),
                                "Bias": _f(1, 56)}, {}),
    "multi_gru": ("multi_gru", {"X": _f(2, 5, 4),
                                "WeightX": [_f(4, 24), _f(8, 24)],
                                "WeightH": [_f(8, 24, scale=0.3),
                                            _f(8, 24, scale=0.3)],
                                "Bias": [_f(1, 24), _f(1, 24)]}, {}),
    "fused_embedding_fc_lstm": ("fused_embedding_fc_lstm",
                                {"Ids": _ids(10, 2, 5),
                                 "Embeddings": _f(10, 32),
                                 "WeightH": _f(8, 32, scale=0.3),
                                 "Bias": _f(1, 32)}, {}),
    **{f"rnn, {mode}": ("rnn",
                        {"Input": _f(2, 5, 4),
                         "WeightList": [_f(4, g), _f(g, 8, scale=0.3),
                                        _f(g), _f(g),
                                        _f(8, g), _f(g, 8, scale=0.3),
                                        _f(g), _f(g)]},
                        {"mode": mode, "num_layers": 2, "hidden_size": 8})
       for mode, g in (("LSTM", 32), ("GRU", 24), ("RNN_TANH", 8),
                       ("RNN_RELU", 8))},
    "attention_lstm": ("attention_lstm",
                       {"X": _f(2, 5, 4), "AttentionWeight": _f(12, 1),
                        "LSTMWeight": _f(12, 32, scale=0.3),
                        "LSTMBias": _f(1, 32)}, {}),
    "attention_lstm, H0 and C0": ("attention_lstm",
                                  {"X": _f(2, 5, 4),
                                   "AttentionWeight": _f(12, 1),
                                   "LSTMWeight": _f(12, 32, scale=0.3),
                                   "LSTMBias": _f(1, 32), "H0": _f(2, 8),
                                   "C0": _f(2, 8)}, {}),
    "bilateral_slice": ("bilateral_slice",
                        {"X": _f(2, 3, 6, 5), "Grid": _f(2, 2, 4, 3, 3),
                         "Guide": R.uniform(0, 1, (2, 6, 5))
                         .astype("float32")}, {"has_offset": False}),
    "fusion_conv_inception": ("fusion_conv_inception",
                              {"Input": _f(2, 4, 6, 6),
                               "Filter": [_f(3, 4, 1, 1), _f(5, 4, 3, 3)],
                               "Bias": [_f(3), _f(5)]}, {}),
    "fusion_group": ("fusion_group", {"Inputs": [_f(2, 3), _f(4)]}, {}),
}


def _listed(v):
    return v if isinstance(v, list) else [v]


# the reference's lowerings of these read an input's values on the host,
# so they run eagerly; the rest run under jax.jit (one compile a case,
# where op-by-op dispatch compiles every primitive)
EAGER_OPS = ("crop", "segment_pool")


def _jnp(ins):
    return {k: [jnp.asarray(np.asarray(a)) for a in _listed(v)]
            for k, v in ins.items()}


def _torch(ins):
    return {k: [torch.from_numpy(np.array(a)) for a in _listed(v)]
            for k, v in ins.items()}


def _ref_fn(op, attrs):
    def fn(ins):
        return jreg.get_op(op).fn(ins, dict(attrs), jreg.LoweringContext())
    return fn


def _reference(op, ins, attrs):
    """The reference's lowering of ``op`` on ``ins``, jnp arrays by
    slot."""
    fn = _ref_fn(op, attrs)
    return (fn if op in EAGER_OPS else jax.jit(fn))(ins)


def grad_inputs(op, ins, attrs, outs):
    """``generic_grad``'s attrs and numpy inputs for ``op``: the forward
    inputs and one random cotangent of each float output (``outs``: the
    reference's forward outputs, or their shapes), over each float input
    the op differentiates."""
    jdef = jreg.get_op(op)
    slots = [s for s, v in ins.items() if s not in jdef.nondiff_inputs
             and np.asarray(_listed(v)[0]).dtype.kind == "f"]
    rng = np.random.RandomState(5)
    cots = {s: [np.asarray(rng.randn(*np.shape(a)), "float32") for a in vs]
            for s, vs in outs.items() if s not in jdef.nondiff_outputs
            and all(np.dtype(a.dtype).kind == "f" for a in vs)}
    assert cots and slots, op
    gattrs = {"fwd_type": op, "fwd_attrs": attrs, "grad_slots": slots,
              "in_slots": list(ins)}
    gins = {"I_" + s: [np.array(a) for a in _listed(v)]
            for s, v in ins.items()}
    gins.update({"G_" + s: cs for s, cs in cots.items()})
    return gattrs, gins


def check_generic_grad(gattrs, gins, want):
    """The port's ``generic_grad`` on ``gins`` against the reference's
    ``want``: every input gradient within GRAD_RTOL."""
    got = treg.get_op("generic_grad").fn(_torch(gins), dict(gattrs),
                                         treg.LoweringContext())
    assert sorted(want) == sorted(got) == sorted(
        "GI_" + s for s in gattrs["grad_slots"])
    assert_outputs_match(want, got, GRAD_RTOL,
                         f"{gattrs['fwd_type']} generic_grad")


def assert_outputs_match(ref, port, rtol, what):
    assert sorted(ref) == sorted(port), what
    for slot, vals in ref.items():
        assert len(vals) == len(port[slot]), (what, slot)
        for i, (w, g) in enumerate(zip(vals, port[slot])):
            w = np.asarray(w)
            g = g.detach().numpy() if isinstance(g, torch.Tensor) \
                else np.asarray(g)
            assert g.shape == w.shape, (what, slot, g.shape, w.shape)
            if w.dtype.kind == "f":
                np.testing.assert_allclose(
                    g, w, rtol=rtol,
                    atol=rtol * (np.abs(w).max() if w.size else 0) + 1e-7,
                    err_msg=f"{what}: {slot}[{i}]")
            else:
                np.testing.assert_array_equal(g, w, f"{what}: {slot}[{i}]")


def test_the_35_op_types_are_registered():
    assert len(set(FUSED_OPS)) == 35
    assert set(FUSED_OPS) <= set(treg.all_ops()) & set(jreg.all_ops())
    assert len(treg.all_ops()) == 488
    assert not set(treg.all_ops()) - set(jreg.all_ops())
    assert set(FUSED_OPS) - {"py_func"} == {op for op, _, _ in
                                            OP_CASES.values()}


_RUNS = {}


def _run_case(case):
    """The reference's outputs of ``OP_CASES[case]`` and, where it
    registers a gradient, ``generic_grad``'s attrs, inputs and the
    reference's result, computed once for both tests; a jitted case
    compiles its forward and gradient as one program (the cotangents'
    shapes from ``jax.eval_shape``)."""
    if case not in _RUNS:
        op, ins, attrs = OP_CASES[case]
        fwd, grad = _ref_fn(op, attrs), None
        if not jreg.get_op(op).differentiable:
            ref = _reference(op, _jnp(ins), attrs)
        elif op in EAGER_OPS:
            ref = fwd(_jnp(ins))
            gattrs, gins = grad_inputs(op, ins, attrs, ref)
            grad = gattrs, gins, _ref_fn("generic_grad", gattrs)(_jnp(gins))
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


def test_interpolate_refuses_a_method_no_op_computes():
    for reg, t in ((jreg, jnp.asarray), (treg, torch.from_numpy)):
        with pytest.raises(NotImplementedError, match="linear"):
            reg.get_op("interpolate").fn(
                {"X": [t(_f(1, 2, 4))]}, {"interp_method": "linear"}, None)


# --- py_func -----------------------------------------------------------------
def _host_fn(a, b):
    return [np.tanh(a) * b, (a + b).sum(axis=1)]


def test_py_func_lowering_matches_reference():
    x, y = _f(3, 4), _f(3, 4)
    attrs = {"out_shapes": [[3, 4], [3]],
             "out_dtypes": ["float32", "float32"]}
    ttail._py_func.copies = 0
    ref = jreg.get_op("py_func").fn(
        {"X": [jnp.asarray(x), jnp.asarray(y)]},
        dict(attrs, forward_callable_id=jtail.register_py_func(_host_fn)),
        None)
    port = treg.get_op("py_func").fn(
        {"X": [torch.from_numpy(x), torch.from_numpy(y)]},
        dict(attrs, forward_callable_id=ttail.register_py_func(_host_fn)),
        treg.LoweringContext())
    assert_outputs_match(ref, port, RTOL, "py_func")
    assert ttail._py_func.copies == 0       # nothing crossed to a card
    assert not treg.get_op("py_func").differentiable


def _py_func_program(fluid):
    x = fluid.data("x", [3, 4])
    out = fluid.default_main_program().global_block().create_var(
        name="py_out", shape=[3, 4], dtype="float32")
    return fluid.layers.py_func(lambda a: np.exp(a) - 1.0, x, out)


def test_py_func_builder_matches_reference():
    x = _f(3, 4)
    got = []
    for fluid, reset, exe in (
            (jfluid, j_reset, jfluid.Executor),
            (tfluid, t_reset, lambda: tfluid.Executor(tfluid.CPUPlace()))):
        reset()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            out = _py_func_program(fluid)
        got.append(([op.type for op in main.global_block().ops],
                    np.asarray(exe().run(main, feed={"x": x},
                                         fetch_list=[out])[0])))
    assert got[0][0] == got[1][0] == ["py_func"]
    np.testing.assert_allclose(got[1][1], got[0][1], rtol=RTOL)
    np.testing.assert_allclose(got[1][1], np.expm1(x), rtol=1e-5,
                               atol=1e-6)


# --- the fused ERNIE program -------------------------------------------------
def _ernie_feed(seed):
    return C.ernie_feed(ERNIE_HOST, ROWS, seed)


@pytest.fixture(scope="module")
def ernie():
    """The reference's BertModel state (dropouts off), its packed
    parameters, and each package's fused program run on one feed."""
    np.random.seed(0)
    with jdy.guard():
        jm = JBertModel(**BERT_HOST, **C.ERNIE_EAGER_DROPOUT)
        jm.eval()
        state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    params = C.ernie_fused_params(state)
    feed = _ernie_feed(1)
    out = {"state": state, "params": params, "feed": feed}
    for name, fluid, reset in (("ref", jfluid, j_reset),
                               ("port", tfluid, t_reset)):
        reset()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            fetch = C.ernie_fused_program(fluid, ERNIE_HOST)
        if name == "ref":
            exe, scope = jfluid.Executor(), JScope()
            with jguard(scope):
                for n, v in params.items():
                    scope.set_var(n, jnp.asarray(v))
                got = exe.run(main, feed=feed, fetch_list=list(fetch))
                with tempfile.TemporaryDirectory() as d:
                    jfluid.io.save_inference_model(
                        d, list(C.ERNIE_FEEDS), list(fetch), exe,
                        main_program=main, params_filename="params")
                    out["saved"] = {f: open(os.path.join(d, f), "rb").read()
                                    for f in os.listdir(d)}
        else:
            scope = interop.scope_from_numpy(params, tfluid.Scope(),
                                             tfluid.CPUPlace())
            got = tfluid.Executor(tfluid.CPUPlace()).run(
                main, feed=feed, fetch_list=list(fetch), scope=scope)
        out[name] = {"types": [op.type for op in main.global_block().ops],
                     "out": [np.asarray(g) for g in got]}
    return out


def _close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(g), w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max(),
                                   err_msg=f"{what}: output {i}")


def test_ernie_program_op_list(ernie):
    types = ernie["port"]["types"]
    assert types == ernie["ref"]["types"]
    want = C.ernie_fused_types(ERNIE_HOST["layers"])
    assert {t: types.count(t) for t in want} == want
    assert len(types) == sum(want.values())


def test_ernie_program_matches_reference(ernie):
    got, want = ernie["port"]["out"], ernie["ref"]["out"]
    assert [g.shape for g in got] == [(ROWS, 16, 32), (ROWS, 32)]
    _close(got, want, "fused ERNIE program")


def test_ernie_program_matches_eager_bert(ernie):
    """The port's eager BertModel with the reference's weights gives the
    fused program's outputs, and the packed weight's Q and K swapped
    gives others."""
    with tdy.guard(tfluid.CPUPlace()):
        tm = TBertModel(**BERT_HOST, **C.ERNIE_EAGER_DROPOUT)
        tm.eval()
        interop.layer_from_numpy(tm, ernie["state"])
        eager = C.ernie_eager(tm, tdy.to_variable, ernie["feed"])
    _close(ernie["port"]["out"], eager, "fused program against eager")
    twin = C.ernie_qk_swapped(ernie["params"], ERNIE_HOST["hidden"])
    t_reset()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        fetch = C.ernie_fused_program(tfluid, ERNIE_HOST)
    scope = interop.scope_from_numpy(twin, tfluid.Scope(), tfluid.CPUPlace())
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed=ernie["feed"], fetch_list=list(fetch), scope=scope)
    assert C.ernie_err(got, eager) > 100 * RTOL


def test_reference_saved_ernie_program_served_by_port(ernie):
    with tempfile.TemporaryDirectory() as d:
        for name, blob in ernie["saved"].items():
            with open(os.path.join(d, name), "wb") as f:
                f.write(blob)
        lscope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        with tfluid.scope_guard(lscope):
            prog, feeds, fetches = tfluid.io.load_inference_model(
                d, exe, params_filename="params")
        assert feeds == list(C.ERNIE_FEEDS)

        def loaded(f):
            return exe.run(prog, feed={n: f[n] for n in feeds},
                           fetch_list=fetches, scope=lscope)
        _close(loaded(ernie["feed"]), ernie["ref"]["out"],
               "load_inference_model")
        with tfluid.scope_guard(tfluid.Scope()):
            config = AnalysisConfig(d, params_file=os.path.join(d, "params"))
            config.disable_gpu()
            config.switch_ir_optim(True)
            pred = create_predictor(config)
            for rows in (1, ROWS):
                f = C.ernie_feed(ERNIE_HOST, rows, 2)
                served = C._ernie_serve(pred, f)
                assert [s.shape for s in served] == \
                    [(rows, 16, 32), (rows, 32)]
                _close(served, loaded(f), f"predictor at {rows} rows")


# --- the builders --------------------------------------------------------------
def _builders(fluid, cl):
    L = fluid.layers
    x = fluid.data("x", [2, 3, 8])
    m = fluid.data("m", [2, 3, 4, 5])
    n = fluid.data("n", [2, 6, 4, 5])
    guide = fluid.data("guide", [2, 6, 5])
    grid = fluid.data("grid", [2, 2, 4, 3, 3])
    return [L.add_position_encoding(x, alpha=0.5, beta=1.5),
            L.fsp_matrix(m, n), L.similarity_focus(m, 1, [0, 2]),
            cl.correlation(m, L.scale(m, 2.0), 1, 1, 1, 1, 1),
            cl.bilateral_slice(m, guide, grid)]


def test_builders_match_reference():
    feed = {"x": _f(2, 3, 8), "m": _f(2, 3, 4, 5), "n": _f(2, 6, 4, 5),
            "guide": R.uniform(0, 1, (2, 6, 5)).astype("float32"),
            "grid": _f(2, 2, 4, 3, 3)}
    got = []
    for fluid, cl, reset, exe in (
            (jfluid, jcl, j_reset, jfluid.Executor),
            (tfluid, tcl, t_reset,
             lambda: tfluid.Executor(tfluid.CPUPlace()))):
        reset()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            outs = _builders(fluid, cl)
        got.append(([op.type for op in main.global_block().ops],
                    [np.asarray(v) for v in exe().run(main, feed=feed,
                                                      fetch_list=outs)]))
    assert got[0][0] == got[1][0]
    assert got[1][0] == ["add_position_encoding", "fsp", "similarity_focus",
                         "scale", "correlation", "bilateral_slice"]
    for i, (w, g) in enumerate(zip(got[0][1], got[1][1])):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-6,
                                   err_msg=str(i))


# --- the reference's quirks, held in both packages ---------------------------
def _run(reg, op, ins, attrs):
    if reg is jreg:
        outs = _reference(op, _jnp(ins), attrs)
    else:
        outs = treg.get_op(op).fn(_torch(ins), dict(attrs),
                                  treg.LoweringContext())
    return {k: [np.asarray(o.detach().numpy() if isinstance(o, torch.Tensor)
                           else o) for o in v] for k, v in outs.items()}


def _gelu_tanh(x):
    return 0.5 * x * (1 + np.tanh(np.sqrt(2 / np.pi)
                                  * (x + 0.044715 * x ** 3)))


def _quirk_fc_gelu_is_tanh(reg):
    """fc's gelu is the tanh form, the gelu op the erf form."""
    x, w = _f(5, 6, scale=2.0), np.eye(6, dtype="float32")
    fc = _run(reg, "fc", {"Input": x, "W": w},
              {"activation_type": "gelu"})["Out"][0]
    op = _run(reg, "gelu", {"X": x}, {})["Out"][0]
    np.testing.assert_allclose(fc, _gelu_tanh(x), rtol=1e-5, atol=1e-6)
    assert np.abs(fc - op).max() > 1e-4


def _quirk_fused_fc_ln_flattens_by_axis_0(reg):
    """X [2, 4, 3] is read as [2, 12], whatever its declared column
    dims: the op needs W [12, n] and Y [2, n]."""
    x, w, y = _f(2, 4, 3), _f(12, 5), _f(2, 5)
    out = _run(reg, "fused_fc_elementwise_layernorm",
               {"X": x, "W": w, "Y": y}, {"x_num_col_dims": 2})["Out"][0]
    h = x.reshape(2, 12) @ w + y
    want = (h - h.mean(-1, keepdims=True)) / np.sqrt(
        h.var(-1, keepdims=True) + 1e-5)
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5)


def _quirk_correlation_wraps_and_reads_no_padding(reg):
    """The displaced map wraps around its edges, and pad_size,
    kernel_size and stride1 change nothing."""
    a, b = _f(1, 2, 4, 5), _f(1, 2, 4, 5)
    outs = [_run(reg, "correlation", {"Input1": a, "Input2": b},
                 {"max_displacement": 1, "stride2": 1, "pad_size": p,
                  "kernel_size": k, "stride1": s})["Output"][0]
            for p, k, s in ((0, 1, 1), (4, 3, 2))]
    np.testing.assert_array_equal(outs[0], outs[1])
    # displacement (-1, -1), channel 0: the product with b rolled by it
    want = (a * np.roll(b, (-1, -1), axis=(2, 3))).mean(1)
    np.testing.assert_allclose(outs[0][:, 0], want, rtol=1e-5, atol=1e-6)
    assert outs[0][0, 0, -1, -1] != 0.0     # the wrapped corner


def _quirk_fusion_group_is_identity(reg):
    xs = [_f(2, 3), _f(4)]
    outs = _run(reg, "fusion_group", {"Inputs": xs},
                {"func_name": "fused_add_relu", "type": 0})["Outs"]
    for o, x in zip(outs, xs):
        np.testing.assert_array_equal(o, x)


def _quirk_fusion_transpose_flatten_concat_reads_no_flatten_axis(reg):
    xs = [_f(2, 3, 4), _f(2, 5, 4)]
    outs = [_run(reg, "fusion_transpose_flatten_concat", {"X": xs},
                 {"trans_axis": [0, 2, 1], "flatten_axis": f,
                  "concat_axis": 1})["Out"][0] for f in (1, 2)]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].shape == (2, 32)


def _quirk_bilateral_slice_reads_no_x(reg):
    ins = dict(OP_CASES["bilateral_slice"][1])
    outs = [_run(reg, "bilateral_slice", dict(ins, X=x),
                 {"has_offset": off})["Out"][0]
            for x, off in ((ins["X"], False), (2 * ins["X"] + 1, True))]
    np.testing.assert_array_equal(outs[0], outs[1])


def _quirk_rnn_reads_no_prestate(reg):
    ins = {"Input": _f(2, 4, 3),
           "WeightList": [_f(3, 8), _f(8, 8, scale=0.3), _f(8), _f(8)]}
    attrs = {"mode": "RNN_TANH", "num_layers": 1, "hidden_size": 8}
    outs = [_run(reg, "rnn", dict(ins, **extra), attrs)["Out"][0]
            for extra in ({}, {"PreState": [_f(1, 2, 8)],
                               "SequenceLength": np.array([1, 2])})]
    np.testing.assert_array_equal(outs[0], outs[1])


def _quirk_bert_embedding_dropout_downgrades(reg):
    """The eager BertModel's embedding Dropout is fluid's
    downgrade_in_infer: in eval it scales its output by 1 - p (a BERT
    exported with upscale_in_train has no such scale)."""
    mod, dy, guard = (jbert, jdy, jdy.guard) if reg is jreg else \
        (tbert, tdy, lambda: tdy.guard(tfluid.CPUPlace()))
    ids = _ids(64, 2, 8)
    outs = []
    with guard():
        emb = mod.BertEmbeddings(64, 16, 8, dropout=0.1)
        emb.eval()
        for p in (0.0, 0.1):
            emb.dropout._p = p
            outs.append(np.asarray(emb(dy.to_variable(ids)).numpy()))
    np.testing.assert_allclose(outs[1], 0.9 * outs[0], rtol=1e-6,
                               atol=1e-7)


QUIRKS = {f.__name__[len("_quirk_"):]: f for f in (
    _quirk_fc_gelu_is_tanh, _quirk_fused_fc_ln_flattens_by_axis_0,
    _quirk_correlation_wraps_and_reads_no_padding,
    _quirk_fusion_group_is_identity,
    _quirk_fusion_transpose_flatten_concat_reads_no_flatten_axis,
    _quirk_bilateral_slice_reads_no_x, _quirk_rnn_reads_no_prestate,
    _quirk_bert_embedding_dropout_downgrades)}


@pytest.mark.parametrize("pkg", ["reference", "port"])
@pytest.mark.parametrize("quirk", sorted(QUIRKS))
def test_reference_quirk_held_in_both_packages(quirk, pkg):
    QUIRKS[quirk](jreg if pkg == "reference" else treg)
