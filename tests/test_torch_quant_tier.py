"""The quantization tier of paddle_tpu_torch against paddle_tpu, and the
small op remainders that came with it (op types 367 -> 402).

- The 15 quant op types on seeded numpy inputs in both packages, at
  ``bit_length`` 8 and 4: integer codes equal, floats within rtol 1e-5
  (and 1e-6 of the output's largest value), except elements exactly one
  quant step apart (a product an ulp away lands on the other side of a
  half-to-even ``round``), which may be at most 0.1% of an output.  Their
  straight-through ``generic_grad`` (dX = dOut) within rtol 1e-4; the
  moving-average state (``OutAccum``, ``OutState``) threaded through
  three calls; the ``is_test`` branches; ``quantize`` and ``requantize``
  only inside [-128, 127] (outside, the cast's wrap is no contract).
- ``contrib.slim``'s passes on the small static BERT of ``chip_smoke``'s
  ``qat_bert_program`` (2 layers, hidden 32, 4 heads, seq 16) in both
  packages: the op-type lists after ``quant_aware``, after
  ``BuildStrategy(kernel_tier=True)`` and after ``convert``, equal (with
  dropout 0.1: no fused attention, one ``fused_adam``); with dropout 0,
  the losses of 3 steps within rtol 1e-5, the first step's gradients
  within rtol 1e-4 and 1e-6 of the largest gradient of any parameter (as
  ``test_torch_training.py``: the key bias's gradient is rounding noise),
  every ``@QUANT_SCALE`` within rtol 1e-5 and ``_quant_scales`` equal.
- ``PostTrainingQuantization`` under ``abs_max`` and the histogram: the
  scales within rtol 1e-5 (weights equal), ``quant_scales.json``'s keys
  equal.
- The dygraph QAT on LeNet: the class swap, the forward within rtol 1e-5
  of the largest logit, ``ImperativeCalcOutScale``'s thresholds within
  rtol 1e-5, no gradient on any quantized weight in either package, and
  ``save_quantized_model`` (the reference's raises; the port's
  round-trips through ``jit.load`` bit for bit).
- The remainder op types the op sweep cannot feed, the ties of
  ``top_k_v2`` and ``kthvalue``, ``random_crop``'s contract, the new
  ``fluid.layers`` builders, and the book's recommender through
  ``cos_sim`` from one scope: losses within rtol 1e-5.
- Each reference quirk the port copies has a test, in both packages.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax

import paddle_tpu.fluid as jfluid
from paddle_tpu.dygraph import base as jdy
from paddle_tpu.fluid.core import Scope as JScope, scope_guard as jguard
from paddle_tpu.fluid.framework import reset_unique_name as j_reset
from paddle_tpu.models.static_graphs import bert_demo_feed
from paddle_tpu.ops import registry as jreg
from paddle_tpu.vision.models import LeNet as JLeNet

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import interop, jit as tjit
from paddle_tpu_torch.dygraph import base as tdy
from paddle_tpu_torch.fluid.framework import reset_unique_name as t_reset
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.vision.models import LeNet as TLeNet

import chip_smoke as C
from test_torch_op_sweep import (_jctx, _tctx, assert_outputs_match,
                                 run_both)
from test_torch_op_sweep_grad import check_generic_grad

jax.config.update("jax_platforms", "cpu")

RTOL = 1e-5
ONE_STEP_SHARE = 1e-3

QUANT_OPS = (
    "fake_quantize_abs_max", "fake_quantize_dequantize_abs_max",
    "fake_channel_wise_quantize_abs_max",
    "fake_channel_wise_quantize_dequantize_abs_max",
    "fake_quantize_range_abs_max", "fake_quantize_moving_average_abs_max",
    "fake_quantize_dequantize_moving_average_abs_max",
    "fake_dequantize_max_abs", "fake_channel_wise_dequantize_max_abs",
    "dequantize_abs_max", "dequantize_log", "quantize", "dequantize",
    "requantize", "moving_average_abs_max_scale")
REMAINDER_OPS = (
    "bmm", "cos_sim", "isfinite", "l1_norm", "pow", "squared_l2_distance",
    "squared_l2_norm", "diag_embed", "size", "space_to_depth", "squeeze",
    "unsqueeze", "unique_with_counts", "top_k_v2", "kthvalue",
    "precision_recall", "mean_iou", "random_crop", "seed",
    "lookup_table_dequant")


def _r(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype("float32")


def _codes(shape, bits, seed):
    q = (1 << (bits - 1)) - 1
    return np.random.RandomState(seed).randint(-q, q + 1, shape) \
        .astype("float32")


def test_the_35_op_types_are_registered():
    new = set(QUANT_OPS) | set(REMAINDER_OPS)
    assert len(new) == 35
    assert new <= set(treg.all_ops()) & set(jreg.all_ops())
    assert len(treg.all_ops()) == 488
    assert not set(treg.all_ops()) - set(jreg.all_ops())


# --- the quant op types --------------------------------------------------------
def _quant_cases(bits):
    """{label: (op, inputs, attrs, the step of one code in the output, or
    None where the output is no quantized value)}."""
    q = float((1 << (bits - 1)) - 1)
    x = _r(16, 12, seed=1)
    w4 = _r(6, 4, 3, 3, seed=2)
    w2 = _r(12, 10, seed=3)
    amax = float(np.abs(x).max())
    state = {"InScale": np.array([0.8 * amax], "float32"),
             "InAccum": np.array([2.5], "float32"),
             "InState": np.array([1.9], "float32")}
    b = {"bit_length": bits}
    cw4 = np.abs(w4).max(axis=(1, 2, 3)).reshape(-1, 1, 1, 1)
    cw2 = np.abs(w2).max(axis=0).reshape(1, -1)
    return {
        "fake_quantize_abs_max": ("fake_quantize_abs_max", {"X": x}, b, 1.0),
        "fake_quantize_dequantize_abs_max": (
            "fake_quantize_dequantize_abs_max", {"X": x}, b, amax / q),
        "fake_channel_wise_quantize_abs_max (filter, axis 0)": (
            "fake_channel_wise_quantize_abs_max", {"X": w4},
            dict(b, quant_axis=0), 1.0),
        "fake_channel_wise_quantize_dequantize_abs_max (filter, axis 0)": (
            "fake_channel_wise_quantize_dequantize_abs_max", {"X": w4},
            dict(b, quant_axis=0), cw4 / q),
        "fake_channel_wise_quantize_dequantize_abs_max (Y, axis 1)": (
            "fake_channel_wise_quantize_dequantize_abs_max", {"X": w2},
            dict(b, quant_axis=1), cw2 / q),
        "fake_quantize_range_abs_max (scale below)": (
            "fake_quantize_range_abs_max",
            {"X": x, "InScale": state["InScale"],
             "Iter": np.array([3], "int64")}, dict(b, window_size=4), 1.0),
        "fake_quantize_range_abs_max (scale above)": (
            "fake_quantize_range_abs_max",
            {"X": x, "InScale": np.array([2 * amax], "float32"),
             "Iter": np.array([3], "int64")}, b, 1.0),
        "fake_quantize_moving_average_abs_max": (
            "fake_quantize_moving_average_abs_max", dict(state, X=x),
            dict(b, moving_rate=0.8), 1.0),
        "fake_quantize_dequantize_moving_average_abs_max": (
            "fake_quantize_dequantize_moving_average_abs_max",
            dict(state, X=x), dict(b, moving_rate=0.8), None),
        "moving_average_abs_max_scale": (
            "moving_average_abs_max_scale",
            {"X": x, "InAccum": state["InAccum"],
             "InState": state["InState"]}, {"moving_rate": 0.8}, None),
        "fake_dequantize_max_abs": (
            "fake_dequantize_max_abs",
            {"X": _codes((16, 12), bits, 4),
             "Scale": np.array([amax], "float32")}, {"max_range": q}, None),
        "fake_channel_wise_dequantize_max_abs (one scale)": (
            "fake_channel_wise_dequantize_max_abs",
            {"X": _codes((6, 4, 3, 3), bits, 5),
             "Scales": [cw4.reshape(-1)]},
            {"quant_bits": [bits], "quant_axis": 0}, None),
        "fake_channel_wise_dequantize_max_abs (two scales)": (
            "fake_channel_wise_dequantize_max_abs",
            {"X": _codes((12, 10), bits, 6),
             "Scales": [cw2.reshape(-1), np.array([1.7], "float32")]},
            {"quant_bits": [bits, 8], "quant_axis": 1}, None),
        "dequantize_abs_max": (
            "dequantize_abs_max",
            {"X": _codes((16, 12), bits, 7).astype("int8"),
             "Scale": np.array([amax], "float32")}, {"max_range": q},
            None),
        "dequantize_log": (
            "dequantize_log",
            {"X": np.random.RandomState(8).randint(-128, 128, (16, 12))
             .astype("int8"),
             "Dict": np.exp2(np.linspace(-7, 0, 128)).astype("float32")},
            {}, None),
        "quantize": ("quantize", {"Input": x},
                     {"Scale": 100.0 / amax, "Shift": 3.0}, None),
        "dequantize": ("dequantize",
                       {"Input": _codes((16, 12), 8, 9).astype("int8")},
                       {"Scale": 41.5, "Shift": 2.0}, None),
        "requantize": ("requantize",
                       {"Input": _codes((16, 12), 8, 10).astype("int8")},
                       {"Scale_in": 40.0, "Scale_out": 25.0}, None),
    }


QUANT_CASES = sorted(_quant_cases(8))
# bit_length 4 where the op reads it (the dequantizers take it from
# max_range or quant_bits, the int8 ops not at all)
FAKE_CASES = [c for c in QUANT_CASES if c.startswith(("fake_quantize",
                                                      "fake_channel_wise_q"))]


def assert_quant_close(got, want, step, what):
    """Within RTOL but for elements exactly one quant ``step`` apart,
    at most ONE_STEP_SHARE of them."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    tol = RTOL * np.abs(want) + 1e-6 * np.abs(want).max() + 1e-12
    d = np.abs(got - want)
    off = d > tol
    one = off & (np.abs(d - np.broadcast_to(step, d.shape)) <= 1e-5 * step
                 + tol)
    assert not (off & ~one).any(), (what, d.max())
    assert one.mean() <= ONE_STEP_SHARE, (what, int(one.sum()))


@pytest.mark.parametrize("case,bits", [(c, 8) for c in QUANT_CASES]
                         + [(c, 4) for c in FAKE_CASES])
def test_quant_op_matches_reference(case, bits):
    op, ins, attrs, step = _quant_cases(bits)[case]
    ref, port = run_both(op, ins, attrs)
    if step is None:
        assert_outputs_match(ref, port, RTOL, case)
        return
    for slot in ref:
        if slot == "Out":
            assert_quant_close(port[slot][0].numpy(), ref[slot][0], step,
                               case)
        else:
            assert_outputs_match({slot: ref[slot]}, {slot: port[slot]},
                                 RTOL, case)


@pytest.mark.parametrize("case", FAKE_CASES + ["moving_average_abs_max_scale"])
def test_fake_quant_generic_grad_is_straight_through(case):
    op, ins, attrs, _ = _quant_cases(8)[case]
    check_generic_grad(op, ins, attrs, ["X"], rtol=1e-4)
    g = np.random.RandomState(3).randn(*ins["X"].shape).astype("float32")
    got = treg.get_op("generic_grad").fn(
        {**{"I_" + k: [torch.from_numpy(np.array(v))] for k, v in
            ins.items()}, "G_Out": [torch.from_numpy(g)]},
        {"fwd_type": op, "fwd_attrs": attrs, "grad_slots": ["X"],
         "in_slots": list(ins)}, _tctx())
    np.testing.assert_array_equal(got["GI_X"][0].numpy(), g)


@pytest.mark.parametrize("op", [
    "fake_quantize_moving_average_abs_max",
    "fake_quantize_dequantize_moving_average_abs_max",
    "moving_average_abs_max_scale"])
def test_moving_average_state_over_three_calls(op):
    """OutAccum and OutState fed back as the next call's InAccum and
    InState (and OutScale as InScale), three calls of rising range."""
    state = {"InScale": np.array([1.0], "float32"),
             "InAccum": np.array([1.0], "float32"),
             "InState": np.array([1.0], "float32")}
    if op == "moving_average_abs_max_scale":
        del state["InScale"]
    for call in range(3):
        ins = dict(state, X=_r(8, 6, seed=20 + call, scale=1.0 + call))
        ref, port = run_both(op, ins, {"moving_rate": 0.9})
        assert_outputs_match(ref, port, RTOL, f"{op} call {call}")
        state = {k: np.asarray(ref[k.replace("In", "Out")][0])
                 for k in state}
    # 0.9 * (0.9 * (0.9 + 1) + 1) + 1 after three calls from 1
    np.testing.assert_allclose(port["OutState"][0].numpy(), [3.439],
                               rtol=1e-6)


@pytest.mark.parametrize("where", ["attr", "context"])
@pytest.mark.parametrize("op", [
    "fake_quantize_range_abs_max", "fake_quantize_moving_average_abs_max",
    "fake_quantize_dequantize_moving_average_abs_max"])
def test_is_test_reads_the_recorded_scale(op, where):
    x = _r(8, 6, seed=30)
    ins = {"X": x, "InScale": np.array([0.5], "float32"),
           "InAccum": np.array([3.0], "float32"),
           "InState": np.array([2.0], "float32"),
           "Iter": np.array([1], "int64")}
    if op == "fake_quantize_range_abs_max":
        del ins["InAccum"], ins["InState"]
    else:
        del ins["Iter"]
    attrs = {"is_test": True} if where == "attr" else {}
    ref, port = run_both(op, ins, attrs, is_test=where == "context")
    assert_outputs_match(ref, port, RTOL, op)
    np.testing.assert_array_equal(port["OutScale"][0].numpy(), [0.5])


def test_range_abs_max_reads_no_window_or_iter():
    """A reference quirk the port copies: ``window_size`` and ``Iter``
    change nothing; the scale is max(abs max, InScale)."""
    x = _r(8, 6, seed=31)
    for run in (run_both,):
        outs = [run("fake_quantize_range_abs_max",
                    {"X": x, "InScale": np.array([0.1], "float32"),
                     "Iter": np.array([it], "int64")},
                    {"window_size": w}) for it, w in ((0, 1), (7, 10000))]
        for k in range(2):
            a, b = (np.asarray(o[k]["OutScale"][0]) for o in outs)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(a, [np.abs(x).max()], rtol=1e-7)


def test_quantize_casts_within_int8():
    """Inside [-128, 127] the codes are the reference's; half-way values
    round to even in both."""
    x = np.array([[-128.0, -2.5, -0.5, 0.5, 1.5, 126.5, 127.0]], "float32")
    ref, port = run_both("quantize", {"Input": x}, {"Scale": 1.0})
    np.testing.assert_array_equal(port["Output"][0].numpy(),
                                  [[-128, -2, 0, 0, 2, 126, 127]])
    np.testing.assert_array_equal(np.asarray(ref["Output"][0]),
                                  port["Output"][0].numpy())
    q = np.array([[-127, -5, 3, 100]], "int8")
    ref, port = run_both("requantize", {"Input": q},
                         {"Scale_in": 2.0, "Scale_out": 1.0})
    np.testing.assert_array_equal(port["Output"][0].numpy(),
                                  [[-64, -2, 2, 50]])
    assert port["Output"][0].dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(ref["Output"][0]),
                                  port["Output"][0].numpy())


# --- the static flow: quant_aware, the kernel tier, convert --------------------
def _qat_built(fluid, reset, cfg, **kw):
    reset()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        loss, logits, pg = C.qat_bert_program(fluid, cfg, **kw)
    startup.random_seed = 0
    return main, startup, loss, logits, pg


def _types(program):
    return [op.type for op in program.global_block().ops]


def _tier(fluid, main, loss):
    bs = fluid.BuildStrategy()
    bs.kernel_tier = True
    prog = fluid.CompiledProgram(main, bs)
    prog._apply_ir_passes([loss.name])
    return prog


def _op_lists(fluid, reset):
    """The op types after quant_aware, after the kernel tier and after
    convert of the test clone, and the clone's _quant_scales."""
    main, _, loss, _, _ = _qat_built(fluid, reset, C.QAT_HOST)
    before = _types(main)
    _tier(fluid, main, loss)
    after = _types(main)
    test = fluid.contrib.slim.quantization.convert(
        main.clone(for_test=True))
    return before, after, _types(test), dict(test._quant_scales)


def test_op_lists_after_the_passes_equal_the_reference():
    ref = _op_lists(jfluid, j_reset)
    port = _op_lists(tfluid, t_reset)
    assert port == ref
    before, after, frozen, scales = port
    # a layer's activations: the block's input (Q, K and V share it),
    # both matmuls' X and the ReLU fc's input; its weights: 4 muls' and
    # both matmuls' Y; the classifier's input and weight
    assert before.count("fake_quantize_dequantize_abs_max") == \
        4 * C.QAT_HOST["layers"] + 1
    assert before.count(
        "fake_channel_wise_quantize_dequantize_abs_max") == \
        6 * C.QAT_HOST["layers"] + 1
    assert after.count("fused_adam") == 1
    assert "fused_multihead_attention" not in after
    assert after.count("softmax") == after.count("dropout") == \
        C.QAT_HOST["layers"]
    assert not any(t.startswith("fake_") for t in frozen)
    assert len(scales) == before.count("fake_quantize_dequantize_abs_max") \
        + before.count("fake_channel_wise_quantize_dequantize_abs_max")


@pytest.fixture(scope="module")
def static_runs():
    """Both packages' 3 QAT steps at dropout 0 from the reference's
    startup state: losses, the first step's gradients and scales."""
    cfg = dict(C.QAT_HOST, dropout=0.0)
    feed = bert_demo_feed(np.random.RandomState(0), batch=8,
                          seq=cfg["seq"], vocab=cfg["vocab"])
    main, startup, loss, _, pg = _qat_built(jfluid, j_reset, cfg)
    scales = sorted(n for n in main.global_block().vars
                    if n.endswith("@QUANT_SCALE"))
    exe, scope = jfluid.Executor(), JScope()
    with jguard(scope):
        exe.run(startup)
        init = {n: np.array(scope.find_var(n))
                for n, v in main.global_block().vars.items()
                if v.persistable and scope.find_var(n) is not None}
        prog = _tier(jfluid, main, loss)
        fetch = [loss] + [g for _, g in pg] + scales
        ref = [exe.run(prog, feed=feed, fetch_list=fetch) for _ in range(3)]
    main, _, loss, _, pg = _qat_built(tfluid, t_reset, cfg)
    prog = _tier(tfluid, main, loss)
    scope = interop.scope_from_numpy(init, tfluid.Scope(), tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    fetch = [loss] + [g for _, g in pg] + scales
    port = [exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
            for _ in range(3)]
    return dict(ref=ref, port=port, n_grads=len(pg), init=init, feed=feed)


def test_qat_steps_match_reference(static_runs):
    ref, port, n = static_runs["ref"], static_runs["port"], \
        static_runs["n_grads"]
    np.testing.assert_allclose([float(np.ravel(o[0])[0]) for o in port],
                               [float(np.ravel(o[0])[0]) for o in ref],
                               rtol=RTOL)
    grads_r, grads_p = ref[0][1:1 + n], port[0][1:1 + n]
    top = max(np.abs(np.asarray(g)).max() for g in grads_r)
    for w, g in zip(grads_r, grads_p):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-6 * top)
    for w, g in zip(ref[0][1 + n:], port[0][1 + n:]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=RTOL)


def test_grad_var_shapes_match_the_reference():
    """Every ``@GRAD`` var the reference gives a shape (the parameters'
    gradients, ``sum`` and ``fill_constant`` outputs) has the same shape
    in the port, and the port's shape inference, which runs each
    ``generic_grad`` on meta tensors, gives every other one a shape too
    (the reference skips ``generic_grad``)."""
    def shapes(fluid, reset):
        main = _qat_built(fluid, reset, C.QAT_HOST)[0]
        return {n: v.shape for n, v in main.global_block().vars.items()
                if "@GRAD" in n}
    ref, port = shapes(jfluid, j_reset), shapes(tfluid, t_reset)
    assert sorted(ref) == sorted(port)
    known = {n: tuple(s) for n, s in ref.items() if s is not None}
    assert len(known) >= 20
    assert {n: tuple(port[n]) for n in known} == known
    assert all(s is not None for s in port.values())


def test_frozen_program_differs_from_qat_by_its_quantization(static_runs):
    """``convert`` of the test clone drops the fake ops and nothing else:
    the QAT test program with every fake op at 24 bits (a step under
    float32's rounding) gives the frozen program's logits within 1e-5
    (relative L2); at 8 bits it is farther (the quantization noise).
    Phase 4w (b) holds the same at BERT-base's width on the card."""
    main, _, _, logits, _ = _qat_built(tfluid, t_reset, C.QAT_HOST)
    fine = main.clone(for_test=True)
    for op in fine.global_block().ops:
        if op.type.startswith("fake_"):
            op.attrs["bit_length"] = 24
    scope = interop.scope_from_numpy(static_runs["init"], tfluid.Scope(),
                                     tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    frozen, fine, qat = (
        exe.run(p, feed=static_runs["feed"], fetch_list=[logits],
                scope=scope)[0]
        for p in (tfluid.contrib.slim.quantization.convert(
            main.clone(for_test=True)), fine, main.clone(for_test=True)))
    noise = [float(np.linalg.norm(o - frozen) / np.linalg.norm(frozen))
             for o in (fine, qat)]
    assert noise[0] <= 1e-5 < noise[1], noise


def test_freeze_keeps_float_weights_and_scale_names():
    """Reference quirks the port copies: the freeze takes the fake ops
    out and reads the float weights again (no int8 weight), recording
    ``{input: scale var}`` on the program object only."""
    for fluid, reset in ((jfluid, j_reset), (tfluid, t_reset)):
        main, _, loss, _, _ = _qat_built(fluid, reset, C.QAT_HOST,
                                         train=False)
        test = fluid.contrib.slim.quantization.convert(main.clone())
        muls = [op for op in test.global_block().ops if op.type == "mul"]
        assert all(not n.endswith("@QUANT_DEQUANT")
                   for op in muls for n in op.input("Y"))
        assert all(isinstance(test.global_block().var(op.input("Y")[0]),
                              fluid.framework.Parameter) for op in muls)
        assert all(v.endswith("@QUANT_SCALE")
                   for v in test._quant_scales.values())


def test_transform_quirks():
    """The transform never reads ``activation_quantize_type`` (always the
    per-tensor abs-max quant-dequant) and quantizes matmul's Y as a
    weight, channel-wise on axis 1; a per-tensor weight type swaps the
    weight ops only."""
    for fluid, reset in ((jfluid, j_reset), (tfluid, t_reset)):
        lists = []
        for kw in ({"activation_quantize_type": "abs_max"},
                   {"activation_quantize_type": "range_abs_max"},
                   {"weight_quantize_type": "abs_max"}):
            reset()
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup):
                C.qat_bert_program(fluid, C.QAT_HOST, train=False,
                                   quant=False)
            fluid.contrib.slim.quantization.QuantizationTransformPass(
                **kw).apply(main)
            lists.append([(op.type, op.attrs.get("quant_axis"))
                          for op in main.global_block().ops])
            matmul_y = [op.input("Y")[0] for op in main.global_block().ops
                        if op.type == "matmul"]
            assert all(n.endswith("@QUANT_DEQUANT") for n in matmul_y)
        assert lists[0] == lists[1]
        assert ("fake_channel_wise_quantize_dequantize_abs_max", 1) \
            in lists[0]
        assert not any(t.startswith("fake_channel") for t, _ in lists[2])


def test_hint_and_identity_passes():
    """ConvertToInt8Pass and OutScaleForTrainingPass only set hints; the
    mobile and mkldnn passes are the identity; AddQuantDequantPass puts a
    quant-dequant before elementwise_add's inputs."""
    for fluid, reset in ((jfluid, j_reset), (tfluid, t_reset)):
        q = fluid.contrib.slim.quantization
        main, _, _, _, _ = _qat_built(fluid, reset, C.QAT_HOST,
                                      train=False, quant=False)
        before = _types(main)
        q.ConvertToInt8Pass().apply(main)
        q.OutScaleForTrainingPass(moving_rate=0.8).apply(main)
        for p in (q.TransformForMobilePass(), q.OutScaleForInferencePass(),
                  q.Quant2Int8MkldnnPass(), q.QuantInt8MkldnnPass()):
            assert p.apply(main) is main
        assert _types(main) == before
        assert main._hints["int8_weights"] is True
        assert main._hints["out_scales"]["moving_rate"] == 0.8
        q.AddQuantDequantPass().apply(main)
        adds = [op for op in main.global_block().ops
                if op.type == "elementwise_add"]
        assert all(n.endswith("@QUANT_DEQUANT")
                   for op in adds for n in op.input("X"))


def test_weight_quantization_only_copies(tmp_path):
    src = tmp_path / "model"
    src.mkdir()
    (src / "__model__").write_bytes(b"\x01\x02")
    (src / "w").write_bytes(b"\x03")
    for pkg, fluid in (("ref", jfluid), ("port", tfluid)):
        out = fluid.contrib.slim.quantization.WeightQuantization(
            str(src)).quantize_weight_to_int(str(tmp_path / pkg))
        assert sorted(os.listdir(out)) == ["__model__", "w"]
        assert (tmp_path / pkg / "__model__").read_bytes() == b"\x01\x02"


def test_quantize_transpiler_is_the_slim_passes():
    got = []
    for fluid, reset in ((jfluid, j_reset), (tfluid, t_reset)):
        reset()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            C.qat_bert_program(fluid, C.QAT_HOST, train=False, quant=False)
        t = fluid.contrib.QuantizeTranspiler(weight_bits=8,
                                             activation_bits=8)
        assert fluid.contrib.quantize.QuantizeTranspiler is type(t)
        t.training_transpile(main)
        quanted = _types(main)
        t.freeze_program(main)
        got.append((quanted, _types(main)))
    assert got[0] == got[1]
    assert "fake_quantize_dequantize_abs_max" in got[1][0]


def test_contrib_surface_resolves():
    import paddle_tpu.contrib.slim.quantization as jq
    import paddle_tpu_torch.contrib.slim.quantization as tq
    import paddle_tpu.contrib.slim.quantization.imperative.quant_nn as jn
    import paddle_tpu_torch.contrib.slim.quantization.imperative.quant_nn \
        as tn

    def public(m):
        return {n for n in dir(m) if not n.startswith("_")
                and not isinstance(getattr(m, n), type(os))}
    assert public(jq) <= public(tq)
    assert set(jn.__all__) == set(tn.__all__)
    assert tfluid.contrib.slim.quantization is tq
    assert "slim" in tfluid.contrib.__all__
    assert "QuantizeTranspiler" in tfluid.contrib.__all__


# --- post-training quantization -----------------------------------------------
def test_post_training_quantization_matches_reference(tmp_path):
    cfg = dict(C.QAT_HOST, dropout=0.0)
    feeds = [bert_demo_feed(np.random.RandomState(s), batch=8,
                            seq=cfg["seq"], vocab=cfg["vocab"])
             for s in range(4)]
    got = {}
    main, startup, _, logits, _ = _qat_built(jfluid, j_reset, cfg,
                                             train=False, quant=False)
    exe, scope = jfluid.Executor(), JScope()
    with jguard(scope):
        exe.run(startup)
        init = {n: np.array(scope.find_var(n))
                for n, v in main.global_block().vars.items()
                if v.persistable and scope.find_var(n) is not None}
        for algo in ("abs_max", "hist"):
            ptq = jfluid.contrib.slim.quantization.PostTrainingQuantization(
                exe, main, ["ids"], [logits], data_loader=lambda: iter(feeds),
                batch_nums=4, algo=algo)
            ptq.quantize()
            ptq.save_quantized_model(str(tmp_path / f"ref_{algo}"))
    main, _, _, logits, _ = _qat_built(tfluid, t_reset, cfg, train=False,
                                       quant=False)
    scope = interop.scope_from_numpy(init, tfluid.Scope(), tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(scope):
        for algo in ("abs_max", "hist"):
            ptq = tfluid.contrib.slim.quantization.PostTrainingQuantization(
                exe, main, ["ids"], [logits],
                data_loader=lambda: iter(feeds), batch_nums=4, algo=algo)
            ptq.quantize()
            ptq.save_quantized_model(str(tmp_path / f"port_{algo}"))
    for algo in ("abs_max", "hist"):
        want, got = (json.load(open(tmp_path / f"{p}_{algo}" /
                                    "quant_scales.json"))
                     for p in ("ref", "port"))
        assert sorted(got) == sorted(want)
        for k in ("activations", "weights"):
            assert sorted(got[k]) == sorted(want[k]), (algo, k)
        assert len(want["activations"]) > len(want["weights"]) > 0
        for n, v in want["activations"].items():
            np.testing.assert_allclose(got["activations"][n], v, rtol=RTOL,
                                       err_msg=f"{algo} {n}")
        for n, v in want["weights"].items():
            np.testing.assert_array_equal(got["weights"][n], v)


# --- the dygraph QAT -------------------------------------------------------------
def _lenet_run(pkg, state, x, calls=2):
    """LeNet through ImperativeQuantAware (+ ImperativeCalcOutScale) in
    ``pkg``: (the swapped classes, the forward of ``calls`` calls, the
    thresholds, {param: gradient or None} after a backward)."""
    if pkg == "ref":
        fluid, dy, Net = jfluid, jdy, JLeNet
        dy.enable_dygraph()
    else:
        fluid, dy, Net = tfluid, tdy, TLeNet
        dy.enable_dygraph(tfluid.CPUPlace())
    try:
        q = fluid.contrib.slim.quantization
        net = Net()
        q.ImperativeQuantAware().quantize(net)
        if state is None:
            state = net.state_dict()
        else:
            interop.layer_from_numpy(net, state)
        scale = q.ImperativeCalcOutScale()
        scale.calc_out_scale(net)
        classes = [type(l).__name__ for l in net.sublayers()]
        outs = [net(dy.to_variable(x)).numpy() for _ in range(calls)]
        thresholds = [getattr(l, "_out_threshold", None)
                      for l in net.sublayers()]
        fluid.layers.mean(net(dy.to_variable(x))).backward()
        grads = {n: (None if p.gradient() is None
                     else np.asarray(p.gradient()))
                 for n, p in net.named_parameters()}
        return dict(state=state, classes=classes, outs=outs,
                    thresholds=thresholds, grads=grads, net=net)
    finally:
        dy.disable_dygraph()


@pytest.fixture(scope="module")
def lenet_runs():
    x = np.random.RandomState(40).randn(2, 1, 28, 28).astype("float32")
    ref = _lenet_run("ref", None, x)
    return ref, _lenet_run("port", ref["state"], x), x


def test_imperative_qat_matches_reference(lenet_runs):
    ref, port, _ = lenet_runs
    assert port["classes"] == ref["classes"]
    assert port["classes"].count("QuantizedConv2D") == 2
    assert port["classes"].count("QuantizedLinear") == 3
    for w, g in zip(ref["outs"], port["outs"]):
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max())
    t_ref = [t for t in ref["thresholds"] if t is not None]
    t_port = [t for t in port["thresholds"] if t is not None]
    assert len(t_port) == len(t_ref) > 10
    np.testing.assert_allclose(t_port, t_ref, rtol=RTOL)


def test_imperative_qat_trains_no_quantized_weight(lenet_runs):
    """A reference quirk the port copies: ``_fake_quant`` wraps its result
    in a fresh VarBase, which cuts the tape, so no quantized layer's
    weight, nor any layer before the last, gets a gradient."""
    for run in lenet_runs[:2]:
        has = sorted(n for n, g in run["grads"].items() if g is not None)
        assert has == ["fc.3._inner.bias"]
    np.testing.assert_allclose(lenet_runs[1]["grads"]["fc.3._inner.bias"],
                               lenet_runs[0]["grads"]["fc.3._inner.bias"],
                               rtol=RTOL)


def test_save_quantized_model(lenet_runs, tmp_path):
    """The reference's export cannot trace the moving average's float
    read; the port exports the eval forward (the observers read their
    recorded scales) and ``jit.load`` gives it back bit for bit."""
    ref, port, x = lenet_runs
    jdy.enable_dygraph()
    try:
        with pytest.raises(jax.errors.ConcretizationTypeError):
            jfluid.contrib.slim.quantization.ImperativeQuantAware() \
                .save_quantized_model(ref["net"], str(tmp_path / "ref"),
                                      [jdy.to_variable(x)])
    finally:
        jdy.disable_dygraph()
    net = port["net"]
    tdy.enable_dygraph(tfluid.CPUPlace())
    try:
        tfluid.contrib.slim.quantization.ImperativeQuantAware() \
            .save_quantized_model(net, str(tmp_path / "port"),
                                  [tdy.to_variable(x)])
        assert net.training
        net.eval()
        want = net(tdy.to_variable(x)).numpy()
        again = net(tdy.to_variable(2 * x)).numpy()
        net.train()
    finally:
        tdy.disable_dygraph()
    loaded = tjit.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(loaded(x).numpy(), want)
    np.testing.assert_array_equal(loaded(2 * x).numpy(), again)


# --- the remainder op types -------------------------------------------------------
REMAINDER_CASES = {
    "precision_recall": ("precision_recall", {
        "MaxProbs": np.random.RandomState(50).rand(24, 1).astype("float32"),
        "Indices": np.random.RandomState(51).randint(0, 5, (24, 1)),
        "Labels": np.random.RandomState(52).randint(0, 5, (24, 1)),
        "Weights": np.random.RandomState(53).rand(24, 1).astype("float32"),
        "StatesInfo": np.random.RandomState(54).randint(0, 9, (6, 4))
        .astype("float32") * (np.arange(6) < 5)[:, None]},
        {"class_number": 6}),          # class 5: never seen, no states
    "mean_iou": ("mean_iou", {
        "Predictions": np.random.RandomState(55).randint(0, 6, (4, 8, 8)),
        "Labels": np.random.RandomState(56).randint(0, 5, (4, 8, 8))},
        {"num_classes": 7}),
    "top_k_v2 (ties, largest)": ("top_k_v2", {"X": np.array(
        [[1., 3., 3., 2., 3.], [0., 0., 0., 0., 1.]], "float32")},
        {"k": 3}),
    "top_k_v2 (ties, smallest, axis 0)": ("top_k_v2", {"X": np.array(
        [[1., 3.], [0., 3.], [0., 2.], [1., 3.]], "float32")},
        {"k": 3, "axis": 0, "largest": False}),
    "kthvalue (ties)": ("kthvalue", {"X": np.array(
        [[2., 1., 2., 1., 2.], [5., 5., 5., 5., 5.]], "float32")},
        {"k": 3}),
    "kthvalue (axis 0, keepdim)": ("kthvalue", {"X": _r(5, 4, seed=57)},
                                   {"k": 2, "axis": 0, "keepdim": True}),
    "cos_sim (one-row Y)": ("cos_sim", {"X": _r(6, 5, seed=58),
                                        "Y": _r(1, 5, seed=59)}, {}),
    "isfinite (three inputs, an inf)": ("isfinite", {"X": [
        _r(3, 2, seed=60), np.array([1.0, np.inf], "float32"),
        _r(4, seed=61)]}, {}),
    "pow (FactorTensor)": ("pow", {"X": np.abs(_r(3, 4, seed=62)) + 0.1,
                                   "FactorTensor": np.array([2.5],
                                                            "float32")}, {}),
    "squared_l2_distance (one-row Y)": ("squared_l2_distance", {
        "X": _r(5, 3, 2, seed=63), "Y": _r(1, 3, 2, seed=64)}, {}),
    "diag_embed (1-d, offset)": ("diag_embed", {"Input": _r(4, seed=65)},
                                 {"offset": -1}),
    "unsqueeze (two axes, negative)": ("unsqueeze", {"X": _r(3, 4, seed=66)},
                                       {"axes": [0, -1]}),
    "squeeze (listed axes)": ("squeeze", {"X": _r(1, 3, 1, 2, seed=67)},
                              {"axes": [0, -2]}),
    "unique_with_counts": ("unique_with_counts", {"X": np.array(
        [4, 1, 4, 4, 9, 1, 0], "int64")}, {}),
    "space_to_depth (blocksize 3)": ("space_to_depth",
                                     {"X": _r(2, 2, 6, 9, seed=68)},
                                     {"blocksize": 3}),
    "lookup_table_dequant (repeated ids)": ("lookup_table_dequant", {
        "W": np.concatenate([_r(8, 2, seed=69), np.random.RandomState(70)
                             .randint(0, 256, (8, 6)).astype("float32")], 1),
        "Ids": np.array([[3], [0], [3], [7], [3]])}, {}),
}


# the cases whose gradient the sweep's inputs do not reach: ties and a
# broadcast Y (the sweep's lookup_table_dequant already repeats an id)
GRAD_CASES = ("kthvalue (ties)", "cos_sim (one-row Y)")


@pytest.mark.parametrize("case", sorted(REMAINDER_CASES))
def test_remainder_op_matches_reference(case):
    op, ins, attrs = REMAINDER_CASES[case]
    ref, port = run_both(op, ins, attrs)
    assert_outputs_match(ref, port, RTOL, case)
    if case in GRAD_CASES:
        check_generic_grad(op, ins, attrs, rtol=1e-4, ref=ref)


def test_random_crop_contract():
    """The crop is a slice of X at offsets in range; one op seed gives one
    crop; over op seeds the offsets cover their range (ground rule 5:
    the reference's draws are not compared)."""
    x = np.arange(2 * 7 * 9, dtype="float32").reshape(2, 7, 9)
    seen = set()
    for seed in range(60):
        attrs = {"shape": [4, 5], "op_seed": seed}
        out = treg.get_op("random_crop").fn(
            {"X": [torch.from_numpy(x)]}, attrs, _tctx())["Out"][0].numpy()
        again = treg.get_op("random_crop").fn(
            {"X": [torch.from_numpy(x)]}, attrs, _tctx())["Out"][0].numpy()
        np.testing.assert_array_equal(out, again)
        r0, c0 = divmod(int(out[0, 0, 0]), 9)
        np.testing.assert_array_equal(out, x[:, r0:r0 + 4, c0:c0 + 5])
        seen.add((r0, c0))
        ref = jreg.get_op("random_crop").fn(
            {"X": [jax.numpy.asarray(x)]}, attrs, _jctx())["Out"][0]
        assert np.asarray(ref).shape == out.shape
    assert {r for r, _ in seen} == set(range(4))
    assert {c for _, c in seen} == set(range(5))


# --- the fluid.layers builders ------------------------------------------------------
def _builders(fluid, x, y, lbl, pred):
    L = fluid.layers
    xv = fluid.data("x", list(x.shape))
    yv = fluid.data("y", list(y.shape))
    lv = fluid.data("lbl", list(lbl.shape), dtype="int64")
    pv = fluid.data("pred", list(pred.shape), dtype="int64")
    miou, wrong, correct = L.mean_iou(pv, lv, 5)
    return [L.cos_sim(xv, yv), L.isfinite(xv), L.has_inf(L.log(xv)),
            L.has_nan(L.sqrt(xv)), L.pow(xv, 3.0), L.pow(xv, yv), L.size(xv),
            L.space_to_depth(L.reshape(xv, [1, 2, 4, 6]), 2), miou, wrong,
            correct]


def test_layers_builders_match_reference():
    x = np.abs(_r(8, 6, seed=80)) + 0.2
    y = _r(8, 6, seed=81)
    lbl = np.random.RandomState(82).randint(0, 5, (8, 1))
    pred = np.random.RandomState(83).randint(0, 5, (8, 1))
    feed = {"x": x, "y": y, "lbl": lbl, "pred": pred}
    got = []
    for fluid, reset, exe in (
            (jfluid, j_reset, jfluid.Executor),
            (tfluid, t_reset, lambda: tfluid.Executor(tfluid.CPUPlace()))):
        reset()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            outs = _builders(fluid, x, y, lbl, pred)
        got.append([np.asarray(v) for v in exe().run(
            main, feed=feed, fetch_list=outs)])
    for i, (w, g) in enumerate(zip(*got)):
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=RTOL, err_msg=str(i))
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(i))
    assert not bool(got[1][2]) and not bool(got[1][3]) and bool(got[1][1])


def test_unique_with_counts_builder_runs_eagerly():
    """The reference's lowering is ``np.unique``, which its jitted
    executor cannot trace (a static program raises); under the tracer
    both packages give the same values, the port's in the input's
    shape."""
    x = np.array([[4, 1, 4], [4, 9, 1]], "int64")
    got = []
    for fluid, dy, enter in (
            (jfluid, jdy, jdy.enable_dygraph),
            (tfluid, tdy, lambda: tdy.enable_dygraph(tfluid.CPUPlace()))):
        enter()
        try:
            got.append([np.asarray(v.numpy()) for v in
                        fluid.layers.unique_with_counts(dy.to_variable(x))])
        finally:
            dy.disable_dygraph()
    for w, g in zip(*got):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1][2], [2, 3, 1])


def test_random_crop_and_sampling_id_builders():
    """The two drawing builders in a static program on the port: the crop
    a slice of X, sampling_id an index into each row's support."""
    t_reset()
    x = np.arange(3 * 6 * 6, dtype="float32").reshape(3, 6, 6)
    probs = np.array([[0.0, 1.0, 0.0], [0.5, 0.0, 0.5]], "float32")
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        crop = tfluid.layers.random_crop(tfluid.data("x", [3, 6, 6]), [4, 4],
                                         seed=5)
        ids = tfluid.layers.sampling_id(tfluid.data("p", [2, 3]), seed=3)
    c, i = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed={"x": x, "p": probs}, fetch_list=[crop, ids])
    r0, c0 = divmod(int(c[0, 0, 0]), 6)
    np.testing.assert_array_equal(c, x[:, r0:r0 + 4, c0:c0 + 4])
    assert i[0] == 1 and i[1] in (0, 2)


# --- the book's recommender through cos_sim -------------------------------------------
def _recommender(fluid):
    L = fluid.layers
    n_users, n_items, dim = 30, 40, 8
    uid = fluid.data("uid", [-1, 1], dtype="int64")
    iid = fluid.data("iid", [-1, 1], dtype="int64")
    rating = fluid.data("rating", [-1, 1], dtype="float32")
    uemb = L.embedding(uid, size=[n_users, dim])
    iemb = L.embedding(iid, size=[n_items, dim])
    ufc = L.fc(L.reshape(uemb, [-1, dim]), 16, act="tanh")
    ifc = L.fc(L.reshape(iemb, [-1, dim]), 16, act="tanh")
    pred = L.scale(L.cos_sim(ufc, ifc), scale=2.5, bias=2.5)
    loss = L.mean(L.square_error_cost(pred, rating))
    fluid.optimizer.SGDOptimizer(0.05).minimize(loss)
    return loss


def test_recommender_matches_reference():
    """``tests/test_book_models.py::TestRecommenderSystem`` in both
    packages from the reference's startup state: 8 SGD steps' losses
    within rtol 1e-5."""
    r = np.random.RandomState(0)
    users = r.randint(0, 30, (256, 1)).astype("int64")
    items = r.randint(0, 40, (256, 1)).astype("int64")
    ratings = (((users + items) % 2) * 4.0 + 0.5).astype("float32")
    feeds = [{"uid": users[s:s + 64], "iid": items[s:s + 64],
              "rating": ratings[s:s + 64]}
             for s in (i * 64 % 256 for i in range(8))]
    j_reset()
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        loss = _recommender(jfluid)
    exe, scope = jfluid.Executor(), JScope()
    with jguard(scope):
        exe.run(startup)
        init = {n: np.array(scope.find_var(n))
                for n, v in main.global_block().vars.items()
                if v.persistable and scope.find_var(n) is not None}
        want = [float(np.ravel(exe.run(main, feed=f, fetch_list=[loss])[0])
                      [0]) for f in feeds]
    t_reset()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        loss = _recommender(tfluid)
    assert sum(op.type == "cos_sim" for op in main.global_block().ops) == 1
    scope = interop.scope_from_numpy(init, tfluid.Scope(), tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    got = [float(np.ravel(exe.run(main, feed=f, fetch_list=[loss],
                                  scope=scope)[0])[0]) for f in feeds]
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert got[-1] < got[0]
