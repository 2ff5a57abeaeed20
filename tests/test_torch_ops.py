"""paddle_tpu_torch op lowerings against paddle_tpu's, op by op.

Every op type of the frozen static BERT program, before and after
``fuse_attention``, runs the same numpy inputs (made from a seed) through
the JAX lowering (on the CPU, where ``fused_multihead_attention`` takes
its plain reference) and through the port's lowering on CPU tensors.
float32 results agree within rtol=atol=1e-5: the two libraries sum in
different orders, nothing more.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu  # noqa: F401 — registers the reference lowerings
from paddle_tpu.ops import registry as jreg

from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.ops.attention import _reference_attention

TOL = dict(rtol=1e-5, atol=1e-5)


def _run_both(op_type, ins, attrs, is_test=False):
    """Run the op in both packages; returns {slot: [(jax, torch), ...]}."""
    j_ins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
    t_ins = {s: [torch.from_numpy(np.array(a)) for a in v]
             for s, v in ins.items()}
    j_out = jreg.get_op(op_type).fn(
        j_ins, dict(attrs), jreg.LoweringContext(is_test=is_test))
    t_out = treg.get_op(op_type).fn(
        t_ins, dict(attrs), treg.LoweringContext(is_test=is_test))
    assert set(j_out) == set(t_out), op_type
    return {s: list(zip(j_out[s], t_out[s])) for s in j_out}


def _check(op_type, ins, attrs, is_test=False):
    for slot, pairs in _run_both(op_type, ins, attrs, is_test).items():
        for j, t in pairs:
            j = np.asarray(j)
            t = t.numpy()
            assert j.shape == t.shape, (op_type, slot, j.shape, t.shape)
            np.testing.assert_allclose(t.astype(np.float64),
                                       j.astype(np.float64), **TOL,
                                       err_msg=f"{op_type}.{slot}")


R = np.random.RandomState(7)


def _f(*shape):
    return R.randn(*shape).astype("float32")


CASES = {
    "reshape2_zero_dims": ("reshape2", {"X": [_f(2, 3, 8)]},
                           {"shape": [0, 0, 2, 4]}),
    "reshape2_minus_one": ("reshape2", {"X": [_f(2, 3, 8)]},
                           {"shape": [0, -1]}),
    "reshape2_mask": ("reshape2", {"X": [_f(3, 16)]},
                      {"shape": [0, 1, 1, 16]}),
    "scale_after": ("scale", {"X": [_f(3, 5)]},
                    {"scale": 0.125, "bias": 0.0, "bias_after_scale": True}),
    "scale_bias_before": ("scale", {"X": [_f(3, 1, 1, 5)]},
                          {"scale": 10000.0, "bias": -10000.0,
                           "bias_after_scale": False}),
    "lookup_table_v2": ("lookup_table_v2",
                        {"W": [_f(10, 6)],
                         "Ids": [R.randint(0, 10, (3, 5)).astype("int64")]},
                        {"padding_idx": -1, "is_sparse": False}),
    "lookup_table_v2_padding": ("lookup_table_v2",
                                {"W": [_f(10, 6)],
                                 "Ids": [np.array([[3, 1, 3], [0, 3, 9]],
                                                  "int64")]},
                                {"padding_idx": 3}),
    "mul_x_num_col_dims_2": ("mul", {"X": [_f(2, 5, 8)], "Y": [_f(8, 6)]},
                             {"x_num_col_dims": 2, "y_num_col_dims": 1}),
    "mul_2d": ("mul", {"X": [_f(4, 8)], "Y": [_f(8, 2)]},
               {"x_num_col_dims": 1, "y_num_col_dims": 1}),
    "elementwise_add_bias_axis": ("elementwise_add",
                                  {"X": [_f(2, 5, 8)], "Y": [_f(8)]},
                                  {"axis": 2}),
    "elementwise_add_mask": ("elementwise_add",
                             {"X": [_f(2, 4, 5, 5)], "Y": [_f(2, 1, 1, 5)]},
                             {"axis": -1}),
    "transpose2": ("transpose2", {"X": [_f(2, 5, 4, 3)]},
                   {"axis": [0, 2, 1, 3]}),
    "matmul_qk": ("matmul", {"X": [_f(2, 4, 5, 3)], "Y": [_f(2, 4, 5, 3)]},
                  {"transpose_X": False, "transpose_Y": True, "alpha": 1.0}),
    "matmul_pv_alpha": ("matmul",
                        {"X": [_f(2, 4, 5, 5)], "Y": [_f(2, 4, 5, 3)]},
                        {"transpose_X": False, "transpose_Y": False,
                         "alpha": 0.5}),
    "softmax": ("softmax", {"X": [_f(2, 4, 5, 5)]}, {"axis": -1}),
    "relu": ("relu", {"X": [_f(3, 7)]}, {}),
    "fused_elemwise_activation": ("fused_elemwise_activation",
                                  {"X": [_f(2, 5, 8)], "Y": [_f(8)]},
                                  {"functor_list": ["elementwise_add",
                                                    "relu"], "axis": 2}),
    "reduce_mean_dim1": ("reduce_mean", {"X": [_f(3, 5, 8)]},
                         {"dim": [1], "keep_dim": False,
                          "reduce_all": False}),
    "reduce_mean_keep": ("reduce_mean", {"X": [_f(3, 5, 8)]},
                         {"dim": [-1], "keep_dim": True,
                          "reduce_all": False}),
    "reduce_mean_all": ("reduce_mean", {"X": [_f(3, 5)]},
                        {"dim": [0], "keep_dim": False, "reduce_all": True}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_reference(case):
    op_type, ins, attrs = CASES[case]
    _check(op_type, ins, attrs)


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
@pytest.mark.parametrize("where", ["attr", "ctx"])
def test_dropout_under_is_test(impl, where):
    attrs = {"dropout_prob": 0.1, "dropout_implementation": impl,
             "op_seed": 5, "is_test": where == "attr"}
    _check("dropout", {"X": [_f(4, 6)]}, attrs, is_test=where == "ctx")


def _attention_inputs(b=2, h=3, t=6, d=8, with_mask=True):
    ins = {"Q": [_f(b, h, t, d)], "K": [_f(b, h, t, d)],
           "V": [_f(b, h, t, d)]}
    if with_mask:
        m = np.ones((b, t), "float32")
        m[0, 4:] = 0.0
        m[1, 2:] = 0.0
        ins["Mask"] = [((m - 1.0) * 10000.0).reshape(b, 1, 1, t)]
    return ins


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_fused_multihead_attention(with_mask, causal):
    attrs = {"scale": 8 ** -0.5, "causal": causal}
    _check("fused_multihead_attention",
           _attention_inputs(with_mask=with_mask), attrs)


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
def test_fused_attention_with_absorbed_dropout_at_test_time(impl):
    """The fused op a frozen program carries: dropout attrs stamped by
    fuse_attention, turned off by the context's is_test."""
    attrs = {"scale": 8 ** -0.5, "causal": False, "dropout_rate": 0.1,
             "dropout_seed": 11, "dropout_implementation": impl,
             "dropout_is_test": False}
    _check("fused_multihead_attention", _attention_inputs(), attrs,
           is_test=True)


def test_reference_attention_bf16_tracks_fp32():
    ins = _attention_inputs(b=2, h=2, t=16, d=16)
    q, k, v = (torch.from_numpy(ins[s][0]) for s in ("Q", "K", "V"))
    mask = torch.from_numpy(ins["Mask"][0])
    ref = _reference_attention(q, k, v, mask, 0.25, False)
    low = _reference_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                               mask, 0.25, False)
    assert low.dtype == torch.bfloat16
    np.testing.assert_allclose(low.float().numpy(), ref.numpy(), atol=2e-2)


def test_meta_tensors_take_the_plain_path():
    """Shape inference hands lowerings meta tensors: the attention op must
    answer with shapes and never reach a kernel."""
    from paddle_tpu_torch.ops import cuda_kernels
    q = torch.empty((2, 3, 5, 8), device="meta")
    mask = torch.empty((2, 1, 1, 5), device="meta")
    before = cuda_kernels.flash_attention_fwd.launches
    out = treg.get_op("fused_multihead_attention").fn(
        {"Q": [q], "K": [q], "V": [q], "Mask": [mask]},
        {"scale": 0.3, "dropout_rate": 0.1, "dropout_seed": 3},
        treg.LoweringContext(device="meta"))
    assert out["Out"][0].shape == (2, 3, 5, 8)
    assert cuda_kernels.flash_attention_fwd.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    from paddle_tpu_torch.ops import cuda_kernels
    q = torch.zeros((1, 1, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.flash_attention_fwd(q, q, q, None, 1.0, False)


# ---------------------------------------------------------------------------
# the training slice: loss, fan-in, generic_grad, Adam
# ---------------------------------------------------------------------------

def _labels(n, classes):
    return R.randint(0, classes, (n, 1)).astype("int64")


def _adam_ins(shapes):
    ins = {"Param": [], "Grad": [], "Moment1": [], "Moment2": [],
           "Beta1Pow": [], "Beta2Pow": []}
    for i, shape in enumerate(shapes):
        ins["Param"].append(_f(*shape))
        ins["Grad"].append(_f(*shape))
        ins["Moment1"].append(0.1 * _f(*shape))
        ins["Moment2"].append(np.abs(0.01 * _f(*shape)))
        ins["Beta1Pow"].append(np.array([0.9 ** (i + 1)], "float32"))
        ins["Beta2Pow"].append(np.array([0.999 ** (i + 1)], "float32"))
    ins["LearningRate"] = [np.array([1e-3], "float32")]
    return ins


_ADAM_ATTRS = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
               "multi_precision": False}

TRAIN_CASES = {
    "sum": ("sum", {"X": [_f(3, 4), _f(3, 4), _f(3, 4)]}, {}),
    "mean": ("mean", {"X": [_f(3, 5, 2)]}, {}),
    "softmax_with_cross_entropy": (
        "softmax_with_cross_entropy",
        {"Logits": [_f(6, 5)], "Label": [_labels(6, 5)]},
        {"soft_label": False, "ignore_index": -100, "axis": -1}),
    "softmax_with_cross_entropy_soft_label": (
        "softmax_with_cross_entropy",
        {"Logits": [_f(6, 5)],
         "Label": [np.abs(_f(6, 5)) / np.abs(_f(6, 5)).sum(-1,
                                                            keepdims=True)]},
        {"soft_label": True, "axis": -1}),
    "softmax_with_cross_entropy_axis0": (
        "softmax_with_cross_entropy",
        {"Logits": [_f(5, 6)], "Label": [_labels(6, 5).T.copy()]},
        {"soft_label": False, "ignore_index": -100, "axis": 0}),
    "adam": ("adam", {k: v[:1] if k != "LearningRate" else v
                      for k, v in _adam_ins([(4, 3)]).items()},
             _ADAM_ATTRS),
    "generic_grad_mul": (
        "generic_grad",
        {"I_X": [_f(2, 5, 8)], "I_Y": [_f(8, 6)], "G_Out": [_f(2, 5, 6)]},
        {"fwd_type": "mul", "fwd_attrs": {"x_num_col_dims": 2,
                                          "y_num_col_dims": 1},
         "in_slots": ["X", "Y"], "grad_slots": ["X", "Y"]}),
    "generic_grad_reshape2": (
        "generic_grad", {"I_X": [_f(2, 3, 8)], "G_Out": [_f(2, 3, 2, 4)]},
        {"fwd_type": "reshape2", "fwd_attrs": {"shape": [0, 0, 2, 4]},
         "in_slots": ["X"], "grad_slots": ["X"]}),
    "generic_grad_lookup_table_v2": (
        "generic_grad",
        {"I_W": [_f(10, 6)],
         "I_Ids": [R.randint(0, 10, (3, 5)).astype("int64")],
         "G_Out": [_f(3, 5, 6)]},
        {"fwd_type": "lookup_table_v2", "fwd_attrs": {"padding_idx": -1},
         "in_slots": ["W", "Ids"], "grad_slots": ["W"]}),
    "generic_grad_softmax_with_cross_entropy": (
        "generic_grad",
        {"I_Logits": [_f(6, 5)], "I_Label": [_labels(6, 5)],
         "G_Loss": [_f(6, 1)]},
        {"fwd_type": "softmax_with_cross_entropy",
         "fwd_attrs": {"soft_label": False, "ignore_index": -100,
                       "axis": -1},
         "in_slots": ["Logits", "Label"], "grad_slots": ["Logits"]}),
    "generic_grad_softmax_with_cross_entropy_soft_axis0": (
        "generic_grad",
        {"I_Logits": [_f(5, 6)],
         "I_Label": [np.abs(_f(5, 6)) / np.abs(_f(5, 6)).sum(0,
                                                             keepdims=True)],
         "G_Loss": [_f(1, 6)]},
        {"fwd_type": "softmax_with_cross_entropy",
         "fwd_attrs": {"soft_label": True, "axis": 0},
         "in_slots": ["Logits", "Label"], "grad_slots": ["Logits"]}),
    "generic_grad_fused_multihead_attention": (
        "generic_grad",
        {**{"I_" + s: v for s, v in _attention_inputs().items()},
         "G_Out": [_f(2, 3, 6, 8)]},
        {"fwd_type": "fused_multihead_attention",
         "fwd_attrs": {"scale": 8 ** -0.5, "causal": False},
         "in_slots": ["Q", "K", "V", "Mask"],
         "grad_slots": ["Q", "K", "V"]}),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_training_op_matches_reference(case):
    op_type, ins, attrs = TRAIN_CASES[case]
    _check(op_type, ins, attrs)


def test_fused_adam_plain_matches_reference():
    """The port's plain bucket (a CPU tensor never takes the kernel)
    against the reference's ``_fused_adam`` on its jnp branch, rtol 1e-6:
    the same arithmetic, rounded alike."""
    ins = _adam_ins([(16, 8), (8,), (40, 32), (3,)])
    for slot, pairs in _run_both("fused_adam", ins, _ADAM_ATTRS).items():
        for j, t in pairs:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=0, err_msg=slot)


def test_fused_adam_bit_identical_to_per_param_adam():
    ins = _adam_ins([(16, 8), (8,), (40, 32), (3,)])
    t_ins = {s: [torch.from_numpy(a) for a in v] for s, v in ins.items()}
    fused = treg.get_op("fused_adam").fn(t_ins, dict(_ADAM_ATTRS),
                                         treg.LoweringContext())
    for i in range(4):
        one = treg.get_op("adam").fn(
            {s: [v[0] if s == "LearningRate" else v[i]]
             for s, v in t_ins.items()},
            dict(_ADAM_ATTRS), treg.LoweringContext())
        for slot, outs in one.items():
            assert torch.equal(fused[slot][i], outs[0]), (slot, i)


def test_adam_layout_pads_segments_and_chunks_launches():
    """The multi-tensor kernels' (fused Adam's and fused Momentum's)
    segment table, a pure function: every segment starts on a 4-value
    boundary right after the previous one's padded end, and the launches
    cover the segments in order, at most ``BUCKET_SEGMENTS_PER_LAUNCH``
    (48) each."""
    from paddle_tpu_torch.ops.cuda_kernels import (
        BUCKET_SEGMENTS_PER_LAUNCH, bucket_layout)
    assert BUCKET_SEGMENTS_PER_LAUNCH == 48
    assert bucket_layout((2, 13, 7, 4, 0, 1)) == (
        (0, 4, 20, 28, 32, 32), 36, ((0, 6),))
    assert bucket_layout(()) == ((), 0, ())
    sizes = tuple(int(x) for x in
                  np.random.RandomState(0).randint(0, 3000, 2 * 48 + 3))
    offsets, total, chunks = bucket_layout(sizes)
    assert chunks == ((0, 48), (48, 96), (96, 99))
    assert bucket_layout(sizes[:96])[2] == ((0, 48), (48, 96))
    for i, (off, size) in enumerate(zip(offsets, sizes)):
        assert off % 4 == 0
        end = offsets[i + 1] if i + 1 < len(sizes) else total
        assert off + size <= end < off + size + 4


def test_fused_adam_plain_two_steps_match_reference():
    """Odd sizes ((2,), (13, 1), (7,)) stepped twice through the port's
    plain bucket and the reference's ``_fused_adam``, each step fed its
    own outputs; rtol 1e-6, as the one-step test."""
    ins = _adam_ins([(2,), (13, 1), (7,), (16, 8)])
    j_ins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
    t_ins = {s: [torch.from_numpy(np.array(a)) for a in v]
             for s, v in ins.items()}
    state = {"ParamOut": "Param", "Moment1Out": "Moment1",
             "Moment2Out": "Moment2", "Beta1PowOut": "Beta1Pow",
             "Beta2PowOut": "Beta2Pow"}
    for step in range(2):
        j_out = jreg.get_op("fused_adam").fn(j_ins, dict(_ADAM_ATTRS),
                                            jreg.LoweringContext())
        t_out = treg.get_op("fused_adam").fn(t_ins, dict(_ADAM_ATTRS),
                                            treg.LoweringContext())
        for slot in state:
            for j, t in zip(j_out[slot], t_out[slot]):
                assert tuple(t.shape) == tuple(np.shape(j)), (step, slot)
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=1e-6, atol=0,
                                           err_msg=f"step {step} {slot}")
        for out_slot, in_slot in state.items():
            j_ins[in_slot] = list(j_out[out_slot])
            t_ins[in_slot] = list(t_out[out_slot])
        grads = [_f(*np.shape(a)) for a in ins["Grad"]]
        j_ins["Grad"] = [jnp.asarray(a) for a in grads]
        t_ins["Grad"] = [torch.from_numpy(a) for a in grads]


# ---------------------------------------------------------------------------
# the backward kernel's plain version and the autograd.Function wiring
# ---------------------------------------------------------------------------

def _qkv_mask(causal, b=2, h=3, t=7, d=8):
    q, k, v = (torch.from_numpy(_f(b, h, t, d)) for _ in range(3))
    mask = None if causal else \
        torch.from_numpy(_attention_inputs(b, h, t, d)["Mask"][0])
    return q, k, v, mask


@pytest.mark.parametrize("causal", [False, True], ids=["mask", "causal"])
def test_reference_attention_bwd_matches_jax_vjp(causal):
    import jax
    from paddle_tpu.ops.attention import _reference_attention as j_attention
    from paddle_tpu_torch.ops.attention import (_reference_attention_bwd,
                                                _reference_stats)
    q, k, v, mask = _qkv_mask(causal)
    do = torch.from_numpy(_f(*q.shape))
    scale = 8 ** -0.5
    o = _reference_attention(q, k, v, mask, scale, causal)
    m, l = _reference_stats(q, k, mask, scale, causal)
    got = _reference_attention_bwd(q, k, v, mask, scale, o, m, l, do, causal)
    jm = None if mask is None else jnp.asarray(mask.numpy())
    _, vjp = jax.vjp(lambda a, b, c: j_attention(a, b, c, jm, scale, causal),
                     *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    want = vjp(jnp.asarray(do.numpy()))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q.numpy()),
                   jnp.asarray(k.numpy())) * scale
    if causal:
        s = jnp.where(jnp.tril(jnp.ones(s.shape[-2:], bool)), s,
                      jnp.finfo(jnp.float32).min)
    else:
        s = s + jm
    lse = m.double() + torch.log(l.double())
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jax.nn.logsumexp(s, axis=-1)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True], ids=["mask", "causal"])
def test_flash_function_wiring_under_vjp(monkeypatch, causal):
    """``_FlashAttention`` with the plain forward (+ stats) and backward
    plugged in where the kernels go: ``torch.func.vjp`` through it inside
    ``torch.no_grad()`` (as ``generic_grad`` runs) equals autodiff of
    ``_reference_attention``, and each stand-in ran once on plain tensors
    (``data_ptr`` works on every tensor argument, as the ctypes launch
    needs)."""
    from paddle_tpu_torch.ops import attention, cuda_kernels
    calls = []

    def fwd(q, k, v, bias, scale, causal_, return_stats=False):
        calls.append(("fwd", [t.data_ptr() for t in (q, k, v, bias)
                              if t is not None]))
        o = attention._reference_attention(q, k, v, bias, scale, causal_)
        return (o, *attention._reference_stats(q, k, bias, scale, causal_))

    def bwd(q, k, v, bias, scale, causal_, o, m, l, do):
        calls.append(("bwd", [t.data_ptr() for t in (q, k, v, bias, o, m, l,
                                                     do) if t is not None]))
        return attention._reference_attention_bwd(q, k, v, bias, scale, o,
                                                  m, l, do, causal_)

    monkeypatch.setattr(cuda_kernels, "flash_attention_fwd", fwd)
    monkeypatch.setattr(cuda_kernels, "flash_attention_bwd", bwd)
    q, k, v, mask = _qkv_mask(causal)
    do = torch.from_numpy(_f(*q.shape))
    scale = 8 ** -0.5
    with torch.no_grad():
        out, vjp = torch.func.vjp(
            lambda a, b, c: attention._FlashAttention.apply(
                a, b, c, mask, scale, causal)[0], q, k, v)
        got = vjp(do)
    assert [c[0] for c in calls] == ["fwd", "bwd"]
    want_out, want_vjp = torch.func.vjp(
        lambda a, b, c: _reference_attention(a, b, c, mask, scale, causal),
        q, k, v)
    want = want_vjp(do)
    np.testing.assert_allclose(out.numpy(), want_out.numpy(), rtol=1e-5,
                               atol=1e-6)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_training_wrappers_refuse_cpu_tensors():
    from paddle_tpu_torch.ops import cuda_kernels
    q = torch.zeros((1, 1, 4, 8))
    m = torch.zeros((1, 1, 4))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.flash_attention_bwd(q, q, q, None, 1.0, False, q, m, m,
                                         q)
    p, one = torch.zeros((2, 1024)), torch.ones(1)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.fused_adam([p], [p], [p], [p], one, [one], [one], 0.9,
                                0.999, 1e-8)
