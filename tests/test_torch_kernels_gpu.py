"""The hand-written Hopper kernels against their plain PyTorch versions,
on the card.

Marked ``gpu``: on a host without a CUDA device every test here skips
(decided in a fixture, so every pytest-xdist worker collects the same
tests).  On the card: ``python -m pytest -m gpu tests/test_torch_kernels_gpu.py``.

Tolerances: float32 atol=rtol=1e-4 (the online softmax sums in another
order than the plain version's full-row softmax); bfloat16 atol=2e-2
(both versions round the probabilities to bfloat16 before the product
with V, the kernel before it normalises them, the plain version
after).  The softmax statistics against ``_reference_stats``: atol=rtol=1e-4.  The backward
kernel against ``_reference_attention_bwd`` on the same o, m and l: float32
atol=rtol=1e-4 (FMA chains against cuBLAS sums), bfloat16 atol=2e-2,
rtol=1e-2 (one bfloat16 rounding of each output); two backward
launches on the same inputs ``torch.equal`` (no atomics).  ``fused_adam``
against the per-param ``adam`` lowering: ``torch.equal``, over two steps
(the second reads views of the first's outputs).  The embedding
gather-pool kernel against ``_reference_embedding_pool``: rtol=atol=1e-6
(the kernel sums in j order, torch's reduction in its own; past 8 ids a
row the atol is in units of the row's sum of |term|), ``torch.equal`` to
the j-order sum written in torch ops, and ``torch.equal`` on dyadic
values, whose sums are exact; its dispatcher op
(``paddle_tpu_torch::embedding_pool_fwd``) ``torch.equal`` to the
wrapper, also through a ``torch.export`` round trip.  The scatter-add
gradient kernel: two launches ``torch.equal``, and ``torch.equal`` to the
plain version computed on the host, whose ``index_add_`` adds in index
order.  ``fused_momentum`` against the per-param ``momentum`` lowering:
``torch.equal``, at any bucket (views at odd offsets, segments of no
values, more segments than one launch takes), with one kernel a call
and no copy.  The dropout kernels against their plain Philox
versions (ops/nn_ops.py): masks, dropout and dropout-add ``torch.equal``
(the same float32 products and sums, each rounded once); act-dropout
forward and backward within 1e-6 relative and absolute in float32 (the
kernel's erff and expf against torch's erf and exp, a few ulp) and one
bfloat16 ulp (rtol 2^-7) in bfloat16, where such a difference can round
to the neighbouring value.  The paged-attention kernel against
``_paged_reference``: within 1e-5 of the largest |out| (an online softmax
over splits sums in another order than the plain full-row softmax), and
two calls ``torch.equal`` (the splits merge in a fixed order).
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import cuda_kernels
from paddle_tpu_torch.ops.attention import _reference_attention, \
    _reference_attention_bwd, _reference_stats, flash_attention
from paddle_tpu_torch.ops.ctr_ops import _reference_embedding_pool, \
    _reference_embedding_pool_grad
from paddle_tpu_torch.ops.registry import LoweringContext, get_op

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=0.0)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "for sm_90a and run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(device, b, h, t, d, dtype, seed=0, masked=True,
            program_bias=False):
    """q, k, v as the permuted [B,H,T,D] views transpose2 leaves behind,
    and a [B,1,1,T] padding bias of (m - 1) * 10000, or with
    ``program_bias`` (m - 10000) * 10000, the bias the static BERT program
    builds (about -1e8, where float32 keeps only multiples of 8)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    qkv = [torch.randn(b, t, h, d, generator=g).to(device, dtype)
           .permute(0, 2, 1, 3) for _ in range(3)]
    mask = None
    if masked:
        lengths = torch.randint(1, t + 1, (b,), generator=g)
        m = (torch.arange(t)[None, :] < lengths[:, None]).float()
        shift = 10000.0 if program_bias else 1.0
        mask = ((m - shift) * 10000.0).reshape(b, 1, 1, t).to(device)
    return qkv, mask


def _check(device, b, h, t, d, dtype, causal=False, masked=True,
           program_bias=False):
    (q, k, v), mask = _inputs(device, b, h, t, d, dtype, masked=masked,
                              program_bias=program_bias)
    scale = d ** -0.5
    before = cuda_kernels.flash_attention_fwd.launches
    out = cuda_kernels.flash_attention_fwd(q, k, v, mask, scale, causal)
    torch.cuda.synchronize()
    assert cuda_kernels.flash_attention_fwd.launches == before + 1
    ref = _reference_attention(q, k, v, mask, scale, causal)
    assert out.shape == ref.shape and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_serving_shape(cuda, dtype):
    _check(cuda, 4, 12, 128, 64, dtype)


@pytest.mark.parametrize("t,d", [(100, 64), (1, 64), (65, 32), (130, 128),
                                 (77, 40)])
def test_ragged_lengths_and_head_dims(cuda, t, d):
    _check(cuda, 2, 3, t, d, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_causal(cuda, dtype):
    _check(cuda, 2, 4, 128, 64, dtype, causal=True)
    _check(cuda, 2, 4, 100, 64, dtype, causal=True, masked=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal,masked", [(False, True), (True, False)],
                         ids=["padding", "causal"])
def test_flash_custom_op_is_the_kernel(cuda, dtype, causal, masked):
    """``paddle_tpu_torch::flash_attention_fwd`` (what an exported graph
    holds) on CUDA tensors: ``torch.equal`` to the wrapper's launch, one
    launch counted; its fake gives the real output's shape and dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from paddle_tpu_torch.ops.attention import flash_attention_fwd_op
    (q, k, v), mask = _inputs(cuda, 2, 4, 128, 64, dtype, masked=masked)
    before = cuda_kernels.flash_attention_fwd.launches
    got = flash_attention_fwd_op(q, k, v, mask, 0.125, causal)
    assert cuda_kernels.flash_attention_fwd.launches == before + 1
    want = cuda_kernels.flash_attention_fwd(q, k, v, mask, 0.125, causal)
    assert torch.equal(got, want)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = flash_attention_fwd_op(*[mode.from_tensor(t) for t in
                                        (q, k, v)],
                                      mode.from_tensor(mask) if masked
                                      else None, 0.125, causal)
    assert fake.shape == got.shape and fake.dtype == got.dtype
    assert fake.device == got.device
    assert cuda_kernels.flash_attention_fwd.launches == before + 2


def test_dispatch_launches_the_kernel_for_cuda_tensors(cuda):
    (q, k, v), mask = _inputs(cuda, 2, 2, 16, 64, torch.float32)
    before = cuda_kernels.flash_attention_fwd.launches
    flash_attention(q, k, v, mask, scale=0.125)
    assert cuda_kernels.flash_attention_fwd.launches == before + 1


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    (q, k, v), _ = _inputs(cuda, 1, 1, 8, 64, torch.float32, masked=False)
    with pytest.raises(ValueError, match="head dim"):
        cuda_kernels.flash_attention_fwd(q[..., :60], k[..., :60],
                                         v[..., :60], None, 1.0, False)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.flash_attention_fwd(q.transpose(-1, -2), k, v, None,
                                         1.0, False)
    with pytest.raises(ValueError, match="not supported"):
        cuda_kernels.flash_attention_fwd(q.half(), k.half(), v.half(),
                                         None, 1.0, False)


BWD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
           torch.bfloat16: dict(atol=2e-2, rtol=1e-2)}


def _check_bwd(device, b, h, t, d, dtype, causal=False, masked=True,
               program_bias=False):
    (q, k, v), mask = _inputs(device, b, h, t, d, dtype, masked=masked,
                              program_bias=program_bias)
    g = torch.Generator(device="cpu").manual_seed(1)
    do = torch.randn(b, t, h, d, generator=g).to(device, dtype) \
        .permute(0, 2, 1, 3)
    scale = d ** -0.5
    o, m, l = cuda_kernels.flash_attention_fwd(q, k, v, mask, scale, causal,
                                               return_stats=True)
    for got_, want_ in zip((m, l), _reference_stats(q, k, mask, scale,
                                                    causal)):
        torch.testing.assert_close(got_, want_, atol=1e-4, rtol=1e-4)
    before = cuda_kernels.flash_attention_bwd.launches
    got = cuda_kernels.flash_attention_bwd(q, k, v, mask, scale, causal, o,
                                           m, l, do)
    torch.cuda.synchronize()
    assert cuda_kernels.flash_attention_bwd.launches == before + 1
    want = _reference_attention_bwd(q, k, v, mask, scale, o, m, l, do,
                                    causal)
    for g_, w in zip(got, want):
        assert g_.shape == w.shape and g_.dtype == dtype
        torch.testing.assert_close(g_.float(), w.float(), **BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_backward_training_shape(cuda, dtype):
    _check_bwd(cuda, 32, 12, 128, 64, dtype)


@pytest.mark.parametrize("t,d,causal", [(100, 64, False), (128, 64, True),
                                        (65, 32, False), (130, 128, True),
                                        (1, 64, False)])
def test_backward_ragged_causal_and_head_dims(cuda, t, d, causal):
    _check_bwd(cuda, 2, 3, t, d, torch.float32, causal=causal)


def test_program_bias_regime(cuda):
    """The forward, its statistics and the backward at the training shape
    under the bias the static BERT program hands them."""
    _check(cuda, 32, 12, 128, 64, torch.float32, program_bias=True)
    _check_bwd(cuda, 32, 12, 128, 64, torch.float32, program_bias=True)


def test_program_bias_regime_bf16(cuda):
    _check(cuda, 32, 12, 128, 64, torch.bfloat16, program_bias=True)
    _check_bwd(cuda, 32, 12, 128, 64, torch.bfloat16, program_bias=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("t,d", [(77, 8), (100, 40), (65, 72), (130, 128)])
def test_head_dims_off_the_mma_depth_with_ragged_lengths(cuda, t, d, dtype):
    """D = 8 and 40 are not multiples of bf16's mma depth of 16 (the
    kernels zero-fill the rest); 72 and 128 take the widest tiles."""
    _check(cuda, 2, 3, t, d, dtype)
    _check_bwd(cuda, 2, 3, t, d, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_served_batch_of_one_row(cuda, dtype):
    """B = 1 of 12 heads: the forward takes one-warp blocks of 16 rows."""
    _check(cuda, 1, 12, 128, 64, dtype)
    _check_bwd(cuda, 1, 12, 128, 64, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_backward_is_bitwise_repeatable(cuda, dtype):
    (q, k, v), mask = _inputs(cuda, 4, 12, 128, 64, dtype)
    do = torch.randn_like(q)
    o, m, l = cuda_kernels.flash_attention_fwd(q, k, v, mask, 0.125, False,
                                               return_stats=True)
    first = cuda_kernels.flash_attention_bwd(q, k, v, mask, 0.125, False, o,
                                             m, l, do)
    second = cuda_kernels.flash_attention_bwd(q, k, v, mask, 0.125, False,
                                              o, m, l, do)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_misaligned_views_are_copied_counted_and_still_match(cuda):
    """A view whose base or T stride is not a 16-byte multiple cannot be
    read by 16-byte cp.async: the wrapper copies it, counts the copy and
    the result still matches the plain version."""
    (q, k, v), mask = _inputs(cuda, 2, 3, 40, 64, torch.float32)
    flat = torch.zeros(q.numel() + 1, device=cuda)
    q_off = flat[1:].view(q.shape).copy_(q)               # base + 4 bytes
    wide = torch.zeros(2, 40, 3 * 64 + 2, device=cuda)
    k_odd = wide[..., :192].view(2, 40, 3, 64).permute(0, 2, 1, 3)
    k_odd.copy_(k)                                        # T stride 194
    f0 = cuda_kernels.flash_attention_fwd.copies
    b0 = cuda_kernels.flash_attention_bwd.copies
    o, m, l = cuda_kernels.flash_attention_fwd(q_off, k_odd, v, mask, 0.125,
                                               False, return_stats=True)
    assert cuda_kernels.flash_attention_fwd.copies == f0 + 2
    torch.testing.assert_close(
        o, _reference_attention(q, k, v, mask, 0.125, False), **TOL[q.dtype])
    do = torch.randn_like(q)
    got = cuda_kernels.flash_attention_bwd(q_off, k_odd, v, mask, 0.125,
                                           False, o, m, l, do)
    assert cuda_kernels.flash_attention_bwd.copies == b0 + 2
    want = _reference_attention_bwd(q, k, v, mask, 0.125, o, m, l, do)
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_, w, **BWD_TOL[q.dtype])


def test_autograd_function_runs_both_kernels(cuda):
    (q, k, v), mask = _inputs(cuda, 2, 4, 64, 64, torch.float32)
    f0 = cuda_kernels.flash_attention_fwd.launches
    b0 = cuda_kernels.flash_attention_bwd.launches
    with torch.no_grad():
        _, vjp = torch.func.vjp(
            lambda a, b, c: flash_attention(a, b, c, mask, scale=0.125),
            q, k, v)
        vjp(torch.ones_like(q))
    assert cuda_kernels.flash_attention_fwd.launches == f0 + 1
    assert cuda_kernels.flash_attention_bwd.launches == b0 + 1


def _check_tq_tk(device, b, h, tq, tk, d, dtype, bias):
    """The forward, its statistics and the backward at q ``[B,H,Tq,D]``
    against k, v ``[B,H,Tk,D]`` (permuted views, as the model's heads
    are), with ``bias`` None, "causal" (the NMT decoder's ``[1,1,T,T]``
    additive mask of -1e9 above the diagonal, broadcast over B and H
    with stride 0) or "padding" (a ``[B,1,1,Tk]`` key-padding bias)."""
    g = torch.Generator(device="cpu").manual_seed(2)
    q, do = (torch.randn(b, tq, h, d, generator=g).to(device, dtype)
             .permute(0, 2, 1, 3) for _ in range(2))
    k, v = (torch.randn(b, tk, h, d, generator=g).to(device, dtype)
            .permute(0, 2, 1, 3) for _ in range(2))
    mask = None
    if bias == "causal":
        mask = torch.triu(torch.full((tq, tk), -1e9), 1)[None, None] \
            .to(device)
    elif bias == "padding":
        lengths = torch.randint(1, tk + 1, (b,), generator=g)
        keep = (torch.arange(tk)[None, :] < lengths[:, None]).float()
        mask = ((keep - 1) * 10000.0).reshape(b, 1, 1, tk).to(device)
    scale = d ** -0.5
    f0 = cuda_kernels.flash_attention_fwd.launches
    out = cuda_kernels.flash_attention_fwd(q, k, v, mask, scale, False)
    ref = _reference_attention(q, k, v, mask, scale, False)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    o, m, l = cuda_kernels.flash_attention_fwd(q, k, v, mask, scale, False,
                                               return_stats=True)
    for got_, want_ in zip((m, l), _reference_stats(q, k, mask, scale,
                                                    False)):
        torch.testing.assert_close(got_, want_, atol=1e-4, rtol=1e-4)
    got = cuda_kernels.flash_attention_bwd(q, k, v, mask, scale, False, o,
                                           m, l, do)
    torch.cuda.synchronize()
    assert cuda_kernels.flash_attention_fwd.launches == f0 + 2
    want = _reference_attention_bwd(q, k, v, mask, scale, o, m, l, do)
    for g_, w, shape in zip(got, want, (q.shape, k.shape, v.shape)):
        assert g_.shape == w.shape == shape and g_.dtype == dtype
        torch.testing.assert_close(g_.float(), w.float(), **BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("tq,tk,bias", [
    (64, 64, "causal"), (33, 33, "causal"), (64, 96, None),
    (16, 24, None), (100, 37, None), (40, 97, "padding"), (1, 70, None)],
    ids=["nmt causal", "causal ragged", "nmt cross", "host-check cross",
         "keys shorter", "cross padded", "one query"])
def test_cross_attention_and_causal_bias(cuda, tq, tk, bias, dtype):
    """The NMT paths: the decoder's causal bias and cross-attention with
    Tq != Tk (the dK/dV tiles run over Tk, the dQ tiles over Tq) at 16
    heads of 64."""
    _check_tq_tk(cuda, 4, 16, tq, tk, 64, dtype, bias)


def test_causal_bias_row_zero_backward_is_exact(cuda):
    """Row 0 of the -1e9 causal bias leaves one key: its probability is 1
    and its dQ is 0 (dS = P (dP - Δ) with P = 1 and Δ = dP); the saved
    row max and sum keep it so (a folded log-sum-exp would not)."""
    (q, k, v), _ = _inputs(cuda, 2, 16, 64, 64, torch.float32, masked=False)
    mask = torch.triu(torch.full((64, 64), -1e9), 1)[None, None].to(cuda)
    do = torch.randn_like(q)
    o, m, l = cuda_kernels.flash_attention_fwd(q, k, v, mask, 0.125, False,
                                               return_stats=True)
    dq, _, _ = cuda_kernels.flash_attention_bwd(q, k, v, mask, 0.125, False,
                                                o, m, l, do)
    torch.testing.assert_close(o[:, :, 0], v[:, :, 0], atol=1e-6, rtol=0.0)
    assert torch.equal(l[:, :, 0], torch.ones_like(l[:, :, 0]))
    assert float(dq[:, :, 0].abs().max()) <= 1e-5


@pytest.mark.parametrize("sizes", [[(1024, 768), (768,), (30, 7)],
                                   [(300,), (200,)]],
                         ids=["kernel", "small"])
def test_fused_adam_equals_per_param_adam(cuda, sizes):
    """Bit-identical to the per-param lowering on the card, on the
    kernel at any length: a bucket under 1024 elements, which the
    reference keeps off its kernel, launches it too."""
    g = torch.Generator(device="cpu").manual_seed(0)
    ins = {s: [] for s in ("Param", "Grad", "Moment1", "Moment2",
                           "Beta1Pow", "Beta2Pow")}
    for i, shape in enumerate(sizes):
        for s, scale in (("Param", 1.0), ("Grad", 1e-2), ("Moment1", 1e-3)):
            ins[s].append(scale * torch.randn(shape, generator=g))
        ins["Moment2"].append(1e-5 * torch.rand(shape, generator=g))
        ins["Beta1Pow"].append(torch.tensor([0.9 ** (i + 2)]))
        ins["Beta2Pow"].append(torch.tensor([0.999 ** (i + 2)]))
    ins["LearningRate"] = [torch.tensor([1e-3])]
    ins = {s: [t.to(cuda) for t in v] for s, v in ins.items()}
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    before = cuda_kernels.fused_adam.launches
    fused = get_op("fused_adam").fn(ins, attrs, LoweringContext(cuda))
    torch.cuda.synchronize()
    assert cuda_kernels.fused_adam.launches == before + 1
    for i in range(len(sizes)):
        one = get_op("adam").fn(
            {s: [v[0] if s == "LearningRate" else v[i]]
             for s, v in ins.items()}, attrs, LoweringContext(cuda))
        for slot, outs in one.items():
            assert torch.equal(fused[slot][i], outs[0]), (slot, i)


def _adam_bucket(cuda, shapes, seed=0):
    """Inputs of a fused_adam op over ``shapes``: each param's own
    tensors (as the scope holds them), beta powers of different steps."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    ins = {s: [] for s in ("Param", "Grad", "Moment1", "Moment2",
                           "Beta1Pow", "Beta2Pow")}
    for i, shape in enumerate(shapes):
        for s, scale in (("Param", 1.0), ("Grad", 1e-2), ("Moment1", 1e-3)):
            ins[s].append(scale * torch.randn(shape, generator=g))
        ins["Moment2"].append(1e-5 * torch.rand(shape, generator=g))
        ins["Beta1Pow"].append(torch.tensor([0.9 ** (i % 7 + 2)]))
        ins["Beta2Pow"].append(torch.tensor([0.999 ** (i % 7 + 2)]))
    ins["LearningRate"] = [torch.tensor([1e-3])]
    return {s: [t.to(cuda) for t in v] for s, v in ins.items()}


_ADAM_STATE = {"ParamOut": "Param", "Moment1Out": "Moment1",
               "Moment2Out": "Moment2", "Beta1PowOut": "Beta1Pow",
               "Beta2PowOut": "Beta2Pow"}


def _bert_base_shapes():
    """The static BERT-base program's 99 parameters (chip_smoke.py)."""
    per_layer = [(768, 768), (768,)] * 4
    return [(30522, 768)] + per_layer * 12 + [(768, 2), (2,)]


# MNIST LeNet's eight parameters (conv 6@3x3, conv 16@5x5, fc 400x120, fc
# 120x10, weights and biases): segments of 54, 6, 2400, 16, 48000, 120,
# 1200 and 10 values, most of them off a multiple of 4
LENET_SHAPES = [(6, 1, 3, 3), (6,), (16, 6, 5, 5), (16,), (400, 120), (120,),
                (120, 10), (10,)]
# the Momentum-with-clipping case's bucket (fc 10x16 and 16x1 with
# biases), in the sorted order the optimizer appends them
CLIP_CASE_SHAPES = [(16,), (1,), (10, 16), (16, 1)]

ADAM_BUCKETS = {
    "bert_base_99": _bert_base_shapes(),
    "more_than_a_chunk": [(i % 5 + 1, 3) for i in range(
        2 * cuda_kernels.BUCKET_SEGMENTS_PER_LAUNCH + 7)],
    "odd_sizes": [(2,), (13, 1), (7,), (1024, 3), (5,)],
    "lenet_8": LENET_SHAPES,
}


@pytest.mark.parametrize("bucket", sorted(ADAM_BUCKETS))
def test_fused_adam_two_steps_equal_per_param_adam(cuda, bucket):
    """Two steps through the op, the second fed the first's outputs (so
    it reads views into the kernel's flat buffers, each segment after an
    odd-sized one too): every output ``torch.equal`` to the per-param
    ``adam`` lowering's on the same inputs, one launch counted per call."""
    ins = _adam_bucket(cuda, ADAM_BUCKETS[bucket])
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    ctx = LoweringContext(cuda)
    for step in range(2):
        before = cuda_kernels.fused_adam.launches
        fused = get_op("fused_adam").fn(ins, attrs, ctx)
        torch.cuda.synchronize()
        assert cuda_kernels.fused_adam.launches == before + 1
        for i in range(len(ins["Param"])):
            one = get_op("adam").fn(
                {s: [v[0] if s == "LearningRate" else v[i]]
                 for s, v in ins.items()}, attrs, ctx)
            for slot, outs in one.items():
                assert fused[slot][i].shape == outs[0].shape, (step, slot, i)
                assert torch.equal(fused[slot][i], outs[0]), (step, slot, i)
        ins = dict(ins, **{s: fused[o] for o, s in _ADAM_STATE.items()},
                   Grad=[1e-2 * torch.randn_like(p) for p in ins["Grad"]])
    del ins, fused


def test_fused_adam_at_lenet_segments_equals_plain(cuda):
    """At LeNet's segments the kernel's outputs equal its plain version's
    (``_plain_fused_adam`` on the card: the bucket flattened, lr_t
    broadcast), bit for bit."""
    from paddle_tpu_torch.ops.optimizer_ops import _plain_fused_adam
    ins = _adam_bucket(cuda, LENET_SHAPES, seed=3)
    args = [ins[s] for s in ("Param", "Grad", "Moment1", "Moment2")] + \
        [ins["LearningRate"][0], ins["Beta1Pow"], ins["Beta2Pow"],
         0.9, 0.999, 1e-8]
    before = cuda_kernels.fused_adam.launches
    fused = get_op("fused_adam").fn(ins, {"beta1": 0.9, "beta2": 0.999,
                                          "epsilon": 1e-8},
                                    LoweringContext(cuda))
    assert cuda_kernels.fused_adam.launches == before + 1
    plain = _plain_fused_adam(*args)
    for slot, outs in plain.items():
        for i, want in enumerate(outs):
            assert torch.equal(fused[slot][i], want), (slot, i)


def test_fused_momentum_at_clip_case_bucket_equals_plain(cuda):
    """At the clip case's bucket (193 values in four segments) the kernel
    equals the plain update over the flat bucket and the per-param
    lowering, bit for bit."""
    from paddle_tpu_torch.ops.optimizer_ops import _momentum_update
    g = torch.Generator(device="cpu").manual_seed(4)
    ins = {s: [scale * torch.randn(shape, generator=g).to(cuda)
               for shape in CLIP_CASE_SHAPES]
           for s, scale in (("Param", 1.0), ("Grad", 1e-1),
                            ("Velocity", 1e-2))}
    ins["LearningRate"] = [torch.tensor([0.05], device=cuda)]
    attrs = {"mu": 0.9, "use_nesterov": False}
    before = cuda_kernels.fused_momentum.launches
    fused = get_op("fused_momentum").fn(ins, attrs, LoweringContext(cuda))
    assert cuda_kernels.fused_momentum.launches == before + 1
    flat = [torch.cat([t.reshape(-1) for t in ins[s]])
            for s in ("Param", "Grad", "Velocity")]
    p_new, v_new = _momentum_update(*flat, ins["LearningRate"][0]
                                    .reshape(()), 0.9, 0.0, False)
    assert torch.equal(torch.cat([t.reshape(-1)
                                  for t in fused["ParamOut"]]), p_new)
    assert torch.equal(torch.cat([t.reshape(-1)
                                  for t in fused["VelocityOut"]]), v_new)
    for i in range(len(CLIP_CASE_SHAPES)):
        one = get_op("momentum").fn(
            {s: [v[0] if s == "LearningRate" else v[i]]
             for s, v in ins.items()}, attrs, LoweringContext(cuda))
        for slot, outs in one.items():
            assert torch.equal(fused[slot][i], outs[0]), (slot, i)


def test_fused_adam_kernel_reads_unaligned_views(cuda):
    """Inputs that are views at odd offsets (not 16-byte aligned) take
    the kernel's scalar path: still equal to the per-param lowering."""
    ins = _adam_bucket(cuda, [(7,), (33, 2), (5,)])
    for slot in ("Param", "Grad", "Moment1", "Moment2"):
        ins[slot] = [torch.cat([torch.zeros(1, device=cuda), t.reshape(-1)])
                     [1:].view(t.shape) for t in ins[slot]]
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    ctx = LoweringContext(cuda)
    fused = get_op("fused_adam").fn(ins, attrs, ctx)
    for i in range(3):
        one = get_op("adam").fn({s: [v[0] if s == "LearningRate" else v[i]]
                                 for s, v in ins.items()}, attrs, ctx)
        for slot, outs in one.items():
            assert torch.equal(fused[slot][i], outs[0]), (slot, i)


# ---------------------------------------------------------------------------
# the CTR kernels: embedding gather-pool, its scatter-add gradient, Momentum
# ---------------------------------------------------------------------------

def _ctr_inputs(device, d, dist, weights, b=4096, s=5, v=200_000,
                dyadic=False, seed=0):
    """w [v, d], ids [b, s] (uniform, or Zipf(1.1) through a seeded
    permutation, so many ids repeat), wgt [b, s] (ones, or a Length mask
    with AVERAGE's divisor and padding id 7), g [b, d]."""
    rng = np.random.default_rng(seed)
    if dyadic:      # small multiples of 1/8: every sum below is exact
        w = rng.integers(-64, 64, (v, d)).astype(np.float32) / 8
        g = rng.integers(-64, 64, (b, d)).astype(np.float32) / 8
    else:
        w = rng.standard_normal((v, d), dtype=np.float32)
        g = rng.standard_normal((b, d), dtype=np.float32)
    if dist == "zipf":
        perm = rng.permutation(v)
        ids = perm[(rng.zipf(1.1, (b, s)) - 1) % v]
    else:
        ids = rng.integers(0, v, (b, s))
    ids = ids.astype(np.int64)
    if weights == "length_avg":
        ids[:, 2] = 7
        length = rng.integers(0, s + 1, b)
        keep = (np.arange(s)[None, :] < length[:, None]) & (ids != 7)
        denom = 2.0 if dyadic else np.maximum(length, 1)[:, None]
        wgt = (keep / denom).astype(np.float32)
    else:
        wgt = np.ones((b, s), np.float32)
    return [torch.from_numpy(x).to(device) for x in (w, ids, wgt, g)]


CTR_CASES = [(d, dist, wts) for d in (16, 128) for dist in ("uniform", "zipf")
             for wts in ("ones", "length_avg")]


def _pool_case(device, b, s, d, dist, weights, dyadic=False, seed=0,
               v=100_003):
    """w [v, d], ids [b, s] (``uniform``, or ``zipf``: Zipf(1.1) through a
    seeded permutation, so many ids repeat), a fifth of them the padding
    id 7, and wgt: None (every weight 1), ``ones``, ``length_avg`` (a
    Length mask with AVERAGE's divisor, padding zeroed) or ``padding``
    (SUM with padding zeroed, the rest 1)."""
    rng = np.random.default_rng(seed + 131 * s + d)
    if dyadic:      # small multiples of 1/8, weights 0, 1/4 or 1: exact
        w = rng.integers(-64, 64, (v, d)).astype(np.float32) / 8
    else:
        w = rng.standard_normal((v, d), dtype=np.float32)
    if dist == "zipf":
        ids = rng.permutation(v)[(rng.zipf(1.1, (b, s)) - 1) % v]
    else:
        ids = rng.integers(0, v, (b, s))
    ids[rng.random((b, s)) < 0.2] = 7
    keep = ids != 7
    if weights == "none":
        wgt = None
    elif weights == "ones":
        wgt = np.ones((b, s), np.float32)
    elif weights == "padding":
        wgt = keep.astype(np.float32)
    else:
        length = rng.integers(0, s + 1, b)
        keep &= np.arange(s)[None, :] < length[:, None]
        denom = 4.0 if dyadic else np.maximum(length, 1)[:, None]
        wgt = (keep / denom).astype(np.float32)
    t = [torch.from_numpy(x).to(device) for x in (w, ids.astype(np.int64))]
    return t + [None if wgt is None else torch.from_numpy(wgt).to(device)]


def _at_offset_one(w):
    """w's values in a contiguous view at storage offset 1: 4 bytes off
    16-byte alignment, so the kernel takes its 4-byte loads."""
    buf = torch.empty(w.numel() + 1, dtype=w.dtype, device=w.device)
    view = buf[1:].view(w.shape)
    view.copy_(w)
    return view


def _pool_in_j_order(w, ids, wgt):
    """The kernel's contract written in torch ops: the products, then the
    sum from 0 in j order, each rounded on its own, and the sum of |term|
    (the scale of any other order's rounding)."""
    acc = torch.zeros((ids.shape[0], w.shape[1]), device=w.device)
    mag = torch.zeros_like(acc)
    for j in range(ids.shape[1]):
        t = w[ids[:, j]]
        if wgt is not None:
            t = t * wgt[:, j, None]
        acc, mag = acc + t, mag + t.abs()
    return acc, mag


# Zipf ids: S around the kernel's one-pass rows (1, 5, 8) and chunks of 8
# (9, 17); D off the 16-byte loads (1, 3, 17) and on them (16, 128); B = 1,
# the serve batch of 512 and the training batch of 4096.  Then the
# training shape's other inputs: uniform ids, and explicit weights of 1.
POOL_CASES = [(s, d, b, "zipf", wts) for s in (1, 5, 8, 9, 17)
              for d in (1, 3, 16, 17, 128) for b in (1, 512, 4096)
              for wts in ("none", "length_avg", "padding")] + [
    (5, d, 4096, dist, wts) for d in (16, 128)
    for dist, wts in (("uniform", "ones"), ("uniform", "length_avg"),
                      ("zipf", "ones"))]


@pytest.mark.parametrize(
    "s,d,b,dist,weights", POOL_CASES,
    ids=[f"S{s}-D{d}-B{b}-{a}-{w}" for s, d, b, a, w in POOL_CASES])
def test_embedding_pool_fwd_matches_plain(cuda, s, d, b, dist, weights):
    """From an aligned table and from a view at storage offset 1:
    ``torch.equal`` to the j-order sum, within rtol = atol = 1e-6 of the
    plain version, and ``torch.equal`` to it on dyadic values.  Past the
    kernel's one-pass rows (S > 8) atol is in units of the row's sum of
    |term|: the plain version's ``torch.sum`` adds the S terms in its own
    order, which missed a bare 1e-6 by 1.25e-6 at S = 17."""
    fwd = cuda_kernels.embedding_pool_fwd
    w, ids, wgt = _pool_case(cuda, b, s, d, dist, weights)
    want = _reference_embedding_pool(w, ids, wgt)
    in_order, mag = _pool_in_j_order(w, ids, wgt)
    before = fwd.launches
    for table in (w, _at_offset_one(w)):
        out = fwd(table, ids, wgt)
        torch.cuda.synchronize()
        assert torch.equal(out, in_order)
        if s <= 8:
            torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
        else:
            err = (out - want).abs()
            assert torch.all(
                err <= 1e-6 * (want.abs() + mag.clamp(min=1.0))), \
                err.max().item()
    assert fwd.launches == before + 2
    w, ids, wgt = _pool_case(cuda, b, s, d, dist, weights, dyadic=True)
    want = _reference_embedding_pool(w, ids, wgt)
    assert torch.equal(fwd(w, ids, wgt), want)
    assert torch.equal(fwd(_at_offset_one(w), ids, wgt), want)


@pytest.mark.parametrize("weights", ["none", "length_avg", "padding"])
def test_embedding_pool_custom_op_is_the_kernel(cuda, weights, tmp_path):
    """``paddle_tpu_torch::embedding_pool_fwd`` (what an exported CTR
    graph holds) on CUDA tensors at the serve batch's [512, 5] into a
    [100003, 16] table: ``torch.equal`` to the wrapper's launch, within
    rtol = atol = 1e-6 of the plain version, one launch counted; its fake
    gives the real output's shape, dtype and device; and a
    ``torch.export`` of a one-op graph, saved and loaded, holds the op
    and launches the kernel, ``torch.equal`` again."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from paddle_tpu_torch.ops.ctr_ops import embedding_pool_fwd_op
    fwd = cuda_kernels.embedding_pool_fwd
    w, ids, wgt = _pool_case(cuda, 512, 5, 16, "zipf", weights)
    before = fwd.launches
    got = embedding_pool_fwd_op(w, ids, wgt, 7 if weights != "none" else -1)
    assert fwd.launches == before + 1
    assert torch.equal(got, fwd(w, ids, wgt))
    torch.testing.assert_close(got, _reference_embedding_pool(w, ids, wgt),
                               rtol=1e-6, atol=1e-6)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = embedding_pool_fwd_op(
            mode.from_tensor(w), mode.from_tensor(ids),
            None if wgt is None else mode.from_tensor(wgt), -1)
    assert fake.shape == got.shape and fake.dtype == got.dtype
    assert fake.device == got.device

    class OneOp(torch.nn.Module):
        def forward(self, w, ids, *wgt):
            return embedding_pool_fwd_op(w, ids, wgt[0] if wgt else None, -1)

    args = (w, ids) + (() if wgt is None else (wgt,))
    with torch.no_grad():
        ep = torch.export.export(OneOp(), args, strict=False)
    path = str(tmp_path / "one_op.pt2")
    torch.export.save(ep, path)
    loaded = torch.export.load(path)
    held = [str(n.target) for n in loaded.graph.nodes
            if n.op == "call_function"]
    assert "paddle_tpu_torch.embedding_pool_fwd.default" in held
    before = fwd.launches
    out = loaded.module()(*args)
    torch.cuda.synchronize()
    assert fwd.launches == before + 1
    assert torch.equal(out, got)


@pytest.mark.parametrize("d,dist,weights", CTR_CASES,
                         ids=[f"D{d}-{a}-{b}" for d, a, b in CTR_CASES])
def test_embedding_pool_grad_is_deterministic_and_matches_host(cuda, d, dist,
                                                               weights):
    w, ids, wgt, g = _ctr_inputs(cuda, d, dist, weights)
    v = w.shape[0]
    before = cuda_kernels.embedding_pool_grad.launches
    first = cuda_kernels.embedding_pool_grad(g, ids, wgt, v)
    second = cuda_kernels.embedding_pool_grad(g, ids, wgt, v)
    torch.cuda.synchronize()
    assert cuda_kernels.embedding_pool_grad.launches == before + 2
    assert torch.equal(first, second)
    host = _reference_embedding_pool_grad(g.cpu(), ids.cpu(), wgt.cpu(), v)
    assert torch.equal(first.cpu(), host)


def _grad_case(cuda, case, d, seed=1):
    """(g, ids, wgt, V) of a scatter-add edge case at [2048, 5]: every
    position one id; only ids 0 and V - 1; Zipf ids into a V that is not
    a multiple of 256 rows (the largest row block of the earlier
    row-blocked kernel); and Zipf ids at [8192, 5], past the 32,768
    positions the tile sorts take, so the device-wide sort runs."""
    rng = np.random.default_rng(seed)
    b, s = (8192, 5) if case == "device_sort" else (2048, 5)
    v = 1000 if case in ("one_id", "ends") else 100_003
    if case == "one_id":
        ids = np.full((b, s), 417)
    elif case == "ends":
        ids = rng.choice([0, v - 1], (b, s))
    else:
        ids = rng.permutation(v)[(rng.zipf(1.1, (b, s)) - 1) % v]
    g = rng.standard_normal((b, d), dtype=np.float32)
    wgt = rng.random((b, s), dtype=np.float32)
    return [torch.from_numpy(x).to(cuda)
            for x in (g, ids.astype(np.int64), wgt)] + [v]


GRAD_CASES = [(c, d) for c in ("one_id", "ends", "zipf_odd_vocab",
                              "device_sort") for d in (1, 5, 16, 128)]


@pytest.mark.parametrize("case,d", GRAD_CASES,
                         ids=[f"{c}-D{d}" for c, d in GRAD_CASES])
def test_embedding_pool_grad_edge_cases_match_host(cuda, case, d):
    g, ids, wgt, v = _grad_case(cuda, case, d)
    for w in (wgt, None):
        before = cuda_kernels.embedding_pool_grad.launches
        first = cuda_kernels.embedding_pool_grad(g, ids, w, v)
        second = cuda_kernels.embedding_pool_grad(g, ids, w, v)
        torch.cuda.synchronize()
        assert cuda_kernels.embedding_pool_grad.launches == before + 2
        assert torch.equal(first, second)
        host = _reference_embedding_pool_grad(
            g.cpu(), ids.cpu(), None if w is None else w.cpu(), v)
        assert torch.equal(first.cpu(), host)


@pytest.mark.parametrize("d", (16, 128))
def test_embedding_kernels_take_no_weight_as_all_ones(cuda, d):
    """A None wgt, what an unmasked SUM slot passes, is bit for bit a wgt
    of ones in both kernels, and the gradient still equals the host's."""
    w, ids, wgt, g = _ctr_inputs(cuda, d, "zipf", "ones")
    v = w.shape[0]
    fwd, grad = cuda_kernels.embedding_pool_fwd, \
        cuda_kernels.embedding_pool_grad
    out = fwd(w, ids, None)
    assert torch.equal(out, fwd(w, ids, wgt))
    torch.testing.assert_close(out, _reference_embedding_pool(w, ids, None),
                               rtol=1e-6, atol=1e-6)
    dw = grad(g, ids, None, v)
    assert torch.equal(dw, grad(g, ids, wgt, v))
    assert torch.equal(dw.cpu(), _reference_embedding_pool_grad(
        g.cpu(), ids.cpu(), None, v))


def test_ctr_ops_launch_the_kernels_for_cuda_tensors(cuda):
    from paddle_tpu_torch.ops.registry import get_op
    w, ids, wgt, g = _ctr_inputs(cuda, 16, "zipf", "ones", b=64, v=1000)
    op = get_op("fused_embedding_pool")
    ctx = LoweringContext(cuda)
    f0 = cuda_kernels.embedding_pool_fwd.launches
    g0 = cuda_kernels.embedding_pool_grad.launches
    ins = {"W": [w], "Ids": [ids[..., None]]}
    attrs = {"pooltype": "SUM", "squeeze_ids": True}
    out = op.fn(ins, attrs, ctx)["Out"][0]
    dw = op.custom_grad(ins, None, {"Out": g[:64]}, attrs, ctx)["W"][0]
    torch.cuda.synchronize()
    assert cuda_kernels.embedding_pool_fwd.launches == f0 + 1
    assert cuda_kernels.embedding_pool_grad.launches == g0 + 1
    assert out.shape == (64, 16) and dw.shape == (1000, 16)


def test_ctr_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    w, ids, wgt, g = _ctr_inputs(cuda, 16, "uniform", "ones", b=8, v=100)
    fwd, grad = cuda_kernels.embedding_pool_fwd, \
        cuda_kernels.embedding_pool_grad
    with pytest.raises(ValueError, match="bfloat16 comes with the AMP"):
        fwd(w.bfloat16(), ids, wgt)
    with pytest.raises(ValueError, match="2-d"):
        fwd(w, ids.reshape(-1), wgt.reshape(-1))
    with pytest.raises(ValueError, match="2-d"):
        grad(g, ids.reshape(-1), wgt.reshape(-1), 100)
    with pytest.raises(ValueError, match="contiguous"):
        fwd(w.t().contiguous().t(), ids, wgt)
    with pytest.raises(ValueError, match="contiguous"):
        fwd(w, ids.t().contiguous().t(), wgt)
    with pytest.raises(ValueError, match="contiguous"):
        grad(torch.cat([g, g], 1)[:, :16], ids, wgt, 100)
    with pytest.raises(ValueError, match="int64"):
        grad(g, ids.int(), wgt, 100)
    ps = [torch.zeros(2048, device=cuda), torch.zeros(5, device=cuda)]
    lr = torch.full((1,), 0.1, device=cuda)
    momentum = cuda_kernels.fused_momentum
    with pytest.raises(ValueError, match="param 0 must be a float32"):
        momentum([p.bfloat16() for p in ps], ps, ps, lr, 0.9, 0.0, False)
    with pytest.raises(ValueError, match="velocity 1 must be a float32 CUDA"):
        momentum(ps, ps, [ps[0], ps[1].cpu()], lr, 0.9, 0.0, False)
    with pytest.raises(ValueError, match="lr must be a one-value"):
        momentum(ps, ps, ps, torch.zeros(2, device=cuda), 0.9, 0.0, False)


MOMENTUM_ATTRS = {
    "plain": {"mu": 0.9, "use_nesterov": False},
    "nesterov": {"mu": 0.9, "use_nesterov": True},
    "l2_decay": {"mu": 0.9, "use_nesterov": False,
                 "regularization_method": "l2_decay",
                 "regularization_coeff": 1e-4},
}


MOMENTUM_BUCKETS = {
    "kernel": [(1024, 768), (768,), (30, 7)],
    "small": [(300,), (200,)],
    # two launches, counted as one call
    "more_than_a_chunk": [(i % 5 + 1, 3) for i in range(
        2 * cuda_kernels.BUCKET_SEGMENTS_PER_LAUNCH + 7)],
    "zero_size": [(0,), (5,), (0, 3), (9,), (0,)],
    "odd_sizes": [(2,), (13, 1), (7,), (1024, 3), (5,), (4097,)],
    "clip_case": CLIP_CASE_SHAPES,
}


def _momentum_bucket(cuda, shapes, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    ins = {s: [scale * torch.randn(shape, generator=g).to(cuda)
               for shape in shapes]
           for s, scale in (("Param", 1.0), ("Grad", 1e-2),
                            ("Velocity", 1e-2))}
    ins["LearningRate"] = [torch.tensor([0.05], device=cuda)]
    return ins


def _assert_momentum_per_param(cuda, ins, attrs, fused):
    for i in range(len(ins["Param"])):
        one = get_op("momentum").fn(
            {s: [v[0] if s == "LearningRate" else v[i]]
             for s, v in ins.items()}, attrs, LoweringContext(cuda))
        for slot, outs in one.items():
            assert fused[slot][i].shape == outs[0].shape, (slot, i)
            assert torch.equal(fused[slot][i], outs[0]), (slot, i)


@pytest.mark.parametrize("kind", sorted(MOMENTUM_ATTRS))
@pytest.mark.parametrize("sizes", sorted(MOMENTUM_BUCKETS))
def test_fused_momentum_equals_per_param_momentum(cuda, sizes, kind):
    """Bit-identical to the per-param lowering on the card, one kernel
    call counted whatever the bucket: any length (a bucket under 1024
    values, which the reference keeps off its kernel, launches it too),
    more segments than one launch takes, segments of no values and
    sizes off a multiple of 4."""
    ins = _momentum_bucket(cuda, MOMENTUM_BUCKETS[sizes])
    attrs = MOMENTUM_ATTRS[kind]
    before = cuda_kernels.fused_momentum.launches
    fused = get_op("fused_momentum").fn(ins, attrs, LoweringContext(cuda))
    torch.cuda.synchronize()
    assert cuda_kernels.fused_momentum.launches == before + 1
    _assert_momentum_per_param(cuda, ins, attrs, fused)


@pytest.mark.parametrize("kind", sorted(MOMENTUM_ATTRS))
def test_fused_momentum_kernel_reads_unaligned_and_strided_inputs(cuda,
                                                                   kind):
    """Inputs that are views at an odd float offset (not 16-byte aligned)
    take the kernel's scalar path, a transposed (non-contiguous) param is
    copied by the wrapper first: still equal to the per-param lowering."""
    ins = _momentum_bucket(cuda, [(7,), (33, 2), (5,), (64, 8)], seed=2)
    for slot in ("Param", "Grad", "Velocity"):
        ins[slot][:3] = [torch.cat([torch.zeros(1, device=cuda),
                                    t.reshape(-1)])[1:].view(t.shape)
                         for t in ins[slot][:3]]
    ins["Param"][3] = ins["Param"][3].t().contiguous().t()
    assert ins["Param"][0].data_ptr() % 16 != 0
    assert not ins["Param"][3].is_contiguous()
    attrs = MOMENTUM_ATTRS[kind]
    fused = get_op("fused_momentum").fn(ins, attrs, LoweringContext(cuda))
    _assert_momentum_per_param(cuda, ins, attrs, fused)


def test_fused_momentum_op_launches_no_copy(cuda):
    """On the card the op reads the bucket where it lies: the profiler
    sees one kernel a call, the fused Momentum kernel, and no
    concatenation or other copy."""
    from torch.autograd import DeviceType
    ins = _momentum_bucket(cuda, MOMENTUM_BUCKETS["odd_sizes"])
    attrs = MOMENTUM_ATTRS["plain"]
    op = get_op("fused_momentum").fn
    op(ins, attrs, LoweringContext(cuda))
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            op(ins, attrs, LoweringContext(cuda))
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert len(names) == 3 and all("fused_momentum_kernel" in n
                                   for n in names), names


# ---------------------------------------------------------------------------
# the dropout kernels (csrc/fused_dropout.cu) against their plain versions
# ---------------------------------------------------------------------------
ACT_TOL = {torch.float32: dict(rtol=1e-6, atol=1e-6),
           torch.bfloat16: dict(rtol=2 ** -7, atol=1e-6)}


def _dropout_inputs(cuda, shape, dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(shape, generator=g).to(cuda, dtype)
            for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("rate,upscale", [(0.1, True), (0.5, False)])
@pytest.mark.parametrize("shape", [(64, 768), (7, 13)])
def test_dropout_and_dropout_add_equal_plain(cuda, dtype, rate, upscale,
                                             shape):
    from paddle_tpu_torch.ops import nn_ops
    x, r, _ = _dropout_inputs(cuda, shape, dtype)
    seed = 0x1234_5678_9ABC_DEF0
    k0, k1 = nn_ops._key_words(seed)
    thr, scale = nn_ops._threshold_for(rate), nn_ops._scale_for(rate,
                                                                 upscale)
    before = [f.launches for f in (cuda_kernels.fused_dropout,
                                   cuda_kernels.dropout_mask,
                                   cuda_kernels.fused_dropout_add)]
    out = cuda_kernels.fused_dropout(x, seed, thr, scale)
    mask = cuda_kernels.dropout_mask(x, seed, thr)
    add = cuda_kernels.fused_dropout_add(x, r, seed, thr, scale)
    torch.cuda.synchronize()
    assert [f.launches for f in (cuda_kernels.fused_dropout,
                                 cuda_kernels.dropout_mask,
                                 cuda_kernels.fused_dropout_add)] == \
        [b + 1 for b in before]
    keep = nn_ops._reference_keep(x.shape, k0, k1, thr, x.device)
    assert torch.equal(mask, keep.to(torch.uint8))
    assert torch.equal(out, nn_ops._reference_dropout(x, k0, k1, thr,
                                                      scale))
    assert torch.equal(add, nn_ops._reference_dropout_add(x, r, k0, k1, thr,
                                                          scale))
    twin = cuda_kernels.dropout_mask(x, seed + 1, thr)
    assert not torch.equal(twin, mask)


# n around the mask kernel's 32 bytes a thread and its two 16-byte stores
# (1, 3, 4, 15, 16, 17, 31: the byte tail alone; 32: one whole chunk; 33:
# a chunk and a tail), past one block's chunks (4097) and the dygraph
# step's [8192, 768]
@pytest.mark.parametrize("n", [1, 3, 4, 15, 16, 17, 31, 32, 33, 4097,
                               8192 * 768])
@pytest.mark.parametrize("seed,rate", [(0x1234_5678_9ABC_DEF0, 0.5),
                                       (987654321, 0.1)],
                         ids=["two-word-key", "one-word-key"])
def test_dropout_mask_equals_plain_on_card_and_host(cuda, n, seed, rate):
    """``torch.equal`` to ``_reference_keep`` on the card and on the host;
    a twin of seed + 1 equals the plain mask of seed + 1 and, past a
    chunk, differs from this one."""
    from paddle_tpu_torch.ops import nn_ops
    x = torch.empty(n, device=cuda)
    k0, k1 = nn_ops._key_words(seed)
    thr = nn_ops._threshold_for(rate)
    before = cuda_kernels.dropout_mask.launches
    mask = cuda_kernels.dropout_mask(x, seed, thr)
    twin = cuda_kernels.dropout_mask(x, seed + 1, thr)
    torch.cuda.synchronize()
    assert cuda_kernels.dropout_mask.launches == before + 2
    assert mask.dtype == torch.uint8 and mask.shape == (n,)
    assert torch.equal(mask, nn_ops._reference_keep(
        (n,), k0, k1, thr, cuda).to(torch.uint8))
    assert torch.equal(mask.cpu(), nn_ops._reference_keep(
        (n,), k0, k1, thr, "cpu").to(torch.uint8))
    t0, t1 = nn_ops._key_words(seed + 1)
    assert torch.equal(twin, nn_ops._reference_keep(
        (n,), t0, t1, thr, cuda).to(torch.uint8))
    if n >= 16:
        assert not torch.equal(twin, mask)


def test_dropout_mask_entry_refuses_an_unaligned_mask(cuda):
    """The C entry takes a 16-byte aligned mask only (the wrapper's
    ``torch.empty`` always is) and refuses another with
    cudaErrorInvalidValue, launching nothing."""
    lib = cuda_kernels._lib("fused_dropout")
    buf = torch.zeros(64, dtype=torch.uint8, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for off in (1, 4, 8):
        assert lib.pt_dropout_mask(buf.data_ptr() + off, 32, 1, 2, 5,
                                   stream) != 0
    assert lib.pt_dropout_mask(buf.data_ptr(), 32, 1, 2, 5, stream) == 0
    torch.cuda.synchronize()
    assert not torch.any(buf[32:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_act_dropout_forward_and_backward_match_plain(cuda, dtype, act):
    from paddle_tpu_torch.ops import nn_ops
    x, g, _ = _dropout_inputs(cuda, (33, 3072), dtype, seed=1)
    seed, rate = 987654321, 0.1
    k0, k1 = nn_ops._key_words(seed)
    thr, scale = nn_ops._threshold_for(rate), nn_ops._scale_for(rate, True)
    out = cuda_kernels.fused_act_dropout(x, seed, thr, scale, act)
    dx = cuda_kernels.fused_act_dropout_bwd(x, g, seed, thr, scale, act)
    torch.cuda.synchronize()
    want = nn_ops._reference_act_dropout(x, k0, k1, thr, scale, act)
    want_dx = nn_ops._reference_act_dropout_bwd(x, g, k0, k1, thr, scale,
                                                act)
    torch.testing.assert_close(out.float(), want.float(), **ACT_TOL[dtype])
    torch.testing.assert_close(dx.float(), want_dx.float(),
                               **ACT_TOL[dtype])
    # zeros exactly where the mask drops
    keep = nn_ops._reference_keep(x.shape, k0, k1, thr, x.device)
    assert not torch.any(out[~keep]) and not torch.any(dx[~keep])


def test_dropout_ops_launch_the_kernels_under_func_grad(cuda):
    """The three ops on CUDA tensors under torch.func.grad: one forward
    launch each (and the dropout op's mask), backward launches of the
    dropout kernel for dropout and dropout-add and of the act-dropout
    backward kernel; the gradients are the plain ones."""
    from paddle_tpu_torch.ops import nn_ops
    x, r, w = _dropout_inputs(cuda, (16, 768), torch.float32, seed=2)
    ctx = LoweringContext(cuda, base_seed=5)
    attrs = {"dropout_prob": 0.1, "op_seed": 3,
             "dropout_implementation": "upscale_in_train"}
    counted = (cuda_kernels.fused_dropout, cuda_kernels.dropout_mask,
               cuda_kernels.fused_dropout_add, cuda_kernels.fused_act_dropout,
               cuda_kernels.fused_act_dropout_bwd)
    before = [f.launches for f in counted]

    def loss(x, r):
        a = get_op("dropout").fn({"X": [x]}, attrs, ctx)["Out"][0]
        b = get_op("fused_dropout_add").fn({"X": [a], "Residual": [r]},
                                           attrs, ctx)["Out"][0]
        c = get_op("fused_act_dropout").fn({"X": [b]}, dict(attrs,
                                                           act="gelu"),
                                           ctx)["Out"][0]
        return (c * w).sum()

    gx, gr = torch.func.grad(loss, argnums=(0, 1))(x, r)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counted, before)] == \
        [3, 1, 1, 1, 1]
    k0, k1 = nn_ops._key_words(ctx.seed_for(3))
    thr, scale = nn_ops._threshold_for(0.1), nn_ops._scale_for(0.1, True)
    keep = nn_ops._reference_keep(x.shape, k0, k1, thr, x.device).float()
    b = nn_ops._reference_dropout_add(
        nn_ops._reference_dropout(x, k0, k1, thr, scale), r, k0, k1, thr,
        scale)
    want_gr = nn_ops._reference_act_dropout_bwd(b, w, k0, k1, thr, scale,
                                                "gelu")
    torch.testing.assert_close(gr, want_gr, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(gx, want_gr * keep * scale * keep * scale,
                               rtol=1e-5, atol=1e-6)


def test_dropout_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((4, 8), device=cuda)
    with pytest.raises(ValueError, match="not supported"):
        cuda_kernels.fused_dropout(x.half(), 1, 5, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.fused_dropout(x.t(), 1, 5, 1.0)
    with pytest.raises(ValueError, match="shape"):
        cuda_kernels.fused_dropout_add(x, x[:2], 1, 5, 1.0)
    with pytest.raises(ValueError, match="act"):
        cuda_kernels.fused_act_dropout(x, 1, 5, 1.0, "tanh")
    with pytest.raises(ValueError, match="64-bit"):
        cuda_kernels.fused_dropout(x, 2 ** 64, 5, 1.0)


def _paged_case(device, b, s, r, d, ps, mask, seed=0):
    """q, pools (``r`` rows, or None for just enough pages), a page table
    over a random page permutation (page 0 left out; S need not be a
    whole number of pages) and a float32 mask: ``ragged`` prefix
    lengths, ``non-prefix`` random positions, ``all-masked`` ragged with
    row 0 empty, or ``full``."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    per_seq = -(-s // ps)
    r = r if r is not None else ps * (b * per_seq + 1)
    q = torch.randn(b, d, generator=g)
    kp, vp = torch.randn(r, d, generator=g), torch.randn(r, d, generator=g)
    pages = (torch.randperm(r // ps - 1, generator=g) + 1)[:b * per_seq]
    idx = (pages.reshape(b, per_seq, 1) * ps
           + torch.arange(ps)).reshape(b, per_seq * ps)[:, :s]
    idx = idx.contiguous().int()
    if mask == "full":
        valid = torch.ones(b, s)
    elif mask == "non-prefix":
        valid = (torch.rand(b, s, generator=g) < 0.4).float()
        valid[:, -1] = 1.0
    else:
        lengths = torch.randint(1, s + 1, (b, 1), generator=g)
        valid = (torch.arange(s)[None, :] < lengths).float()
        if mask == "all-masked":
            valid[0] = 0.0
    return [t.to(device) for t in (q, kp, vp, idx, valid)]


def _paged_close(out, q, kp, vp, idx, valid, scale):
    """max |out - plain| and the 1e-5 x max |plain| bound."""
    from paddle_tpu_torch.ops.attention import _paged_reference
    ref = _paged_reference(q, kp, vp, idx, valid, scale, 1e30)
    torch.cuda.synchronize()
    return (out - ref).abs().max().item(), 1e-5 * ref.abs().max().item(), ref


@pytest.mark.parametrize("d", (64, 100, 768, 2048))
@pytest.mark.parametrize("s", (1, 17, 64, 512))
@pytest.mark.parametrize("b", (1, 5, 32))
@pytest.mark.parametrize("mask", ("full", "ragged", "non-prefix",
                                  "all-masked"))
def test_paged_attention_matches_plain(cuda, d, s, b, mask):
    """The paged-attention kernel against ``_paged_reference`` within
    1e-5 of the largest |out| (float32 online softmax over splits against
    the plain full-row softmax: another summation order), at any head
    width, 1 to 32 slots (1 to 32 splits a slot) and S not a whole
    number of chunks; a page table rolled by one page must miss on the
    partly masked rows."""
    q, kp, vp, idx, valid = _paged_case(cuda, b, s, None, d, 16, mask)
    scale = d ** -0.5
    out = cuda_kernels.paged_attention(q, kp, vp, idx, valid, scale, 1e30)
    err, tol, ref = _paged_close(out, q, kp, vp, idx, valid, scale)
    assert err <= tol
    n_valid = valid.sum(1)
    mixed = (n_valid > 0) & (n_valid < s)
    if s > 16 and mask in ("ragged", "non-prefix") and bool(mixed.any()):
        twin = cuda_kernels.paged_attention(
            q, kp, vp, torch.roll(idx, 16, 1).contiguous(), valid, scale,
            1e30)
        assert (twin - ref)[mixed].abs().max().item() > 10 * tol


@pytest.mark.parametrize("b", (1, 5))
@pytest.mark.parametrize("mask", ("full", "non-prefix"))
def test_paged_attention_is_deterministic(cuda, b, mask):
    """Two calls on the same inputs are ``torch.equal``: the partials of
    the splits merge in a fixed order whichever CTA merges them."""
    q, kp, vp, idx, valid = _paged_case(cuda, b, 512, None, 768, 16, mask,
                                        seed=2)
    outs = [cuda_kernels.paged_attention(q, kp, vp, idx, valid, 0.03, 1e30)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert cuda_kernels.paged_splits(b, 512, torch.cuda.get_device_properties(
        cuda).multi_processor_count) > 1
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("d", (30, 768, 20000))
def test_paged_attention_takes_views_at_odd_offsets(cuda, d):
    """q and the pools as views one float into their buffers, so no row
    is 16-byte aligned (d 768 and, past the ring's widths, 20,000) or
    d % 4 != 0 (d 30): the kernel's 4-byte copies and scalar reads,
    within 1e-5 of the largest |out|."""
    q, kp, vp, idx, valid = _paged_case(cuda, 5, 300, None, d, 16,
                                        "ragged", seed=3)

    def odd(t):
        buf = torch.empty(t.numel() + 1, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0 and view.is_contiguous()
        return view

    qo, kpo, vpo = odd(q), odd(kp), odd(vp)
    out = cuda_kernels.paged_attention(qo, kpo, vpo, idx, valid, 0.1, 1e30)
    err, tol, _ = _paged_close(out, q, kp, vp, idx, valid, 0.1)
    assert err <= tol


@pytest.mark.parametrize("mask", ("full", "ragged", "non-prefix"))
def test_paged_attention_shares_past_one_window(cuda, mask):
    """32 slots of 8,192 positions: each CTA's share of a row outruns the
    kernel's 512-position window, so its list is built window by window
    (and, where positions are masked, a ranked round straddles windows);
    within 1e-5 of the largest |out|."""
    q, kp, vp, idx, valid = _paged_case(cuda, 32, 8192, None, 64, 16, mask,
                                        seed=5)
    out = cuda_kernels.paged_attention(q, kp, vp, idx, valid, 0.125, 1e30)
    err, tol, _ = _paged_close(out, q, kp, vp, idx, valid, 0.125)
    assert err <= tol


@pytest.mark.parametrize("d", (16384, 16388, 20000, 20001, 30000))
@pytest.mark.parametrize("s", (16, 64))
def test_paged_attention_widest_head(cuda, d, s):
    """d = 16,384, the widest that acc holds in registers (16 float4
    columns a thread, one ring stage of one position), and wider heads,
    which walk the columns in tiles of 16,384 with no ring (d % 4 != 0 on
    the scalar path; 30,000 is past ~28,900, where a d-wide accumulator
    and q would no longer fit in shared memory), with one split (S 16) and four (S 64): within 1e-5 of the
    largest |out|."""
    q, kp, vp, idx, valid = _paged_case(cuda, 2, s, None, d, 16,
                                        "ragged", seed=6)
    out = cuda_kernels.paged_attention(q, kp, vp, idx, valid, 0.01, 1e30)
    err, tol, _ = _paged_close(out, q, kp, vp, idx, valid, 0.01)
    assert err <= tol


def test_paged_attention_workspace_is_cached_across_batch_sizes(cuda):
    """One workspace per device and stream serves calls of 32, 1, 5 and
    32 slots (it grows, never shrinks), each call right, and every
    slot's ticket back at 0 after each call."""
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for b in (32, 1, 5, 32):
        q, kp, vp, idx, valid = _paged_case(cuda, b, 512, None, 768, 16,
                                            "ragged", seed=b)
        out = cuda_kernels.paged_attention(q, kp, vp, idx, valid, 0.05, 1e30)
        err, tol, _ = _paged_close(out, q, kp, vp, idx, valid, 0.05)
        assert err <= tol, b
        tickets, part = cuda_kernels._paged_ws[(cuda, stream)]
        assert tickets.numel() >= 32 and not bool(tickets.any()), b
        assert part.numel() >= 32 * 8 * (768 + 2)
    assert [k for k in cuda_kernels._paged_ws if k[0] == cuda] == \
        [(cuda, stream)]


def test_paged_attention_op_launches_the_kernel(cuda):
    """The ``paged_attention`` op on CUDA tensors launches the kernel,
    with the flat ``[B·S]`` index the fused decode program feeds it."""
    from paddle_tpu_torch.ops.attention import _paged_reference
    q, kp, vp, idx, valid = _paged_case(cuda, 3, 32, 16 * 12, 768, 16,
                                        "ragged", seed=1)
    before = cuda_kernels.paged_attention.launches
    out = get_op("paged_attention").fn(
        {"Q": [q], "KPool": [kp], "VPool": [vp], "Index": [idx.reshape(-1)],
         "Valid": [valid]}, {"scale": 0.125, "neg": 1e30, "page_size": 16},
        LoweringContext(device=cuda))["Out"][0]
    torch.cuda.synchronize()
    assert cuda_kernels.paged_attention.launches == before + 1
    ref = _paged_reference(q, kp, vp, idx, valid, 0.125, 1e30)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_paged_attention_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, kp, vp, idx, valid = _paged_case(cuda, 2, 32, 16 * 8, 64, 16,
                                        "ragged")
    with pytest.raises(ValueError, match="float32"):
        cuda_kernels.paged_attention(q.half(), kp, vp, idx, valid, 1.0, 1e30)
    with pytest.raises(ValueError, match="int32"):
        cuda_kernels.paged_attention(q, kp, vp, idx.long(), valid, 1.0,
                                     1e30)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.paged_attention(q, kp, vp, idx.t().contiguous().t(),
                                     valid, 1.0, 1e30)
    with pytest.raises(ValueError, match="must cover"):
        cuda_kernels.paged_attention(q, kp, vp, idx[:, :16].contiguous(),
                                     valid, 1.0, 1e30)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.paged_attention(q.cpu(), kp, vp, idx, valid, 1.0, 1e30)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_resnet18_forward_and_functional_step_card_against_host(cuda, fmt):
    """ResNet-18 at 64x64, batch 4, float32, from one state on the card
    and on the host: eval logits within 1e-4 of the largest, the training
    loss within rtol 1e-4, the first-step gradients as a whole (cosine
    >= 0.99, norms within 2%; float32 moves the first layers' gradients
    by 1e-2 of the largest between two summation orders) and the fc
    layer's within 1e-3 of their largest."""
    from paddle_tpu_torch import fluid, interop
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.dygraph.functional import functional_loss
    from paddle_tpu_torch.fluid import layers as L
    from paddle_tpu_torch.vision.models import resnet18

    rng = np.random.RandomState(0)
    x = rng.randn(4, 3, 64, 64).astype("float32")
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    y = rng.randint(0, 10, (4, 1)).astype("int64")
    out = {}
    state = None
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        with dybase.guard(place):
            np.random.seed(0)
            model = resnet18(num_classes=10, data_format=fmt)
            if state is None:
                state = model.state_dict()
            interop.layer_from_numpy(model, state)
            device = dybase._dygraph_tracer().device
            xs, ys = (torch.from_numpy(a).to(device) for a in (x, y))
            model.eval()
            logits = model(dybase.to_variable(xs)).numpy()
            model.train()

            def loss_fn(i, l):
                return L.nn.mean(L.softmax_with_cross_entropy(model(i), l))

            pv, lfn = functional_loss(model, loss_fn)
            grads, loss = torch.func.grad_and_value(lfn)(pv, xs, ys)
            out[device.type] = (logits, float(loss),
                                [g.cpu().double().numpy() for g in grads])
    names = [n for n, _ in model.named_parameters()]
    (cl, closs, cg), (hl, hloss, hg) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(cl, hl, rtol=0.0,
                               atol=1e-4 * float(np.abs(hl).max()))
    np.testing.assert_allclose(closs, hloss, rtol=1e-4)
    a = np.concatenate([g.ravel() for g in cg])
    b = np.concatenate([g.ravel() for g in hg])
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.99
    assert abs(np.linalg.norm(a) / np.linalg.norm(b) - 1) <= 0.02
    for g, h, n in zip(cg, hg, names):
        if n.startswith("fc."):
            np.testing.assert_allclose(g, h, rtol=0.0,
                                       atol=1e-3 * float(np.abs(h).max()))


@pytest.mark.parametrize("rows,ids", [(4096, (256, 26)), (1 << 22, (4096, 26))],
                         ids=("small", "bench"))
def test_box_cache_gradient_is_the_same_bits_every_run(cuda, rows, ids):
    """``pull_box_sparse``'s cache gradient on the card (generic_grad's
    vjp: PyTorch's sorted accumulation into a dense zero cache) is
    ``torch.equal`` across two runs — the reference's pipelined-equals-
    serial pass contract needs it — and within 1e-6 of the largest of the
    host's ``index_add_`` in index order, at the BoxPS bench's shape too
    (4096 rows of 26 slots into a 2^22-row cache of dim 16)."""
    g = torch.Generator(device="cpu").manual_seed(3)
    w = torch.randn(rows, 16, generator=g).to(cuda)
    idx = torch.randint(0, min(rows, ids[0] * ids[1] // 2), ids,
                        generator=g).to(cuda)
    cot = torch.randn(*ids, 16, generator=g).to(cuda)
    import paddle_tpu_torch.fluid  # noqa: F401 — registers generic_grad
    op = {"fwd_type": "pull_box_sparse", "fwd_attrs": {"size": 16},
          "in_slots": ["W", "Ids"], "grad_slots": ["W"]}
    ins = {"I_W": [w], "I_Ids": [idx], "G_Out": [cot]}
    grad = get_op("generic_grad").fn
    a = grad(ins, op, LoweringContext(device=cuda))["GI_W"][0]
    b = grad(ins, op, LoweringContext(device=cuda))["GI_W"][0]
    assert torch.equal(a, b)
    host = torch.zeros(rows, 16).index_add_(
        0, idx.reshape(-1).cpu(), cot.reshape(-1, 16).cpu())
    err = (a.cpu() - host).abs().max().item()
    assert err <= 1e-6 * host.abs().max().item(), err


# the PTB LM step's shape (chip_smoke phase 4l): [20, 35, 1500], rate 0.65
PTB_SHAPE, PTB_RATE = (20, 35, 1500), 0.65


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_dropout_kernels_at_the_ptb_shape_equal_plain(cuda, dtype, impl):
    """dropout, its mask and its backward (the dropout op's own gradient,
    the forward kernel on the cotangent) at the PTB step's shape:
    ``torch.equal`` to the plain Philox versions, kept values unscaled
    under ``downgrade_in_infer``, the kept share within 6 sigma."""
    from paddle_tpu_torch.ops import nn_ops
    x, g, _ = _dropout_inputs(cuda, PTB_SHAPE, dtype, seed=3)
    seed = 0x0F1E_2D3C_4B5A_6978
    k0, k1 = nn_ops._key_words(seed)
    upscale = impl == "upscale_in_train"
    thr = nn_ops._threshold_for(PTB_RATE)
    scale = nn_ops._scale_for(PTB_RATE, upscale)
    counted = (cuda_kernels.fused_dropout, cuda_kernels.dropout_mask)
    before = [f.launches for f in counted]
    ctx = LoweringContext(cuda, base_seed=7)
    attrs = {"dropout_prob": PTB_RATE, "op_seed": 0,
             "dropout_implementation": impl}
    outs = get_op("dropout").fn({"X": [x]}, attrs, ctx)
    dx = get_op("dropout").custom_grad({"X": [x]}, None, {"Out": g},
                                       attrs, ctx)["X"][0]
    torch.cuda.synchronize()
    assert [f.launches for f in counted] == [before[0] + 2, before[1] + 1]
    o0, o1 = nn_ops._key_words(ctx.seed_for(0))
    keep = nn_ops._reference_keep(x.shape, o0, o1, thr, x.device)
    out, mask = outs["Out"][0], outs["Mask"][0]
    assert torch.equal(mask, keep.to(torch.uint8))
    assert torch.equal(out, nn_ops._reference_dropout(x, o0, o1, thr, scale))
    assert torch.equal(dx, nn_ops._reference_dropout(g, o0, o1, thr, scale))
    if not upscale:
        assert torch.equal(out[keep], x[keep])
    n = x.numel()
    kept = int(mask.sum())
    assert abs(kept - n * (1 - PTB_RATE)) < 6 * (n * PTB_RATE
                                                 * (1 - PTB_RATE)) ** 0.5
    # the kernel straight, as phase 3e calls it
    assert torch.equal(cuda_kernels.fused_dropout(x, seed, thr, scale),
                       nn_ops._reference_dropout(x, k0, k1, thr, scale))


def test_ptb_step_on_the_tape_launches_each_dropout_kernel_once(cuda):
    """A small PtbLm training step on the card's tape: three dropout
    forwards, three masks and three backwards, none of the forwards run
    again by the backward."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.models import PtbLm
    counted = (cuda_kernels.fused_dropout, cuda_kernels.dropout_mask)
    with dybase.guard(fluid.CUDAPlace(0)):
        model = PtbLm(vocab_size=100, hidden_size=32, num_layers=2,
                      dropout=0.65)
        ids = torch.randint(0, 100, (4, 35), device=cuda)
        before = [f.launches for f in counted]
        loss = model.loss(model(dybase.to_variable(ids)),
                          dybase.to_variable(ids))
        loss.backward()
        torch.cuda.synchronize()
        assert [f.launches - b for f, b in zip(counted, before)] == [6, 3]
        assert all(torch.isfinite(p.gradient_var).all()
                   for p in model.parameters())


# --- the 2.0 surface on the card (phase 4m's paths at a small width) -------
# kernel launches per Model.fit step of Transformer NMT (6 + 6 layers,
# dropout live, bf16 O1) on the tape, as PERF.md states them and
# chip_smoke.HAPI_NMT_LAUNCHES holds them: the width does not change them
HAPI_NMT_LAUNCHES = {"flash_attention_fwd": 36, "flash_attention_bwd": 18,
                     "fused_dropout": 66, "dropout_mask": 18,
                     "fused_dropout_add": 60, "fused_act_dropout": 24,
                     "fused_act_dropout_bwd": 12}


def test_nmt_model_fit_step_launches_as_stated(cuda):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import fluid, nn, optimizer
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.models import TransformerModel
    names = ("flash_attention_fwd", "flash_attention_bwd", "fused_adam",
             "fused_dropout", "dropout_mask", "fused_dropout_add",
             "fused_act_dropout", "fused_act_dropout_bwd")
    rng = np.random.RandomState(0)
    src, tgt_in, tgt_out = (rng.randint(0, 512, (4, 16)).astype("int64")
                            for _ in range(3))
    data = list(zip(src, tgt_in, tgt_out[..., None]))
    with dybase.guard(fluid.CUDAPlace(0)):
        np.random.seed(0)
        net = TransformerModel(src_vocab=512, tgt_vocab=512, d_model=128,
                               nhead=2, dim_feedforward=256, dropout=0.1,
                               max_len=17)
        model = paddle.Model(net)
        model.prepare(optimizer=optimizer.Adam(
            1e-4, parameters=net.parameters()),
            loss=nn.CrossEntropyLoss(), amp_level="O1")
        model.fit(data, batch_size=4, epochs=1, verbose=0, shuffle=False)
        for n in names:
            getattr(cuda_kernels, n).launches = 0
        model.fit(data, batch_size=4, epochs=1, verbose=0, shuffle=False)
        torch.cuda.synchronize()
    got = {n: getattr(cuda_kernels, n).launches for n in names}
    assert got == {n: HAPI_NMT_LAUNCHES.get(n, 0) for n in names}


def test_paddle_grad_double_backward_equals_torch(cuda):
    """A gradient penalty through paddle.grad(create_graph=True) and
    backward(): the parameters' gradients equal torch.autograd.grad's
    double backward of the same function within 1e-5 relative."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.fluid import layers as L
    rng = np.random.RandomState(1)
    arrays = [rng.randn(16, 8), rng.randn(8, 12) / 3, 0.1 * rng.randn(12),
              rng.randn(12, 1) / 3]
    with dybase.guard(fluid.CUDAPlace(0)):
        x, w1, b1, w2 = (dybase.to_variable(a.astype("float32"))
                         for a in arrays)
        for v in (x, w1, b1, w2):
            v.stop_gradient = False
        y = L.reduce_sum(L.matmul(L.tanh(L.elementwise_add(
            L.matmul(x, w1), b1)), w2))
        (g,) = paddle.grad([y], [x], create_graph=True)
        norm = L.sqrt(L.reduce_sum(L.square(g), dim=1))
        L.reduce_mean(L.square(norm - 1.0)).backward()
        got = [v.gradient_var for v in (w1, b1, w2)]
    tx, tw1, tb1, tw2 = (torch.tensor(a, dtype=torch.float32, device="cuda",
                                      requires_grad=True) for a in arrays)
    ty = torch.sum(torch.tanh(tx @ tw1 + tb1) @ tw2)
    (tg,) = torch.autograd.grad(ty, tx, create_graph=True)
    pen = torch.mean((torch.sqrt(torch.sum(tg * tg, dim=1)) - 1.0) ** 2)
    want = torch.autograd.grad(pen, [tw1, tb1, tw2])
    for a, b in zip(got, want):
        assert float((a - b).abs().max() / b.abs().max()) < 1e-5


# --- the master paths of fused Adam and fused Momentum ---------------------------
MASTER_BUCKETS = {
    "one": [(1000, 3)],
    "odd_sizes": [(2,), (13, 1), (7,), (1024, 3), (5,), (4097,)],
    "more_than_a_chunk": [(i % 5 + 1, 3) for i in range(
        2 * cuda_kernels.BUCKET_SEGMENTS_PER_LAUNCH + 7)],
}


def _master_bucket(cuda, shapes, opt, low=torch.bfloat16, seed=0,
                   unaligned=False):
    """A bucket with fp32 masters: bfloat16 (or ``low``) params, the
    masters their exact widening plus a residue the params cannot hold,
    grads in the params' dtype, float32 moments or velocities.  With
    ``unaligned`` the first grads are views at an odd 16-bit offset (the
    kernel's scalar path)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    ins = {"Param": [], "MasterParam": [], "Grad": []}
    if opt == "adam":
        ins.update(Moment1=[], Moment2=[], Beta1Pow=[], Beta2Pow=[])
    else:
        ins["Velocity"] = []
    for i, shape in enumerate(shapes):
        master = torch.randn(shape, generator=g)
        ins["Param"].append(master.to(low))
        ins["MasterParam"].append(master + 1e-4 * torch.randn(
            shape, generator=g))
        ins["Grad"].append((1e-2 * torch.randn(shape, generator=g)).to(low))
        if opt == "adam":
            ins["Moment1"].append(1e-3 * torch.randn(shape, generator=g))
            ins["Moment2"].append(1e-5 * torch.rand(shape, generator=g))
            ins["Beta1Pow"].append(torch.tensor([0.9 ** (i % 7 + 2)]))
            ins["Beta2Pow"].append(torch.tensor([0.999 ** (i % 7 + 2)]))
        else:
            ins["Velocity"].append(1e-2 * torch.randn(shape, generator=g))
    ins["LearningRate"] = [torch.tensor([1e-3 if opt == "adam" else 0.05])]
    ins = {s: [t.to(cuda) for t in v] for s, v in ins.items()}
    if unaligned:
        ins["Grad"][:3] = [torch.cat([torch.zeros(1, dtype=t.dtype,
                                                  device=cuda),
                                      t.reshape(-1)])[1:].view(t.shape)
                           for t in ins["Grad"][:3]]
    return ins


def _assert_per_param(cuda, op, ins, attrs, fused):
    ctx = LoweringContext(cuda)
    for i in range(len(ins["Param"])):
        one = get_op(op).fn({s: [v[0] if s == "LearningRate" else v[i]]
                             for s, v in ins.items()}, attrs, ctx)
        assert sorted(one) == sorted(fused)
        for slot, outs in one.items():
            assert fused[slot][i].dtype == outs[0].dtype, (slot, i)
            assert torch.equal(fused[slot][i], outs[0]), (slot, i)


def _assert_plain(fused, plain):
    for slot, outs in plain.items():
        for a, b in zip(fused[slot], outs):
            assert torch.equal(a, b.to(a.device)), slot


ADAM_ATTRS = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}


@pytest.mark.parametrize("low", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("bucket", sorted(MASTER_BUCKETS))
def test_fused_adam_master_equals_per_param_and_plain(cuda, bucket, low):
    """The master path on the card: every output ``torch.equal`` to the
    per-param ``adam`` op with ``MasterParam`` and to the plain version
    on the host (widen, update the master, round), one launch counted on
    ``fused_adam_master`` and none on ``fused_adam``."""
    from paddle_tpu_torch.ops.optimizer_ops import _plain_fused_adam
    ins = _master_bucket(cuda, MASTER_BUCKETS[bucket], "adam", low)
    before = (cuda_kernels.fused_adam_master.launches,
              cuda_kernels.fused_adam.launches)
    fused = get_op("fused_adam").fn(ins, ADAM_ATTRS, LoweringContext(cuda))
    torch.cuda.synchronize()
    assert (cuda_kernels.fused_adam_master.launches,
            cuda_kernels.fused_adam.launches) == (before[0] + 1, before[1])
    _assert_per_param(cuda, "adam", ins, ADAM_ATTRS, fused)
    host = {s: [t.cpu() for t in v] for s, v in ins.items()}
    _assert_plain(fused, _plain_fused_adam(
        host["MasterParam"], host["Grad"], host["Moment1"],
        host["Moment2"], host["LearningRate"][0], host["Beta1Pow"],
        host["Beta2Pow"], 0.9, 0.999, 1e-8, lo=host["Param"]))


@pytest.mark.parametrize("kind", sorted(MOMENTUM_ATTRS))
@pytest.mark.parametrize("bucket", sorted(MASTER_BUCKETS))
def test_fused_momentum_master_equals_per_param_and_plain(cuda, bucket,
                                                          kind):
    from paddle_tpu_torch.ops.optimizer_ops import _plain_fused_momentum, \
        _l2_coeff
    ins = _master_bucket(cuda, MASTER_BUCKETS[bucket], "momentum")
    attrs = MOMENTUM_ATTRS[kind]
    before = (cuda_kernels.fused_momentum_master.launches,
              cuda_kernels.fused_momentum.launches)
    fused = get_op("fused_momentum").fn(ins, attrs, LoweringContext(cuda))
    torch.cuda.synchronize()
    assert (cuda_kernels.fused_momentum_master.launches,
            cuda_kernels.fused_momentum.launches) == (before[0] + 1,
                                                      before[1])
    _assert_per_param(cuda, "momentum", ins, attrs, fused)
    host = {s: [t.cpu() for t in v] for s, v in ins.items()}
    _assert_plain(fused, _plain_fused_momentum(
        host["MasterParam"], host["Grad"], host["Velocity"],
        host["LearningRate"][0], attrs.get("mu", 0.9), _l2_coeff(attrs),
        attrs.get("use_nesterov", False), lo=host["Param"]))


@pytest.mark.parametrize("opt", ["adam", "momentum"])
def test_fused_master_reads_unaligned_and_float32_grads(cuda, opt):
    """Grads that are views at an odd 16-bit offset take the scalar
    path; a bucket whose grads are float32 (a bf16 param's grad widened
    upstream) reads them as they are: both equal to the per-param op."""
    attrs = ADAM_ATTRS if opt == "adam" else MOMENTUM_ATTRS["plain"]
    for unaligned in (True, False):
        ins = _master_bucket(cuda, [(7,), (33, 2), (5,), (64, 8)], opt,
                             seed=2, unaligned=unaligned)
        if unaligned:
            assert ins["Grad"][0].data_ptr() % 8 != 0
        else:
            ins["Grad"] = [g.float() for g in ins["Grad"]]
        fused = get_op(f"fused_{opt}").fn(ins, attrs, LoweringContext(cuda))
        _assert_per_param(cuda, opt, ins, attrs, fused)


@pytest.mark.parametrize("b", [1, 3, 8])
def test_verify_program_launches_the_paged_kernel_spec_k_times(cuda, b):
    """Speculative decode's verify program of spec_k = 4 chained paged
    steps, after ``fuse_paged_attention``, on the card: one paged-kernel
    launch a block, and each block's logits ``torch.equal`` to the plain
    fused paged step at the same position, over the pool the plain steps
    wrote, at the same batch (so the same products and the same split of
    the kernel)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.passes import (PassPipeline,
                                               passes_for_build_strategy)
    from paddle_tpu_torch.serving import decode

    k, ps, s, d, rows = 4, 16, 128, 128, 16 * 80
    model = decode.build_demo_decode_model(
        vocab=97, d_model=d, max_len=s, seed=3, page_size=ps,
        executor=fluid.Executor(fluid.CUDAPlace(0)), scope=fluid.Scope())
    bs = fluid.BuildStrategy()
    bs.fuse_paged_attention = True
    vprog, vnames = model.verify_program(rows, k)
    pprog, pname = model.paged_program(rows)
    for prog, targets in ((vprog, vnames), (pprog, [pname])):
        PassPipeline(passes_for_build_strategy(bs)).apply(prog,
                                                          targets=targets)
    assert [op.type for op in vprog.global_block().ops].count(
        "paged_attention") == k
    rng = np.random.RandomState(b)
    pools = [torch.from_numpy(rng.randn(rows, d).astype("float32")).to(cuda)
             for _ in range(2)]
    per = s // ps
    pages = rng.permutation(rows // ps - 1)[:b * per] + 1
    pt = torch.from_numpy((pages.reshape(b, per, 1) * ps + np.arange(ps))
                          .reshape(b, s).astype("int32")).to(cuda)
    pos = rng.randint(1, s - k, (b, 1)).astype("float32")
    toks = rng.randint(0, 97, (b, k)).astype("int64")
    ptc = pt.cpu().numpy()
    widx = np.stack([ptc[i, int(pos[i, 0]):int(pos[i, 0]) + k]
                     for i in range(b)]).astype("int64")
    ar = np.arange(s, dtype="float32")[None, :]

    def scope():
        sc = fluid.Scope(parent=model.scope)
        sc.set_var("k_pool", pools[0].clone())
        sc.set_var("v_pool", pools[1].clone())
        sc.set_var("pt", pt)
        return sc

    vs = scope()
    torch.cuda.synchronize()
    before = cuda_kernels.paged_attention.launches
    got = model.executor.run(vprog, feed={"toks": toks, "widx": widx,
                                          "pos": pos, "arange": ar},
                             fetch_list=vnames, scope=vs)
    assert cuda_kernels.paged_attention.launches - before == k
    ps_ = scope()
    for j in range(k):
        want, = model.executor.run(
            pprog, feed={"tok": toks[:, j:j + 1], "widx": widx[:, j:j + 1],
                         "pos": pos + j, "arange": ar},
            fetch_list=[pname], scope=ps_)
        assert np.array_equal(got[j], want), j
    for n in ("k_pool", "v_pool"):
        assert torch.equal(vs.find_var(n), ps_.find_var(n))


# --- the static RNN tier (phase 4r's paths at a small width) ----------------
def test_cudnn_lstm_on_the_card_against_the_host(cuda):
    """The ``cudnn_lstm`` op at two layers on cuDNN against its host loop
    (``rnn_scan``'s LSTM): outputs and the ``torch.func.vjp`` gradients
    into the input and the flat W within 1e-4 of each one's largest
    |value| (the file's float32 tolerance: cuDNN's products sum in
    another order); on the card the tape's gradients equal
    ``torch.func``'s bit for bit."""
    t, b, d, h, n = 6, 3, 5, 8, 2
    size = sum(4 * h * (d if i == 0 else h) + 4 * h * h + 8 * h
               for i in range(n))
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(t, b, d, generator=g), torch.randn(size, generator=g)
    h0, c0 = torch.randn(n, b, h, generator=g), torch.randn(n, b, h,
                                                            generator=g)
    cots = (torch.randn(t, b, h, generator=g),
            torch.randn(n, b, h, generator=g),
            torch.randn(n, b, h, generator=g))
    lowering = get_op("cudnn_lstm").fn

    def run(device):
        hd, cd = h0.to(device), c0.to(device)

        def f(x, w):
            o = lowering({"Input": [x], "W": [w], "InitH": [hd],
                          "InitC": [cd]}, {"num_layers": n, "hidden_size": h},
                         LoweringContext(device=device))
            return o["Out"][0], o["LastH"][0], o["LastC"][0]
        outs, vjp = torch.func.vjp(f, x.to(device), w.to(device))
        return f, outs, vjp(tuple(c.to(device) for c in cots))

    f, card_outs, card_grads = run(cuda)
    _, host_outs, host_grads = run("cpu")
    for got, want in zip(card_outs + card_grads, host_outs + host_grads):
        scale = float(want.abs().max())
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=1e-4 * scale)
    xl = x.to(cuda).requires_grad_()
    wl = w.to(cuda).requires_grad_()
    tape = torch.autograd.grad(f(xl, wl), (xl, wl),
                               tuple(c.to(cuda) for c in cots))
    assert all(torch.equal(a, b) for a, b in zip(tape, card_grads))


def test_static_ptb_step_launches_each_dropout_kernel_twice(cuda):
    """A small static PTB program (embedding, dropout, ``layers.lstm``,
    dropout, fc) trained on the card: each training step launches 4
    dropouts (two forwards, two backwards from the same seeds) and 2
    masks, and the loss is finite."""
    import paddle_tpu_torch.fluid as fluid

    v, hid, n, bsz, t = 100, 32, 2, 4, 35
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        L = fluid.layers
        ids = fluid.data("ids", [bsz, t], "int64")
        lbl = fluid.data("lbl", [bsz, t], "int64")
        h0 = fluid.data("h0", [n, bsz, hid])
        emb = L.dropout(L.embedding(ids, [v, hid]), 0.65,
                        dropout_implementation="upscale_in_train")
        out, _, _ = L.lstm(L.transpose(emb, [1, 0, 2]), h0, h0, t, hid, n)
        out = L.dropout(L.transpose(out, [1, 0, 2]), 0.65,
                        dropout_implementation="upscale_in_train")
        logits = L.fc(out, v, num_flatten_dims=2)
        loss = L.mean(L.softmax_with_cross_entropy(
            L.reshape(logits, [-1, v]), L.reshape(lbl, [-1, 1])))
        fluid.optimizer.SGD(learning_rate=1.0).minimize(loss)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"ids": rng.randint(0, v, (bsz, t)).astype("int64"),
            "lbl": rng.randint(0, v, (bsz, t)).astype("int64"),
            "h0": np.zeros((n, bsz, hid), "float32")}
    counted = (cuda_kernels.fused_dropout, cuda_kernels.dropout_mask)
    before = [f.launches for f in counted]
    got, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counted, before)] == [4, 2]
    assert np.isfinite(got).all()


# --- the image layers (phase 4s's ops at small shapes) -------------------
def _r(*shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


IMAGE_CASES = {
    "conv2d_transpose output_padding": (
        "conv2d_transpose", {"Input": _r(2, 4, 7, 6), "Filter": _r(4, 3, 3, 3,
                                                                   seed=1)},
        {"strides": [2, 2], "paddings": [1, 1], "output_padding": [1, 1]}),
    "conv2d_transpose output_size grouped": (
        "conv2d_transpose", {"Input": _r(2, 4, 7, 6), "Filter": _r(4, 3, 3, 3,
                                                                   seed=2)},
        {"strides": [2, 2], "paddings": [1, 0, 1, 1], "groups": 2,
         "output_size": [15, 12]}),
    "nearest_interp": ("nearest_interp", {"X": _r(2, 3, 5, 7)},
                       {"out_h": 9, "out_w": 4}),
    "bilinear_interp align_mode 0": ("bilinear_interp", {"X": _r(2, 3, 5, 7)},
                                     {"out_h": 9, "out_w": 4,
                                      "align_mode": 0}),
    "bilinear_interp corners NHWC": ("bilinear_interp", {"X": _r(2, 5, 7, 3)},
                                     {"out_h": 3, "out_w": 11,
                                      "align_corners": True,
                                      "data_layout": "NHWC"}),
    "bicubic_interp": ("bicubic_interp", {"X": _r(2, 3, 5, 7)},
                       {"out_h": 11, "out_w": 5}),
    "trilinear_interp": ("trilinear_interp", {"X": _r(1, 2, 4, 5, 3)},
                         {"out_d": 7, "out_h": 3, "out_w": 6}),
    "instance_norm": ("instance_norm", {"X": _r(2, 4, 6, 5), "Scale": _r(4),
                                        "Bias": _r(4, seed=3)}, {}),
    "group_norm": ("group_norm", {"X": _r(2, 4, 6, 5), "Scale": _r(4),
                                  "Bias": _r(4, seed=3)}, {"groups": 2}),
    "pad2d reflect": ("pad2d", {"X": _r(2, 3, 5, 7)},
                      {"paddings": [3, 1, 2, 6], "mode": "reflect"}),
    "pad2d reflect past the side": ("pad2d", {"X": _r(2, 3, 5, 7)},
                                    {"paddings": [6, 2, 0, 9],
                                     "mode": "reflect"}),
    "pool3d max": ("pool3d", {"X": _r(1, 3, 5, 6, 4)},
                   {"pooling_type": "max", "ksize": [2, 3, 2],
                    "strides": [1, 2, 2], "paddings": [1, 1, 0]}),
    "pool3d avg": ("pool3d", {"X": _r(1, 3, 5, 6, 4)},
                   {"pooling_type": "avg", "ksize": [3, 3, 3],
                    "strides": [2, 1, 1], "paddings": [1, 1, 1]}),
}


@pytest.mark.parametrize("case", sorted(IMAGE_CASES))
def test_image_lowering_on_the_card_against_the_host(cuda, case):
    """Each image-layer lowering and its ``torch.func.vjp`` (the route
    ``generic_grad`` takes) on the card against the host, within 1e-4 of
    each output's largest |value| (cuDNN's and torch's reductions sum in
    other orders); a reflection pad's backward, slices and sums with no
    atomics, gives the same bits twice."""
    op, ins, attrs = IMAGE_CASES[case]
    lowering = get_op(op).fn
    names = list(ins)

    def run(device):
        def f(*xs):
            out = lowering({k: [x] for k, x in zip(names, xs)}, dict(attrs),
                           LoweringContext(device=torch.device(device)))
            return next(iter(out.values()))[0]
        xs = [ins[k].to(device) for k in names]
        out, vjp = torch.func.vjp(f, *xs)
        cot = torch.randn(out.shape, generator=torch.Generator()
                          .manual_seed(7)).to(device)
        return [out] + list(vjp(cot)), lambda: vjp(cot)

    card, again = run(cuda)
    host, _ = run("cpu")
    for got, want in zip(card, host):
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
    if op == "pad2d":
        assert all(torch.equal(a, b) for a, b in zip(again(), card[1:]))


def _ids(hi, *shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, hi, shape).astype("int64"))


# gathers whose gradients add into repeated rows: SRL's two-row mark table
# (640 ids), a CoNLL-05-sized predicate table, the CRF's labels, CTC's
# extended label (the blank repeated in every other place)
REPEAT_CASES = {
    "lookup_table_v2 two rows": ("lookup_table_v2",
                                 {"W": _r(2, 5), "Ids": _ids(2, 10, 64)},
                                 {}),
    "lookup_table_v2 3162 rows": ("lookup_table_v2",
                                  {"W": _r(3162, 32), "Ids": _ids(40, 10, 64)},
                                  {}),
    "linear_chain_crf": ("linear_chain_crf",
                         {"Emission": _r(10, 64, 59),
                          "Transition": _r(61, 59, seed=3),
                          "Label": _ids(59, 10, 64, seed=4),
                          "Length": _ids(48, 10, seed=5) + 16}, {}),
    "warpctc": ("warpctc", {"Logits": _r(32, 64, 96),
                            "Label": _ids(95, 32, 24, seed=6),
                            "LabelLength": _ids(20, 32, seed=7) + 4},
                {"blank": 95, "norm_by_times": True}),
}


@pytest.mark.parametrize("case", sorted(REPEAT_CASES))
def test_repeated_gather_gradient_is_the_same_bits_twice(cuda, case):
    """A gather's gradient over repeated indices (the embedding's rows,
    the CRF's label one-hots, CTC's extended label) sums in a fixed order
    on the card: two vjps give the same bits, and the host's values
    within 1e-4 of the largest."""
    op, ins, attrs = REPEAT_CASES[case]
    lowering = get_op(op).fn
    diff = [k for k in ins if ins[k].dtype == torch.float32]

    def run(device):
        fixed = {k: [v.to(device)] for k, v in ins.items()}

        def f(*xs):
            out = lowering(dict(fixed, **{k: [x] for k, x in zip(diff, xs)}),
                           dict(attrs),
                           LoweringContext(device=torch.device(device)))
            return next(iter(out.values()))[0]
        out, vjp = torch.func.vjp(f, *[ins[k].to(device) for k in diff])
        cot = torch.randn(out.shape, generator=torch.Generator()
                          .manual_seed(9)).to(device)
        return [out] + list(vjp(cot)), lambda: vjp(cot)

    card, again = run(cuda)
    assert all(torch.equal(a, b) for a, b in zip(again(), card[1:]))
    host, _ = run("cpu")
    for got, want in zip(card, host):
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))


def _boxes(n, extent, seed=0, size=(16.0, 400.0)):
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(n, 2, generator=g) * (extent - size[0])
    wh = size[0] + torch.rand(n, 2, generator=g) * (size[1] - size[0])
    return torch.cat([xy, torch.clamp(xy + wh, max=extent)], 1)


def _yolo_gt_one_cell(b, g):
    """[b, g, 4] ground truths sharing one cell and one anchor's shape,
    so their gradients add into the same head rows."""
    gt = torch.tensor([0.52, 0.47, 0.1, 0.12]).repeat(b, g, 1)
    return gt + torch.rand(b, g, 4, generator=torch.Generator()
                           .manual_seed(8)) * 0.01


# the detection tier's gathering ops at Faster R-CNN's and YOLOv3's shapes:
# 512 overlapping RoIs read the same pixels (bilinear taps, bins, position-
# sensitive groups), deformable taps land on the same pixels, ground truths
# share a head cell, YOLOv3's corner-aligned 2x upsampling reads a row two
# or three times
DETECTION_REPEAT_CASES = {
    "roi_align": ("roi_align", {"X": _r(1, 64, 50, 84),
                                "ROIs": _boxes(512, 800.0, seed=1)},
                  {"pooled_height": 7, "pooled_width": 7,
                   "spatial_scale": 1 / 16, "sampling_ratio": 2}),
    "roi_pool": ("roi_pool", {"X": _r(1, 64, 50, 84, seed=2),
                              "ROIs": _boxes(512, 800.0, seed=3)},
                 {"pooled_height": 7, "pooled_width": 7,
                  "spatial_scale": 1 / 16}),
    "psroi_pool": ("psroi_pool", {"X": _r(1, 8 * 49, 50, 84, seed=4),
                                  "ROIs": _boxes(512, 800.0, seed=5)},
                   {"pooled_height": 7, "pooled_width": 7,
                    "spatial_scale": 1 / 16, "output_channels": 8}),
    "deformable_conv": ("deformable_conv",
                        {"Input": _r(2, 32, 19, 19, seed=6),
                         "Offset": _r(2, 18, 19, 19, seed=7) * 2,
                         "Mask": torch.rand(2, 9, 19, 19,
                                           generator=torch.Generator()
                                           .manual_seed(8)),
                         "Filter": _r(32, 32, 3, 3, seed=9) * 0.1},
                        {"strides": [1, 1], "paddings": [1, 1]}),
    "deformable_conv_v1": ("deformable_conv_v1",
                           {"Input": _r(2, 32, 19, 19, seed=10),
                            "Offset": _r(2, 18, 19, 19, seed=11) * 2,
                            "Filter": _r(32, 32, 3, 3, seed=12) * 0.1},
                           {"strides": [1, 1], "paddings": [1, 1]}),
    "nearest_interp 19 to 38": ("nearest_interp",
                                {"X": _r(2, 64, 19, 19, seed=15)},
                                {"out_h": 38, "out_w": 38,
                                 "align_corners": True}),
    "yolov3_loss": ("yolov3_loss", {"X": _r(2, 3 * 85, 19, 19, seed=13),
                                    "GTBox": _yolo_gt_one_cell(2, 8),
                                    "GTLabel": _ids(80, 2, 8, seed=14)},
                    {"anchors": [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59,
                                 119, 116, 90, 156, 198, 373, 326],
                     "anchor_mask": [6, 7, 8], "class_num": 80,
                     "downsample_ratio": 32}),
}


@pytest.mark.parametrize("case", sorted(DETECTION_REPEAT_CASES))
def test_detection_gather_gradient_is_the_same_bits_twice(cuda, case):
    """The detection tier's gathers (``roi_align``'s bilinear taps and the
    RoI pools as one-hot products, the deformable taps, the YOLOv3 head's
    rows and the interpolations' rows as ``F.embedding``) sum their
    gradients in a fixed order
    on the card: two vjps from one cotangent give the same bits, and the
    host's values within 1e-4 of the largest."""
    op, ins, attrs = DETECTION_REPEAT_CASES[case]
    opdef = get_op(op)
    diff = [k for k, v in ins.items() if v.dtype == torch.float32
            and k not in opdef.nondiff_inputs]

    def run(device):
        fixed = {k: [v.to(device)] for k, v in ins.items()}

        def f(*xs):
            out = opdef.fn(dict(fixed, **{k: [x] for k, x in zip(diff, xs)}),
                           dict(attrs),
                           LoweringContext(device=torch.device(device)))
            return next(iter(out.values()))[0]
        out, vjp = torch.func.vjp(f, *[ins[k].to(device) for k in diff])
        cot = torch.randn(out.shape, generator=torch.Generator()
                          .manual_seed(9)).to(device)
        return [out] + list(vjp(cot)), lambda: vjp(cot)

    card, again = run(cuda)
    assert all(torch.equal(a, b) for a, b in zip(again(), card[1:]))
    host, _ = run("cpu")
    for got, want in zip(card, host):
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
