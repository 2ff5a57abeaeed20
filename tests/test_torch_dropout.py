"""The dropout family's contract: ``dropout``, ``fused_dropout_add`` and
``fused_act_dropout`` in paddle_tpu_torch, on the CPU (their plain
versions, the Philox bits the CUDA kernels draw).

Masks are never compared across packages: the reference draws from
``jax.random`` or the TPU core's PRNG.  What is held instead:

* Philox4x32-10 gives Random123's published known answers;
* ``_threshold_for`` is the reference's;
* rate 0 and ``is_test`` give exactly the reference's output (gelu, whose
  erf the libraries round differently, within 1e-6);
* the kept fraction lies within 6 sigma of 1 - rate;
* ``Out == X * Mask * scale``, and the mask depends on (seed, flat index)
  alone;
* the backward regenerates the forward's mask, through
  ``torch.func.grad`` and through the tape's ``generic_grad``;
* the port's gelu and its derivative match the reference kernel's
  ``_act_fns("gelu")`` (pure jnp) within 1e-6;
* the tape path's gradients of a small BERT with dropout 0.1 live equal
  the functional path's within 1e-6 of each tensor's largest magnitude
  (plus 1e-6 of the largest over all tensors).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu  # noqa: F401 — registers the reference lowerings
from paddle_tpu.ops import registry as jreg
from paddle_tpu.ops.pallas_kernels import _act_fns, \
    _threshold_for as j_threshold_for

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.dygraph import base as tdy
from paddle_tpu_torch.dygraph.functional import functional_loss
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid.backward import _generic_grad
from paddle_tpu_torch.models.bert import BertForPretraining
from paddle_tpu_torch.ops import cuda_kernels, nn_ops
from paddle_tpu_torch.ops import registry as treg

R = np.random.RandomState(3)


def _f(*shape):
    return R.randn(*shape).astype("float32")


def _ctx(**kw):
    return treg.LoweringContext(base_seed=12345, **kw)


def _run(op_type, ins, attrs, ctx=None):
    return treg.get_op(op_type).fn(ins, dict(attrs), ctx or _ctx())


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------
KAT = [  # Random123 kat_vectors, philox4x32_10: counter, key, output
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("counter,key,want", KAT, ids=["zeros", "ones",
                                                       "pi"])
def test_philox_known_answers(counter, key, want):
    words = nn_ops.philox4x32(
        *(torch.tensor([c], dtype=torch.int64) for c in counter), *key)
    assert tuple(int(w) for w in words) == want


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.999])
def test_threshold_is_the_reference(rate):
    assert nn_ops._threshold_for(rate) == j_threshold_for(rate)


def test_mask_depends_on_seed_and_flat_index_only():
    a = nn_ops._reference_bits((3, 8), 7, 9, "cpu")
    b = nn_ops._reference_bits((101,), 7, 9, "cpu")
    assert torch.equal(a.reshape(-1), b[:24])
    assert not torch.equal(a, nn_ops._reference_bits((3, 8), 8, 9, "cpu"))
    assert int(b.min()) >= 0 and int(b.max()) < 2 ** 32


def _numpy_philox4x32_10(j, k0, k1):
    """Philox4x32-10 of counters (j mod 2^32, j >> 32, 0, 0) in numpy
    uint64 arithmetic, written from Random123's definition apart from
    ``nn_ops``; returns the four words, each of j's shape."""
    m = 0xFFFFFFFF
    x = [j & m, j >> 32, np.zeros_like(j), np.zeros_like(j)]
    k = [np.uint64(k0), np.uint64(k1)]
    for r in range(10):
        if r:
            k = [(k[0] + np.uint64(0x9E3779B9)) & np.uint64(m),
                 (k[1] + np.uint64(0xBB67AE85)) & np.uint64(m)]
        p0 = np.uint64(0xD2511F53) * x[0]
        p1 = np.uint64(0xCD9E8D57) * x[2]
        x = [(p1 >> np.uint64(32)) ^ x[1] ^ k[0], p1 & np.uint64(m),
             (p0 >> np.uint64(32)) ^ x[3] ^ k[1], p0 & np.uint64(m)]
    return x


# the mask kernel draws eight groups a thread into two 16-byte stores and
# writes a shorter tail byte by byte: n off a multiple of 32 takes that
# tail, after whole chunks from n = 33 on
@pytest.mark.parametrize("n", [1, 3, 15, 17, 31, 33, 4097])
@pytest.mark.parametrize("seed,rate", [(0x1234_5678_9ABC_DEF0, 0.5),
                                       (987654321, 0.1)],
                         ids=["two-word-key", "one-word-key"])
def test_plain_mask_matches_numpy_philox(n, seed, rate):
    # the numpy generator gives Random123's known answer at counter 0
    assert tuple(int(w[0]) for w in _numpy_philox4x32_10(
        np.zeros(1, np.uint64), 0, 0)) == KAT[0][2]
    k0, k1 = nn_ops._key_words(seed)
    thr = nn_ops._threshold_for(rate)
    j = np.arange((n + 3) // 4, dtype=np.uint64)
    words = np.stack(_numpy_philox4x32_10(j, k0, k1), axis=-1).reshape(-1)
    want = (words[:n] >= thr).astype(np.uint8)
    got = nn_ops._mask_launch(torch.zeros(n), k0, k1, thr)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# rate 0 and is_test: exactly the reference
# ---------------------------------------------------------------------------
def _semantic_cases():
    x, r = _f(4, 6), _f(4, 6)
    out = []
    for impl in ("upscale_in_train", "downgrade_in_infer"):
        for rate, is_test in ((0.0, False), (0.3, True)):
            base = {"dropout_prob": rate, "is_test": is_test,
                    "dropout_implementation": impl, "op_seed": 4}
            tag = f"{impl}-{'test' if is_test else 'rate0'}"
            out.append((f"dropout-{tag}", "dropout", {"X": [x]}, base))
            out.append((f"dropout_add-{tag}", "fused_dropout_add",
                        {"X": [x], "Residual": [r]}, base))
            for act in ("gelu", "relu"):
                out.append((f"act_dropout_{act}-{tag}", "fused_act_dropout",
                            {"X": [x]}, dict(base, act=act)))
    return out


@pytest.mark.parametrize("name,op_type,ins,attrs", _semantic_cases(),
                         ids=[c[0] for c in _semantic_cases()])
def test_rate_zero_and_is_test_are_the_reference(name, op_type, ins, attrs):
    j_out = jreg.get_op(op_type).fn(
        {s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
        dict(attrs), jreg.LoweringContext())
    t_out = _run(op_type, {s: [torch.from_numpy(a) for a in v]
                           for s, v in ins.items()}, attrs)
    assert set(j_out) == set(t_out)
    for slot in j_out:
        want, got = np.asarray(j_out[slot][0]), t_out[slot][0].numpy()
        if "gelu" in name:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# live dropout: fraction, Out == X * Mask * scale, the regenerated mask
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
def test_out_is_x_times_mask_times_scale(impl, rate, dtype):
    x = torch.from_numpy(_f(200, 250)).to(dtype)
    outs = _run("dropout", {"X": [x]},
                {"dropout_prob": rate, "dropout_implementation": impl,
                 "op_seed": 21})
    out, mask = outs["Out"][0], outs["Mask"][0]
    assert mask.dtype == torch.uint8 and out.dtype == dtype
    n = mask.numel()
    kept = int(mask.sum())
    sigma = math.sqrt(n * rate * (1 - rate))
    assert abs(kept - n * (1 - rate)) < 6 * sigma, (kept, n)
    scale = np.float32(1 / (1 - rate)) if impl == "upscale_in_train" else 1
    want = (x.float() * mask.float() * float(scale)).to(dtype)
    assert torch.equal(out, want)


def _keep(attrs, shape, rate):
    k0, k1 = nn_ops._key_words(_ctx().seed_for(attrs["op_seed"]))
    return nn_ops._reference_keep(shape, k0, k1, nn_ops._threshold_for(rate),
                                  "cpu").float()


@pytest.mark.parametrize("op_type", ["dropout", "fused_dropout_add",
                                     "fused_act_dropout_gelu",
                                     "fused_act_dropout_relu"])
def test_backward_regenerates_the_forward_mask(op_type):
    """d(sum(out · w))/dx through torch.func.grad and through the tape's
    generic_grad: ``w · Mask · scale`` (· act'(x)); the residual's is w."""
    rate = 0.3
    act = op_type.split("_")[-1] if "act" in op_type else None
    op = "fused_act_dropout" if act else op_type
    attrs = {"dropout_prob": rate, "op_seed": 8,
             "dropout_implementation": "upscale_in_train"}
    if act:
        attrs["act"] = act
    x, r, w = (torch.from_numpy(_f(6, 40)) for _ in range(3))
    keep = _keep(attrs, x.shape, rate)
    scale = float(np.float32(1 / (1 - rate)))
    want = w * keep * scale
    if act:
        want = want * nn_ops._act_grad(x, act)
    ins = {"X": [x], "Residual": [r]} if op == "fused_dropout_add" \
        else {"X": [x]}

    def loss(x, r):
        fwd = dict(ins, X=[x])
        if "Residual" in fwd:
            fwd["Residual"] = [r]
        return (_run(op, fwd, attrs)["Out"][0] * w).sum()

    gx, gr = torch.func.grad(loss, argnums=(0, 1))(x, r)
    torch.testing.assert_close(gx, want, rtol=1e-6, atol=1e-7)
    if op == "fused_dropout_add":
        assert torch.equal(gr, w)
    # the tape's path: generic_grad reruns the forward under vjp
    g_ins = {"I_" + s: v for s, v in ins.items()}
    g_ins["G_Out"] = [w]
    slots = list(ins)
    got = _generic_grad(g_ins, {"fwd_type": op, "fwd_attrs": attrs,
                                "in_slots": slots, "grad_slots": slots},
                        _ctx())
    torch.testing.assert_close(got["GI_X"][0], want, rtol=1e-6, atol=1e-7)


def test_port_gelu_matches_the_reference_kernels_act_fns():
    f, df = _act_fns("gelu")
    x = np.linspace(-6, 6, 4001).astype("float32")
    t = torch.from_numpy(x)
    np.testing.assert_allclose(nn_ops._act(t, "gelu").numpy(),
                               np.asarray(f(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(nn_ops._act_grad(t, "gelu").numpy(),
                               np.asarray(df(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-6)


def test_meta_tensors_take_no_kernel():
    """Shape inference hands lowerings meta tensors: the dropout ops
    answer with shapes and dtypes, and launch nothing."""
    x = torch.empty((4, 8), device="meta", dtype=torch.bfloat16)
    ctx = treg.LoweringContext(device="meta")
    before = cuda_kernels.fused_dropout.launches
    outs = _run("dropout", {"X": [x]}, {"dropout_prob": 0.1}, ctx)
    assert outs["Out"][0].shape == (4, 8)
    assert outs["Mask"][0].dtype == torch.uint8
    assert _run("fused_dropout_add", {"X": [x], "Residual": [x]},
                {"dropout_prob": 0.1}, ctx)["Out"][0].dtype == torch.bfloat16
    assert _run("fused_act_dropout", {"X": [x]}, {"dropout_prob": 0.1},
                ctx)["Out"][0].shape == (4, 8)
    assert cuda_kernels.fused_dropout.launches == before


def test_dropout_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((4, 8))
    for call in (lambda: cuda_kernels.fused_dropout(x, 1, 5, 1.0),
                 lambda: cuda_kernels.dropout_mask(x, 1, 5),
                 lambda: cuda_kernels.fused_dropout_add(x, x, 1, 5, 1.0),
                 lambda: cuda_kernels.fused_act_dropout(x, 1, 5, 1.0,
                                                        "gelu"),
                 lambda: cuda_kernels.fused_act_dropout_bwd(x, x, 1, 5, 1.0,
                                                            "gelu")):
        with pytest.raises(ValueError, match="CUDA"):
            call()


# ---------------------------------------------------------------------------
# the tape path against the functional path, dropout live
# ---------------------------------------------------------------------------
def test_tape_grads_equal_functional_grads_with_live_dropout():
    tframework.reset_unique_name()
    rng = np.random.RandomState(2)
    ids, mlm = (torch.from_numpy(rng.randint(0, 97, (2, 16)))
                for _ in range(2))
    nsp = torch.from_numpy(rng.randint(0, 2, (2,)))
    np.random.seed(4)
    with tdy.guard(tfluid.CPUPlace()):
        tracer = tframework._dygraph_tracer()
        model = BertForPretraining(
            vocab_size=97, hidden_size=64, num_layers=2, num_heads=2,
            intermediate_size=128, max_position=16, dropout=0.1,
            attn_dropout=0.1)
        model.train()

        def loss_fn(i, m, n):
            return model.loss(*model(i), m, n)

        pv, lfn = functional_loss(model, loss_fn)
        start = tracer._seed_ctr
        grads, loss = torch.func.grad_and_value(lfn)(pv, ids, mlm, nsp)
        tracer._seed_ctr = start        # the same per-op seeds again
        tape_loss = loss_fn(*(tdy.to_variable(t) for t in (ids, mlm, nsp)))
        tape_loss.backward()
        tape = [p.gradient_var for p in model.parameters()]
    assert float(tape_loss) == float(loss)
    # plus 1e-6 of the largest gradient of all: the key bias's gradient is
    # zero in exact arithmetic, rounding noise in both paths
    floor = 1e-6 * max(float(f.abs().max()) for f in grads)
    for i, (t, f) in enumerate(zip(tape, grads)):
        torch.testing.assert_close(t, f, rtol=0.0,
                                   atol=1e-6 * float(f.abs().max()) + floor,
                                   msg=f"parameter {i}")
