"""paddle_tpu_torch's decode path against paddle_tpu's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX package and
the port: the ops the decode programs add, the ``paged_attention`` op
(the reference on the CPU takes its plain ``_paged_reference``; its
Pallas body also runs here in interpret mode), the
``fuse_paged_attention`` pass, the page pool and prefix cache, and the
demo decode model end to end, the reference's ``dec_*`` parameters
carried into the port.

Tolerances: the ops equal (they copy, compare or multiply once);
``paged_attention`` within 1e-6 of the largest |out| (XLA and torch sum
in other orders); the fused paged program bit-identical to the unfused
one in the port (the op's plain version spells the chain op for op);
``decode_sequential`` across the packages with identical tokens and
logits within 1e-5 of the largest; batched and paged decode in the port
against the port's ``decode_sequential`` with identical tokens and
logits within 1e-6 of the largest (a float32 ``fc`` product need not
round a row alike at every batch size, so bit identity is not asserted).
"""
import functools
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu  # noqa: F401 — registers the reference lowerings
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.passes import PassPipeline as JPassPipeline
from paddle_tpu.fluid.passes import create_pass as j_create_pass
from paddle_tpu.ops import registry as jreg
from paddle_tpu.serving import decode as jdecode
from paddle_tpu.serving import engine as jengine

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid import trace as ttrace
from paddle_tpu_torch.fluid.passes import (PassPipeline, create_pass,
                                           passes_for_build_strategy)
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.ops.attention import _paged_reference
from paddle_tpu_torch.serving import decode as tdecode
from paddle_tpu_torch.serving import engine as tengine

SMALL = dict(vocab=19, d_model=8, max_len=16, seed=5, page_size=4)
PROMPTS = [[3, 1, 4], [2, 7], [5, 9, 2, 6, 5], [1], [8, 8, 3, 1], [4, 4]]
BUDGETS = [5, 7, 4, 6, 3, 5]
HOST = tfluid.CPUPlace()


def _fused_builder(model):
    """A paged builder that applies fuse_paged_attention (the
    BuildStrategy knob's pass list) to ``model``'s paged program."""
    def build(pool_rows):
        prog, logits_name = model.paged_program(pool_rows)
        bs = tfluid.BuildStrategy()
        bs.fuse_paged_attention = True
        PassPipeline(passes_for_build_strategy(bs)).apply(
            prog, targets=[logits_name])
        return prog, logits_name
    return build


@pytest.fixture(scope="module")
def ref_model():
    return jdecode.build_demo_decode_model(**SMALL)


@pytest.fixture(scope="module")
def model(ref_model):
    """The port's demo model with the reference's parameters."""
    m = tdecode.build_demo_decode_model(executor=tfluid.Executor(HOST),
                                        scope=tfluid.Scope(), **SMALL)
    names = [p.name for p in m.decode_program.all_parameters()]
    assert sorted(names) == ["dec_bk", "dec_bo", "dec_bq", "dec_bv",
                             "dec_emb", "dec_wk", "dec_wo", "dec_wq",
                             "dec_wv"]
    interop.scope_from_numpy(
        {n: np.asarray(ref_model.scope.find_var(n)) for n in names},
        m.scope, HOST)
    return m


@pytest.fixture(scope="module")
def fused_model(model):
    """The same weights, served as a user plugs the fused paged program
    into ``DecodeModel``."""
    return tdecode.DecodeModel(
        model.executor, model.scope, model.decode_program,
        model.logits_name, model.vocab, model.d_model, model.max_len,
        model.prefill_program, paged_builder=_fused_builder(
            tdecode.build_demo_decode_model(
                executor=model.executor, scope=tfluid.Scope(), **SMALL)),
        page_size=model.page_size)


@pytest.fixture(scope="module")
def sequential(model):
    return tdecode.decode_sequential(model, PROMPTS, max_new_tokens=BUDGETS,
                                     max_batch=4)


def _close(got, want, rel):
    """Identical tokens and logits within ``rel`` of the largest."""
    assert np.array_equal(got["tokens"], want["tokens"]), \
        (got["tokens"], want["tokens"])
    tol = rel * np.abs(want["logits"]).max()
    assert np.abs(got["logits"] - want["logits"]).max() <= tol


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

R = np.random.RandomState(11)


def _f(*shape):
    return R.randn(*shape).astype("float32")


OP_CASES = {
    "unsqueeze2_1": ("unsqueeze2", {"X": [_f(3, 8)]}, {"axes": [1]}),
    "unsqueeze2_2": ("unsqueeze2", {"X": [_f(3, 16)]}, {"axes": [2]}),
    "unsqueeze2_0_2": ("unsqueeze2", {"X": [_f(3, 5)]}, {"axes": [0, 2]}),
    "unsqueeze2_neg": ("unsqueeze2", {"X": [_f(3, 5)]}, {"axes": [-1]}),
    "gather_rows_int32": ("gather", {"X": [_f(40, 8)],
                                     "Index": [R.randint(0, 40, 48)
                                               .astype("int32")]}, {}),
    "gather_2d_index": ("gather", {"X": [_f(10, 3)],
                                   "Index": [R.randint(0, 10, (2, 5))
                                             .astype("int64")]}, {}),
    "gather_axis_1": ("gather", {"X": [_f(4, 10, 3)],
                                 "Index": [np.array([9, 0, 4], "int64")]},
                      {"axis": 1}),
    "assign": ("assign", {"X": [_f(3, 16, 8)]}, {}),
    "one_hot": ("one_hot", {"X": [np.array([[0], [5], [15], [3]],
                                           "int64")]}, {"depth": 16}),
    "one_hot_out_of_range": ("one_hot", {"X": [np.array([[2], [40]],
                                                        "int64")]},
                             {"depth": 40}),
    "one_hot_v2": ("one_hot_v2", {"X": [np.array([1, 0, 6], "int64")]},
                   {"depth": 7}),
    "fill_constant_batch_size_like": (
        "fill_constant_batch_size_like", {"Input": [_f(3, 4, 8)]},
        {"shape": [-1, 12, 8], "dtype": "float32", "value": 0.0}),
    "fill_constant_batch_size_like_dims": (
        "fill_constant_batch_size_like", {"Input": [_f(2, 5)]},
        {"shape": [7, -1], "dtype": "float32", "value": 1.5,
         "input_dim_idx": 1, "output_dim_idx": 1}),
    "elementwise_mul": ("elementwise_mul", {"X": [_f(3, 16, 8)],
                                            "Y": [_f(3, 16, 8)]}, {}),
    "elementwise_mul_bcast": ("elementwise_mul", {"X": [_f(3, 16, 8)],
                                                  "Y": [_f(3, 1, 8)]},
                              {"axis": -1}),
    "elementwise_mul_axis": ("elementwise_mul", {"X": [_f(2, 3, 4)],
                                                 "Y": [_f(3)]},
                             {"axis": 1}),
    "less_than": ("less_than", {"X": [np.arange(16, dtype="float32")
                                      [None, :]],
                                "Y": [np.array([[1.0], [16.0], [5.0]],
                                               "float32")]}, {}),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_equals_reference(case):
    op_type, ins, attrs = OP_CASES[case]
    j_out = jreg.get_op(op_type).fn(
        {s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
        dict(attrs), jreg.LoweringContext())
    t_out = treg.get_op(op_type).fn(
        {s: [torch.from_numpy(np.array(a)) for a in v]
         for s, v in ins.items()}, dict(attrs), treg.LoweringContext())
    assert set(j_out) == set(t_out)
    for slot in j_out:
        for j, t in zip(j_out[slot], t_out[slot]):
            j, t = np.asarray(j), t.numpy()
            assert j.shape == t.shape, (slot, j.shape, t.shape)
            if slot != "XShape":
                assert j.dtype == t.dtype, (slot, j.dtype, t.dtype)
                assert np.array_equal(j, t), slot


# ---------------------------------------------------------------------------
# paged_attention
# ---------------------------------------------------------------------------

def _paged_inputs(b, s, d, ps, mask, n_pages=24, seed=0):
    """q, pools and a page table whose pages are a random permutation and
    whose rows inside each page are shuffled too (``shuffled``), so no
    page is contiguous; masks every position valid, ragged prefixes,
    non-prefix, or ragged with row 0 all masked."""
    rng = np.random.RandomState(seed)
    r = n_pages * ps
    q = rng.randn(b, d).astype("float32")
    kp, vp = (rng.randn(r, d).astype("float32") for _ in range(2))
    pages = rng.permutation(n_pages - 1)[:b * s // ps] + 1
    lanes = np.stack([rng.permutation(ps) for _ in range(b * s // ps)])
    idx = (pages[:, None] * ps + lanes).reshape(b, s).astype("int32")
    if mask == "full":
        valid = np.ones((b, s), "float32")
    elif mask == "non-prefix":
        valid = (rng.rand(b, s) < 0.5).astype("float32")
        valid[:, 0] = 1.0
    else:
        lengths = rng.randint(1, s + 1, (b, 1))
        valid = (np.arange(s)[None, :] < lengths).astype("float32")
        if mask == "all-masked row":
            valid[0] = 0.0
    return q, kp, vp, idx, valid


@pytest.mark.parametrize("d", (8, 128))
@pytest.mark.parametrize("mask", ("ragged", "non-prefix", "all-masked row"))
def test_paged_attention_op_matches_reference(d, mask):
    q, kp, vp, idx, valid = _paged_inputs(4, 16, d, 4, mask)
    attrs = {"scale": d ** -0.5, "neg": 1e30, "page_size": 4}
    ins = {"Q": [q], "KPool": [kp], "VPool": [vp],
           "Index": [idx.reshape(-1)], "Valid": [valid]}
    want = np.asarray(jreg.get_op("paged_attention").fn(
        {s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
        dict(attrs), jreg.LoweringContext())["Out"][0])
    got = treg.get_op("paged_attention").fn(
        {s: [torch.from_numpy(a) for a in v] for s, v in ins.items()},
        dict(attrs), treg.LoweringContext())["Out"][0].numpy()
    assert got.shape == want.shape == (4, d)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    if mask == "all-masked row":
        # no valid position: the mean of the row's V rows
        np.testing.assert_allclose(got[0], vp[idx[0]].mean(0), rtol=1e-5,
                                   atol=1e-6)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """``jax.experimental.pallas`` with ``load`` and ``store`` (newer jax
    keeps them only in ``jax._src.pallas.primitives``; the kernel body
    calls ``pl.load``)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    for name in ("load", "store"):
        if not hasattr(pl, name):
            from jax._src.pallas import primitives
            monkeypatch.setattr(pl, name, getattr(primitives, name),
                                raising=False)
    return pl, pltpu


def test_plain_paged_attention_matches_pallas_body(pallas_interpret):
    """The port's plain version against the TPU kernel's body run in
    interpret mode at d 128 (its SMEM page table and lengths), on the
    inputs that kernel takes: page-contiguous rows, prefix masks."""
    from paddle_tpu.ops import pallas_kernels as pk
    pl, pltpu = pallas_interpret
    b, s, d, ps, n_pages = 3, 16, 128, 4, 16
    rng = np.random.RandomState(2)
    q = rng.randn(b, d).astype("float32")
    kp, vp = (rng.randn(n_pages * ps, d).astype("float32") for _ in range(2))
    pages = rng.permutation(n_pages - 1)[:b * s // ps] + 1
    idx = (pages.reshape(b, s // ps, 1) * ps
           + np.arange(ps)).reshape(b, s).astype("int32")
    lengths = np.array([[5], [16], [1]], "int32")
    smem = functools.partial(pl.BlockSpec, memory_space=pltpu.SMEM)
    want = np.asarray(pl.pallas_call(
        functools.partial(pk._paged_attn_kernel, n_blocks=s // ps,
                          page_size=ps, scale=d ** -0.5),
        grid=(b,),
        in_specs=[smem((1, s), lambda i: (i, 0)),
                  smem((1, 1), lambda i: (i, 0)),
                  pl.BlockSpec((1, d), lambda i: (i, 0)),
                  pl.BlockSpec((n_pages * ps, d), lambda i: (0, 0)),
                  pl.BlockSpec((n_pages * ps, d), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, d), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((b, d), jnp.float32),
        interpret=True)(jnp.asarray(idx), jnp.asarray(lengths),
                        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp)))
    valid = (np.arange(s)[None, :] < lengths).astype("float32")
    got = _paged_reference(*(torch.from_numpy(a) for a in (q, kp, vp, idx,
                                                           valid)),
                           d ** -0.5, 1e30).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def _paged_shares(kept, n_split):
    """The ranks, in position order, of the kept positions that each of
    a slot's n_split CTAs takes: the paged kernel's arithmetic."""
    return [(t * kept // n_split, (t + 1) * kept // n_split)
            for t in range(n_split)]


def _split_model(q, kp, vp, idx, valid, scale, neg, n_split, p=8):
    """A plain numpy model of the paged kernel's arithmetic, in float32:
    a row that has a position whose mask is not 0 keeps only those
    positions (a row with none keeps every position); the kept positions,
    in position order, are shared out over ``n_split`` splits by
    ``_paged_shares``; a split runs an online softmax over its positions
    ``p`` at a time; the splits' (m, l, acc) merge in split order, a
    split with m = -inf (nothing kept) weighing 0."""
    f32 = np.float32
    b, s = valid.shape
    out = np.empty((b, q.shape[1]), f32)
    for i in range(b):
        kept = [j for j in range(s) if valid[i, j] != 0]
        if neg < 1e20 or not kept:
            kept = list(range(s))
        parts = []
        for lo, hi in _paged_shares(len(kept), n_split):
            js = kept[lo:hi]
            m, l, acc = f32(-np.inf), f32(0), np.zeros(q.shape[1], f32)
            for k in range(0, len(js), p):
                rows, v = idx[i, js[k:k + p]], valid[i, js[k:k + p]]
                sc = (kp[rows] * q[i]).sum(1, dtype=f32) * f32(scale) * v \
                    + (v * f32(neg) + f32(-neg))
                m_new = max(m, sc.max())
                corr, pj = np.exp(m - m_new), np.exp(sc - m_new)
                l = l * corr + pj.sum(dtype=f32)
                acc = acc * corr + (pj[:, None] * vp[rows]).sum(0, dtype=f32)
                m = m_new
            parts.append((m, l, acc))
        mx = max(m for m, _, _ in parts)
        fs = [f32(0) if m == -np.inf else np.exp(m - mx) for m, _, _ in parts]
        l_all = sum((l * f for (_, l, _), f in zip(parts, fs)), f32(0))
        o = sum((acc * f for (_, _, acc), f in zip(parts, fs)),
                np.zeros(q.shape[1], f32))
        out[i] = o / l_all
    return out


PAGED_MASKS = ("full", "ragged", "non-prefix", "all-masked row")


@pytest.mark.parametrize("n_split", (1, 3, 16))
@pytest.mark.parametrize("mask", PAGED_MASKS)
def test_split_model_matches_reference_op(mask, n_split):
    """The kernel's split-and-merge with masked positions skipped, modelled
    in numpy, against the JAX ``paged_attention`` op within 1e-6 of the
    largest |out| (1, 3 and S = 16 splits; XLA sums in its own order)."""
    b, s, d, ps = 4, 16, 128, 4
    q, kp, vp, idx, valid = _paged_inputs(b, s, d, ps, mask, seed=3)
    want = np.asarray(jreg.get_op("paged_attention").fn(
        {"Q": [jnp.asarray(q)], "KPool": [jnp.asarray(kp)],
         "VPool": [jnp.asarray(vp)], "Index": [jnp.asarray(idx.reshape(-1))],
         "Valid": [jnp.asarray(valid)]},
        {"scale": d ** -0.5, "neg": 1e30, "page_size": ps},
        jreg.LoweringContext())["Out"][0])
    got = _split_model(q, kp, vp, idx, valid, d ** -0.5, 1e30, n_split)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("n_split", (1, 3, 16))
@pytest.mark.parametrize("mask", ("full", "ragged", "all-masked row"))
def test_split_model_matches_pallas_body(pallas_interpret, mask, n_split):
    """The same model against the TPU kernel's body in interpret mode at
    d 128, within 1e-6 of the largest |out|.  That kernel takes lengths,
    so its masks are prefixes: every position, ragged lengths, and a
    length of 0 for row 0 (every score -1e30, the mean of the V rows)."""
    from paddle_tpu.ops import pallas_kernels as pk
    pl, pltpu = pallas_interpret
    b, s, d, ps, n_pages = 3, 16, 128, 4, 16
    rng = np.random.RandomState(4)
    q = rng.randn(b, d).astype("float32")
    kp, vp = (rng.randn(n_pages * ps, d).astype("float32") for _ in range(2))
    pages = rng.permutation(n_pages - 1)[:b * s // ps] + 1
    idx = (pages.reshape(b, s // ps, 1) * ps
           + np.arange(ps)).reshape(b, s).astype("int32")
    lengths = {"full": [[16], [16], [16]], "ragged": [[5], [16], [1]],
               "all-masked row": [[0], [9], [3]]}[mask]
    lengths = np.array(lengths, "int32")
    smem = functools.partial(pl.BlockSpec, memory_space=pltpu.SMEM)
    want = np.asarray(pl.pallas_call(
        functools.partial(pk._paged_attn_kernel, n_blocks=s // ps,
                          page_size=ps, scale=d ** -0.5),
        grid=(b,),
        in_specs=[smem((1, s), lambda i: (i, 0)),
                  smem((1, 1), lambda i: (i, 0)),
                  pl.BlockSpec((1, d), lambda i: (i, 0)),
                  pl.BlockSpec((n_pages * ps, d), lambda i: (0, 0)),
                  pl.BlockSpec((n_pages * ps, d), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, d), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((b, d), jnp.float32),
        interpret=True)(jnp.asarray(idx), jnp.asarray(lengths),
                        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp)))
    valid = (np.arange(s)[None, :] < lengths).astype("float32")
    got = _split_model(q, kp, vp, idx, valid, d ** -0.5, 1e30, n_split)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("n_sm", (1, 8, 132))
def test_paged_splits_cover_the_positions(n_sm):
    """``paged_splits`` and the kernel's shares: they cover the kept
    positions exactly, in order, none empty while there are as many kept
    positions as splits, none longer than another by more than one; an
    all-valid row gives every split a whole 16-position chunk at least;
    the grid stays within 2·SMs (or B CTAs) and reaches it where S has
    the chunks for it."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    for b in (1, 2, 5, 8, 32, 33, 100, 1000):
        for s in (1, 15, 16, 17, 64, 300, 512, 4096, 100_000):
            n = ck.paged_splits(b, s, n_sm)
            assert 1 <= n <= ck.PAGED_MAX_SPLITS, (b, s, n)
            assert b * n <= max(b, 2 * n_sm), (b, s, n)
            if n < min(s // ck.PAGED_CHUNK, ck.PAGED_MAX_SPLITS):
                assert b * (n + 1) > 2 * n_sm, (b, s, n)
            for kept in {s, s // 3, 1}:
                shares = _paged_shares(kept, n)
                assert shares[0][0] == 0 and shares[-1][1] == kept
                assert all(a[1] == c[0] for a, c in zip(shares, shares[1:]))
                sizes = [hi - lo for lo, hi in shares]
                assert max(sizes) - min(sizes) <= 1
                if kept >= n:
                    assert min(sizes) >= 1
            if s >= ck.PAGED_CHUNK:
                assert min(hi - lo for lo, hi in _paged_shares(s, n)) \
                    >= ck.PAGED_CHUNK
    if n_sm == 132:   # the decode path's slots at 512 positions, on an H100
        assert [ck.paged_splits(b, 512, 132) for b in (1, 8, 32)] == \
            [32, 32, 8]


def test_paged_attention_on_meta_and_cpu_takes_the_plain_version():
    """Shape inference (``meta``) and the host never reach the kernel."""
    from paddle_tpu_torch.ops import attention, cuda_kernels
    before = cuda_kernels.paged_attention.launches
    q = torch.empty((3, 8), device="meta")
    pool = torch.empty((40, 8), device="meta")
    out = attention.paged_attention(
        q, pool, pool, torch.empty((48,), dtype=torch.int32, device="meta"),
        torch.empty((3, 16), device="meta"), 0.5)
    assert out.shape == (3, 8) and out.device.type == "meta"
    assert cuda_kernels.paged_attention.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.paged_attention(*(torch.from_numpy(a) for a in
                                       _paged_inputs(2, 16, 8, 4,
                                                     "ragged")),
                                     0.5, 1e30)


# ---------------------------------------------------------------------------
# fuse_paged_attention
# ---------------------------------------------------------------------------

def _op_stream(prog):
    return [(op.type, dict(op.inputs), dict(op.outputs),
             {k: v for k, v in op.attrs.items() if k != "op_role"})
            for op in prog.global_block().ops]


def test_pass_yields_the_reference_op_stream(ref_model):
    """The port's pass rewrites the port's paged program into one
    ``paged_attention`` op with page_size 4 and neg 1e30, and the op
    stream equals the reference's after its pass: types, slots, var
    names and attrs."""
    with junique.guard():           # both packages name vars from 0
        jm = jdecode.build_demo_decode_model(**SMALL)
        jprog, jname = jm.paged_program(40)
    with tunique.guard():
        tm = tdecode.build_demo_decode_model(executor=tfluid.Executor(HOST),
                                             scope=tfluid.Scope(), **SMALL)
        tprog, tname = tm.paged_program(40)
    assert jname == tname
    counter = ttrace.metrics().counter(
        "kernel_tier.fuse_paged_attention.rewrites")
    r0 = counter.value
    PassPipeline([create_pass("fuse_paged_attention")]).apply(
        tprog, targets=[tname])
    JPassPipeline([j_create_pass("fuse_paged_attention")]).apply(
        jprog, targets=[jname])
    assert counter.value - r0 == 1
    types = [op.type for op in tprog.global_block().ops]
    assert types.count("paged_attention") == 1
    assert "softmax" not in types and "gather" not in types
    pa = next(op for op in tprog.global_block().ops
              if op.type == "paged_attention")
    assert pa.attrs["page_size"] == 4
    assert pa.attrs["neg"] == pytest.approx(1e30)
    assert _op_stream(tprog) == _op_stream(jprog)


def _paged_run(prog, logits_name, model, pools, pt, feed):
    scope = tfluid.Scope(parent=model.scope)
    scope.set_var("k_pool", pools[0].clone())
    scope.set_var("v_pool", pools[1].clone())
    scope.set_var("pt", pt)
    logits, = model.executor.run(prog, feed=feed, fetch_list=[logits_name],
                                 scope=scope)
    return logits, scope.find_var("k_pool"), scope.find_var("v_pool")


def test_fused_paged_program_bit_identical_to_unfused(model):
    """The kernel-tier rewrite contract: on the host the fused program's
    logits and pool writes equal the unfused chain's bit for bit."""
    prog, logits_name = model._paged_builder(40)
    unfused = prog.clone()
    PassPipeline([create_pass("fuse_paged_attention")]).apply(
        prog, targets=[logits_name])
    assert [op.type for op in prog.global_block().ops].count(
        "paged_attention") == 1
    rng = np.random.RandomState(4)
    pools = [torch.from_numpy(rng.randn(40, 8).astype("float32"))
             for _ in range(2)]
    pages = rng.permutation(9)[:8] + 1
    pt = torch.from_numpy((pages.reshape(2, 4, 1) * 4 + np.arange(4))
                          .reshape(2, 16).astype("int32"))
    feed = {"tok": np.array([[3], [11]], "int64"),
            "widx": np.array([[int(pt[0, 6])], [int(pt[1, 13])]], "int64"),
            "pos": np.array([[6.0], [13.0]], "float32"),
            "arange": np.arange(16, dtype="float32")[None, :]}
    a = _paged_run(unfused, logits_name, model, pools, pt, feed)
    b = _paged_run(prog, logits_name, model, pools, pt, feed)
    assert np.array_equal(a[0], b[0])
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


def test_pass_declines_a_mask_that_is_not_exact_zero():
    """``valid·N + b`` with b != -N is not the decode mask: no rewrite."""
    L = tfluid.layers
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        q = tfluid.data("q", [-1, 8])
        kp = tfluid.data("kp", [40, 8])
        vp = tfluid.data("vp", [40, 8])
        pt = tfluid.data("pt", [-1, 16], dtype="int32")
        valid = tfluid.data("valid", [-1, 16])
        pti = L.reshape(pt, [-1])
        kg = L.reshape(L.gather(kp, pti), [-1, 16, 8])
        vg = L.reshape(L.gather(vp, pti), [-1, 16, 8])
        sc = L.scale(L.reduce_sum(kg * L.unsqueeze(q, [1]), dim=[2]),
                     scale=0.25)
        sc = sc * valid + L.scale(valid, scale=1e30, bias=0.0)
        out = L.reduce_sum(vg * L.unsqueeze(L.softmax(sc), [2]), dim=[1])
    PassPipeline([create_pass("fuse_paged_attention")]).apply(
        main, targets=[out.name])
    types = [op.type for op in main.global_block().ops]
    assert "paged_attention" not in types and "softmax" in types


@pytest.mark.parametrize("knobs,want", [
    ({"kernel_tier": True}, ["fuse_attention", "fuse_paged_attention",
                             "fuse_sparse_embedding", "fuse_optimizer"]),
    ({"fuse_paged_attention": True}, ["fuse_paged_attention"]),
    ({"fuse_optimizer": True, "fuse_paged_attention": True},
     ["fuse_paged_attention", "fuse_optimizer"]),
    ({}, []),
], ids=["kernel_tier", "paged", "paged+optimizer", "none"])
def test_build_strategy_selects_the_tier_in_reference_order(knobs, want):
    bs = tfluid.BuildStrategy()
    for k, v in knobs.items():
        setattr(bs, k, v)
    assert [p.name for p in passes_for_build_strategy(bs)] == want


# ---------------------------------------------------------------------------
# the page pool and the prefix cache, both packages
# ---------------------------------------------------------------------------

PACKAGES = {"reference": (jdecode, jengine), "port": (tdecode, tengine)}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def test_pool_exhaustion_is_typed(pkg):
    dec, eng = pkg
    pool = dec.KVPagePool(4, 4)          # page 0 is scratch: 3 usable
    assert pool.usable_pages == 3
    assert len(pool.alloc(3)) == 3 and pool.free_pages == 0
    with pytest.raises(dec.PagePoolExhaustedError):
        pool.alloc(1)
    assert issubclass(dec.PagePoolExhaustedError, eng.QueueFullError)


def test_pool_release_guards_double_free(pkg):
    dec, _ = pkg
    pool = dec.KVPagePool(4, 4)
    a, b = pool.alloc(2)
    pool.release(a)
    assert pool.free_pages == 2 and pool.pages_in_use == 1
    with pytest.raises(ValueError):
        pool.release(a)
    pool.release(b)
    assert pool.free_pages == pool.usable_pages == 3


def test_pool_shared_page_survives_first_release(pkg):
    dec, _ = pkg
    pool = dec.KVPagePool(4, 4)
    (pg,) = pool.alloc(1)
    pool.incref(pg)
    pool.release(pg)
    assert pool.pages_in_use == 1
    pool.release(pg)
    assert pool.pages_in_use == 0


def test_pool_reuses_freed_pages_after_churn(pkg):
    dec, _ = pkg
    pool = dec.KVPagePool(9, 4)
    held = pool.alloc(8)
    for pg in held[::2]:
        pool.release(pg)
    assert sorted(pool.alloc(4)) == sorted(held[::2])
    with pytest.raises(dec.PagePoolExhaustedError):
        pool.alloc(1)


def test_prefix_eviction_never_frees_live_reader_pages(pkg):
    dec, _ = pkg
    pool = dec.KVPagePool(6, 4)
    cache = dec.PrefixCache(pool)
    pages = pool.alloc(2)
    cache.register(np.asarray([3, 1, 4, 1, 5, 9, 2, 6]), pages)
    for pg in pages:
        pool.release(pg)                 # donor retires
    pool.incref(pages[0])                # a live reader on page 0
    assert cache.evict(10) == 1
    assert pool.refcount(pages[0]) == 2
    pool.release(pages[0])
    assert pool.pages_in_use == 1
    assert cache.evict(10) == 1
    assert pool.pages_in_use == 0


def test_prefix_lru_order_and_lookup_touch(pkg):
    dec, _ = pkg
    pool = dec.KVPagePool(8, 2)
    cache = dec.PrefixCache(pool)
    a, b = np.asarray([1, 2, 7]), np.asarray([5, 6, 7])
    pa, pb = pool.alloc(1), pool.alloc(1)
    cache.register(a, pa)
    cache.register(b, pb)
    pool.release(pa[0])
    pool.release(pb[0])
    cache.lookup(a)                      # b is now the oldest
    assert cache.evict(1) == 1
    assert cache.lookup(a) and not cache.lookup(b)


# ---------------------------------------------------------------------------
# the model end to end
# ---------------------------------------------------------------------------

def test_decode_sequential_matches_reference(ref_model, model, sequential):
    want = jdecode.decode_sequential(ref_model, PROMPTS,
                                     max_new_tokens=BUDGETS, max_batch=4)
    for got, w in zip(sequential, want):
        _close(got, {"tokens": np.asarray(w["tokens"]),
                     "logits": np.asarray(w["logits"])}, 1e-5)


def _staggered(engine, prompts=PROMPTS, budgets=BUDGETS):
    """Half the requests at once, the rest after a pause: joins land
    mid-flight."""
    with engine:
        futs = [engine.submit(p, max_new_tokens=b)
                for p, b in zip(prompts[:3], budgets[:3])]
        time.sleep(0.1)
        futs += [engine.submit(p, max_new_tokens=b)
                 for p, b in zip(prompts[3:], budgets[3:])]
        out = [f.result(timeout=120) for f in futs]
        return out, engine.stats()


def test_dense_join_leave_matches_sequential(model, sequential):
    out, st = _staggered(tdecode.DecodeEngine(model, max_batch=4,
                                              collect_logits=True,
                                              name="t_dense"))
    for got, want in zip(out, sequential):
        _close(got, want, 1e-6)
    assert st["leaves"] == len(PROMPTS) and st["active_slots"] == 0


@pytest.mark.parametrize("cache", (False, True), ids=("no_cache", "cache"))
@pytest.mark.parametrize("fused", (False, True), ids=("unfused", "fused"))
def test_paged_join_leave_matches_sequential(model, fused_model, sequential,
                                             fused, cache):
    eng = tdecode.DecodeEngine(fused_model if fused else model, max_batch=4,
                               collect_logits=True, paged=True,
                               prefix_cache=cache,
                               name=f"t_paged_{fused}_{cache}")
    out, st = _staggered(eng)
    for got, want in zip(out, sequential):
        _close(got, want, 1e-6)
    if not cache:
        assert st["paged"]["kv_pages_in_use"] == 0


def test_prefix_hit_first_emission_matches_a_miss(fused_model, model):
    """A prefix-cache hit replays its prompt tail through decode steps;
    its first emission matches a miss's, which comes from prefill."""
    shared = [7, 7, 2, 9]                # one full page
    prompts = [shared + [3], shared + [5, 1], shared + [8, 8, 1]]
    want = tdecode.decode_sequential(model, prompts, max_new_tokens=4,
                                     max_batch=2)
    eng = tdecode.DecodeEngine(fused_model, max_batch=2, collect_logits=True,
                               paged=True, prefix_cache=True,
                               name="t_prefix_hit")
    with eng:
        out = [eng.generate(p, max_new_tokens=4, timeout=120)
               for p in prompts]
        st = eng.stats()
    assert st["paged"]["prefix_hits"] >= 2
    for got, w in zip(out, want):
        _close(got, w, 1e-6)
        assert got["tokens"][0] == w["tokens"][0]


# ---------------------------------------------------------------------------
# entry points and errors
# ---------------------------------------------------------------------------

def test_serving_exports_the_reference_decode_names():
    import paddle_tpu.serving as jserving
    import paddle_tpu_torch.serving as tserving
    names = [n for n in jdecode.__all__ if n in jserving.__all__]
    assert names and all(n in tserving.__all__ and getattr(tserving, n)
                         is getattr(tdecode, n) for n in names)


def test_demo_model_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"CPUPlace\(\)"):
        tdecode.build_demo_decode_model(**SMALL)


def test_request_that_can_never_fit_is_rejected_typed(model):
    eng = tdecode.DecodeEngine(model, max_batch=2, paged=True, pool_pages=3,
                               name="t_too_long")
    with eng:
        with pytest.raises(tdecode.PagePoolExhaustedError):
            eng.submit([5, 9, 2, 6, 5], max_new_tokens=8)
        assert eng.stats()["rejected"] == 1


def test_close_drains_queued_and_live_requests(fused_model):
    eng = tdecode.DecodeEngine(fused_model, max_batch=2, paged=True,
                               name="t_drain")
    futs = [eng.submit(p, max_new_tokens=b) for p, b in zip(PROMPTS,
                                                            BUDGETS)]
    eng.close()
    assert all(f.done() for f in futs)
    assert [len(f.result(0)["tokens"]) for f in futs] == BUDGETS
    with pytest.raises(tengine.EngineClosedError):
        eng.submit([1], max_new_tokens=1)


def test_speculative_decoding_is_refused(model):
    """Speculative decoding is served (tests/test_torch_speculative.py);
    what stays refused, as in the reference: a draft without the paged
    pool, and a draft whose window or vocabulary differs."""
    with pytest.raises(ValueError, match="draft_model"):
        tdecode.DecodeEngine(model, draft_model=model)
    other = tdecode.build_demo_decode_model(
        executor=tfluid.Executor(HOST), scope=tfluid.Scope(),
        **dict(SMALL, vocab=23))
    with pytest.raises(ValueError, match="share max_len and vocab"):
        tdecode.DecodeEngine(model, paged=True, draft_model=other)


def test_warmup_restores_the_carried_pools(fused_model):
    eng = tdecode.DecodeEngine(fused_model, max_batch=4, paged=True,
                               name="t_warm")
    pools = [eng._scope.find_var(n) for n in ("k_pool", "v_pool")]
    report = eng.warmup()
    assert report["decode_buckets"] == [1, 2, 4]
    assert [eng._scope.find_var(n) for n in ("k_pool", "v_pool")] == pools
    eng.close()


def test_carried_state_fed_before_the_scope_holds_it_is_written_back(model):
    """The ``carry_vars`` repair: a plan built while the scope does not
    hold the carried caches (they come in the feed) still keeps their
    writes and hands them to the scope."""
    scope = tfluid.Scope(parent=model.scope)
    cache = np.zeros((1, 16, 8), "float32")
    feed = {"tok": np.array([[3]], "int64"), "posi": np.array([[0]], "int64"),
            "pos": np.array([[0.0]], "float32"),
            "arange": np.arange(16, dtype="float32")[None, :],
            "k_cache": cache, "v_cache": cache}
    model.executor.run(model.decode_program, feed=feed,
                       fetch_list=[model.logits_name], scope=scope)
    k = scope.find_var("k_cache")
    assert k is not None and tuple(k.shape) == (1, 16, 8)
    assert bool((k[0, 0] != 0).any()) and not bool(k[0, 1:].any())


def test_carried_state_must_be_fed_or_seeded(model):
    prog, logits_name = model._paged_builder(40)
    feed = {"tok": np.zeros((1, 1), "int64"),
            "widx": np.zeros((1, 1), "int64"),
            "pos": np.zeros((1, 1), "float32"),
            "arange": np.arange(16, dtype="float32")[None, :]}
    with pytest.raises(ValueError, match="carry_vars.*seed"):
        model.executor.run(prog, feed=feed, fetch_list=[logits_name],
                           scope=tfluid.Scope())
