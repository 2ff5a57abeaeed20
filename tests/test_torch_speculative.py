"""Speculative paged decode in paddle_tpu_torch against paddle_tpu, on the
CPU.

The demo decode model at vocab 19, d_model 8, 16 positions, pages of 4,
the reference's ``dec_*`` weights carried into the port through
``interop.scope_from_numpy`` (the draft's too).  Twins of the reference's
``TestSpeculative`` (``tests/test_decode_paged.py``): greedy speculative
decode emits the tokens of the port's own ``decode_sequential``, and a
self-draft accepts every proposal.  Across the packages the speculative
engines on the same weights emit the same tokens, logits within 1e-4 of
the largest.  The verify program's op stream equals the reference's, and
``fuse_paged_attention`` rewrites each of its ``spec_k`` blocks in both
packages.  Also ``PrefixCache.drop``, ``release_prefix`` and the
``spec_*`` keys of ``stats()`` and of the metrics export's ``decode``
block.

Tolerances: within the port, logits of the speculative engine within
1e-6 of the largest against ``decode_sequential`` (as the paged engine's:
a float32 ``fc`` product need not round a row alike at every batch
size); verify blocks against the plain paged step at the same batch bit
for bit.
"""
import time

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401 — registers the reference lowerings
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.passes import PassPipeline as JPassPipeline
from paddle_tpu.fluid.passes import create_pass as j_create_pass
from paddle_tpu.serving import decode as jdecode

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.fluid import metrics_export as tmetrics_export
from paddle_tpu_torch.fluid import trace as ttrace
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.passes import (PassPipeline, create_pass,
                                           passes_for_build_strategy)
from paddle_tpu_torch.serving import decode as tdecode

SMALL = dict(vocab=19, d_model=8, max_len=16, seed=5, page_size=4)
DRAFT = dict(SMALL, d_model=4, seed=11)
PROMPTS = [[3, 1, 4], [2, 7], [5, 9, 2, 6, 5], [1], [8, 8, 3, 1], [4, 4]]
BUDGETS = [5, 7, 4, 6, 3, 5]
HOST = tfluid.CPUPlace()


def _port_twin(ref):
    """The port's demo model with ``ref``'s parameters."""
    cfg = dict(vocab=ref.vocab, d_model=ref.d_model, max_len=ref.max_len,
               page_size=ref.page_size)
    m = tdecode.build_demo_decode_model(executor=tfluid.Executor(HOST),
                                        scope=tfluid.Scope(), **cfg)
    names = [p.name for p in m.decode_program.all_parameters()]
    interop.scope_from_numpy(
        {n: np.asarray(ref.scope.find_var(n)) for n in names}, m.scope, HOST)
    return m


def _fused(model):
    """``model`` with ``fuse_paged_attention`` applied to its paged and
    verify programs, as chip_smoke.py's decode model."""
    bs = tfluid.BuildStrategy()
    bs.fuse_paged_attention = True

    def fuse(entry):
        prog, names = entry
        targets = names if isinstance(names, list) else [names]
        PassPipeline(passes_for_build_strategy(bs)).apply(prog,
                                                          targets=targets)
        return entry

    return tdecode.DecodeModel(
        model.executor, model.scope, model.decode_program,
        model.logits_name, model.vocab, model.d_model, model.max_len,
        model.prefill_program,
        paged_builder=lambda r: fuse(model._paged_builder(r)),
        verify_builder=lambda r, k: fuse(model._verify_builder(r, k)),
        page_size=model.page_size)


@pytest.fixture(scope="module")
def ref_model():
    return jdecode.build_demo_decode_model(**SMALL)


@pytest.fixture(scope="module")
def ref_draft():
    return jdecode.build_demo_decode_model(**DRAFT)


@pytest.fixture(scope="module")
def model(ref_model):
    return _port_twin(ref_model)


@pytest.fixture(scope="module")
def draft(ref_draft):
    return _port_twin(ref_draft)


@pytest.fixture(scope="module")
def sequential(model):
    return tdecode.decode_sequential(model, PROMPTS, max_new_tokens=BUDGETS,
                                     max_batch=4)


def _close(got, want, rel):
    assert np.array_equal(got["tokens"], want["tokens"]), \
        (got["tokens"], want["tokens"])
    tol = rel * np.abs(want["logits"]).max()
    assert np.abs(got["logits"] - want["logits"]).max() <= tol


def _staggered(engine, prompts=PROMPTS, budgets=BUDGETS, pause=0.1):
    with engine:
        futs = [engine.submit(p, max_new_tokens=b)
                for p, b in zip(prompts[:3], budgets[:3])]
        time.sleep(pause)
        futs += [engine.submit(p, max_new_tokens=b)
                 for p, b in zip(prompts[3:], budgets[3:])]
        out = [f.result(timeout=120) for f in futs]
        return out, engine.stats()


# ---------------------------------------------------------------------------
# twins of the reference's TestSpeculative
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", (False, True), ids=("unfused", "fused"))
def test_greedy_spec_token_identical(model, draft, sequential, fused):
    """The speculative gate: with join/leave churn, the tokens equal the
    port's decode_sequential, whether or not the verify program's
    attention is fused."""
    eng = tdecode.DecodeEngine(_fused(model) if fused else model,
                               name=f"t_spec_gate_{fused}", max_batch=4,
                               paged=True, draft_model=draft, spec_k=4,
                               collect_logits=True)
    out, st = _staggered(eng)
    for got, want in zip(out, sequential):
        _close(got, want, 1e-6)
    sp = st["paged"]
    assert sp["spec_k"] == 4 and sp["spec_proposed"] > 0
    assert 0 <= sp["spec_accepted"] <= sp["spec_proposed"]
    assert sp["spec_accept_rate"] == pytest.approx(
        sp["spec_accepted"] / sp["spec_proposed"], abs=1e-4)
    assert st["leaves"] == len(PROMPTS) and sp["kv_pages_in_use"] == 0


@pytest.mark.parametrize("spec_k", (3, 4, 5))
def test_self_draft_accepts_everything(model, sequential, spec_k):
    """Drafting with the target itself proposes the target's own argmax:
    every proposal is accepted, and the tokens stay those of plain
    decode."""
    eng = tdecode.DecodeEngine(model, name=f"t_spec_self_{spec_k}",
                               max_batch=4, paged=True, draft_model=model,
                               spec_k=spec_k, collect_logits=True)
    with eng:
        out = [f.result(timeout=120) for f in
               [eng.submit(p, max_new_tokens=b)
                for p, b in zip(PROMPTS, BUDGETS)]]
        st = eng.stats()
    for got, want in zip(out, sequential):
        _close(got, want, 1e-6)
    sp = st["paged"]
    assert sp["spec_proposed"] > 0
    assert sp["spec_accepted"] == sp["spec_proposed"]
    assert sp["spec_accept_rate"] == 1.0
    # fewer target launches than tokens: each round advances up to
    # spec_k - 1 positions a slot
    assert st["steps"] < sum(BUDGETS)


def test_prefix_hits_under_speculation_stay_exact(model, draft):
    """A prefix-cache hit replays its prompt tail through verify rounds
    (forced tokens, no proposal) and still emits plain decode's tokens."""
    shared = [7, 7, 2, 9]
    prompts = [shared + [3], shared + [5, 1], shared + [8, 8, 1]]
    want = tdecode.decode_sequential(model, prompts, max_new_tokens=5,
                                     max_batch=2)
    eng = tdecode.DecodeEngine(model, name="t_spec_prefix", max_batch=2,
                               paged=True, prefix_cache=True,
                               draft_model=draft, spec_k=3,
                               collect_logits=True)
    with eng:
        out = [eng.generate(p, max_new_tokens=5, timeout=120)
               for p in prompts]
        st = eng.stats()
    assert st["paged"]["prefix_hits"] >= 2
    for got, w in zip(out, want):
        _close(got, w, 1e-6)


# ---------------------------------------------------------------------------
# the port against the reference on the same weights
# ---------------------------------------------------------------------------

def test_spec_engines_agree_across_packages(ref_model, ref_draft, model,
                                            draft):
    jeng = jdecode.DecodeEngine(ref_model, name="j_spec_x", max_batch=4,
                                paged=True, draft_model=ref_draft,
                                spec_k=4, collect_logits=True)
    teng = tdecode.DecodeEngine(model, name="t_spec_x", max_batch=4,
                                paged=True, draft_model=draft, spec_k=4,
                                collect_logits=True)
    with jeng:
        want = [f.result(timeout=180) for f in
                [jeng.submit(p, max_new_tokens=b)
                 for p, b in zip(PROMPTS, BUDGETS)]]
    with teng:
        got = [f.result(timeout=120) for f in
               [teng.submit(p, max_new_tokens=b)
                for p, b in zip(PROMPTS, BUDGETS)]]
    for g, w in zip(got, want):
        _close(g, {"tokens": np.asarray(w["tokens"]),
                   "logits": np.asarray(w["logits"])}, 1e-4)


def _op_stream(prog):
    return [(op.type, dict(op.inputs), dict(op.outputs),
             {k: v for k, v in op.attrs.items() if k != "op_role"})
            for op in prog.global_block().ops]


@pytest.mark.parametrize("k", (2, 4))
def test_verify_program_is_the_reference_program(k):
    """The verify program's op stream (types, slots, var names, attrs)
    equals the reference's before and after ``fuse_paged_attention``,
    which rewrites each of the ``k`` blocks in both packages: ``k``
    ``paged_attention`` ops and no ``softmax`` left."""
    with junique.guard():
        jm = jdecode.build_demo_decode_model(**SMALL)
        jprog, jnames = jm.verify_program(40, k)
    with tunique.guard():
        tm = tdecode.build_demo_decode_model(executor=tfluid.Executor(HOST),
                                             scope=tfluid.Scope(), **SMALL)
        tprog, tnames = tm.verify_program(40, k)
    assert tnames == jnames and len(tnames) == k
    assert _op_stream(tprog) == _op_stream(jprog)
    assert tprog._hints["carry_vars"] == ("k_pool", "v_pool")
    counter = ttrace.metrics().counter(
        "kernel_tier.fuse_paged_attention.rewrites")
    r0 = counter.value
    PassPipeline([create_pass("fuse_paged_attention")]).apply(
        tprog, targets=tnames)
    JPassPipeline([j_create_pass("fuse_paged_attention")]).apply(
        jprog, targets=jnames)
    assert counter.value - r0 == k
    types = [op.type for op in tprog.global_block().ops]
    assert types.count("paged_attention") == k and "softmax" not in types
    assert _op_stream(tprog) == _op_stream(jprog)


def test_verify_blocks_are_the_plain_paged_step_bit_for_bit(model):
    """Block j of one verify run equals, bit for bit, the plain fused
    paged step at position pos + j over the pool the plain steps wrote
    (the same batch, so the same products)."""
    fm = _fused(model)
    rows, k, b = 40, 3, 2
    vprog, vnames = fm.verify_program(rows, k)
    pprog, pname = fm.paged_program(rows)
    rng = np.random.RandomState(7)
    pools = [torch.from_numpy(rng.randn(rows, 8).astype("float32"))
             for _ in range(2)]
    pages = rng.permutation(9)[:8] + 1
    pt = torch.from_numpy((pages.reshape(b, 4, 1) * 4 + np.arange(4))
                          .reshape(b, 16).astype("int32"))
    pos = np.array([[5.0], [9.0]], "float32")
    toks = rng.randint(0, 19, (b, k)).astype("int64")
    widx = np.stack([pt[i, int(pos[i, 0]):int(pos[i, 0]) + k].numpy()
                     for i in range(b)]).astype("int64")
    ar = np.arange(16, dtype="float32")[None, :]

    def scope():
        sc = tfluid.Scope(parent=model.scope)
        sc.set_var("k_pool", pools[0].clone())
        sc.set_var("v_pool", pools[1].clone())
        sc.set_var("pt", pt)
        return sc

    vs = scope()
    got = model.executor.run(vprog, feed={"toks": toks, "widx": widx,
                                          "pos": pos, "arange": ar},
                             fetch_list=vnames, scope=vs)
    ps = scope()
    for j in range(k):
        want, = model.executor.run(
            pprog, feed={"tok": toks[:, j:j + 1], "widx": widx[:, j:j + 1],
                         "pos": pos + j, "arange": ar},
            fetch_list=[pname], scope=ps)
        assert np.array_equal(got[j], want), j
    for n in ("k_pool", "v_pool"):
        assert torch.equal(vs.find_var(n), ps.find_var(n))


# ---------------------------------------------------------------------------
# PrefixCache.drop, release_prefix, the spec_* keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ("reference", "port"))
def test_prefix_drop_frees_cache_only_pages(pkg):
    mod = jdecode if pkg == "reference" else tdecode
    pool = mod.KVPagePool(8, 2)
    cache = mod.PrefixCache(pool)
    a = [1, 2, 3, 4, 5]
    pa = pool.alloc(3)
    cache.register(a, pa)            # two fully covered pages adopted
    assert len(cache) == 2
    # the slot still holds its pages: the drop frees none of them now
    assert cache.drop(a) == 0 and len(cache) == 0
    assert pool.refcount(pa[0]) == 1
    for pid in pa:
        pool.release(pid)
    pb = pool.alloc(2)
    cache.register([7, 7, 7, 7], pb)
    for pid in pb:
        pool.release(pid)            # the cache is the only holder now
    free0 = pool.free_pages
    assert cache.drop([7, 7, 7, 7, 9]) == 2
    assert pool.free_pages == free0 + 2 and not cache.lookup([7, 7, 7, 7])
    assert cache.drop([5, 5]) == 0


def test_release_prefix_through_the_loop(model):
    prompt = [7, 7, 2, 9, 1]
    eng = tdecode.DecodeEngine(model, name="t_release", max_batch=2,
                               paged=True, prefix_cache=True)
    assert eng.release_prefix(prompt) == 0           # nothing cached yet
    with eng:
        eng.generate(prompt, max_new_tokens=2, timeout=120)
        in_use = eng.stats()["paged"]["kv_pages_in_use"]
        assert in_use == 1                           # the adopted page
        assert eng.release_prefix(prompt) == 1
        st = eng.stats()
    assert st["paged"]["kv_pages_in_use"] == 0
    assert st["paged"]["prefix_drops"] == 1
    plain = tdecode.DecodeEngine(model, name="t_release_none", max_batch=2,
                                 paged=True)
    assert plain.release_prefix(prompt) == 0
    plain.close()


def test_spec_keys_in_stats_and_the_export(model, draft):
    """The keys the reference's tools/serve_bench.py reads from a
    speculative engine, in ``stats()["paged"]``, the metrics export's
    ``decode`` block and the futures' ``trace_id``."""
    eng = tdecode.DecodeEngine(model, name="t_spec_keys", max_batch=2,
                               paged=True, draft_model=draft, spec_k=3)
    with eng:
        fut = eng.submit([2, 7], max_new_tokens=4)
        fut.result(timeout=120)
        st = eng.stats()
    assert fut.trace_id and fut.trace_id.startswith("dec-")
    for key in ("spec_k", "spec_proposed", "spec_accepted",
                "spec_accept_rate", "prefix_drops"):
        assert key in st["paged"], key
    dec = tmetrics_export.stats_payload()["decode"]
    for key in ("kv_pages_in_use", "kv_page_pool_free", "prefix_hits",
                "prefix_evictions", "prefix_drops", "spec_proposed",
                "spec_accepted"):
        assert key in dec, key
    assert ttrace.metrics().counter(
        "decode.t_spec_keys.spec_proposed").value == \
        st["paged"]["spec_proposed"]


def test_spec_warmup_builds_and_restores(model, draft):
    eng = tdecode.DecodeEngine(model, name="t_spec_warm", max_batch=4,
                               paged=True, draft_model=draft, spec_k=3)
    pools = [eng._scope.find_var(n) for n in ("k_pool", "v_pool")]
    report = eng.warmup()
    assert report["decode_buckets"] == [1, 2, 4]
    assert (eng._pool_rows, 3) in model._verify
    assert [eng._scope.find_var(n) for n in ("k_pool", "v_pool")] == pools
    with eng:
        out = eng.generate([3, 1, 4], max_new_tokens=3, timeout=120)
    assert len(out["tokens"]) == 3
