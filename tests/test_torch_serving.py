"""The serving slice as a whole: paddle_tpu_torch against paddle_tpu.

Both packages build the small static BERT program (dropout 0.1, padding
mask on).  The JAX side runs its startup program, freezes, fuses
attention and answers each request with ``Executor.run``.  The port
builds the same program, takes the JAX parameter values through
``interop.scope_from_numpy`` and answers the same requests through its
``ServingEngine`` on ``CPUPlace()``, where the fused attention op takes
its plain version.  Answers agree within rtol=1e-4, atol=1e-5: the two
libraries sum float32 products in different orders over two layers.
"""
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.models.static_graphs import \
    build_bert_train_program as j_build
from paddle_tpu.serving import freeze_program as j_freeze

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.models.static_graphs import \
    build_bert_train_program as t_build
from paddle_tpu_torch.serving import (EngineClosedError, QueueFullError,
                                      ServingEngine, freeze_program)

SMALL = dict(vocab=64, hidden=32, heads=4, seq=16, layers=2, dropout=0.1)
ROWS = (1, 2, 3, 5, 8, 13)
FEEDS = ["ids", "attn_mask"]


@pytest.fixture(autouse=True)
def _fresh_port_names():
    tframework.reset_unique_name()
    yield


def _requests(seed=0, rows=ROWS, seq=SMALL["seq"], vocab=SMALL["vocab"]):
    """One feed per request: random ids and a padded mask (each row
    attends to a random prefix of at least one token)."""
    rng = np.random.RandomState(seed)
    out = []
    for n in rows:
        ids = rng.randint(0, vocab, (n, seq)).astype("int64")
        lengths = rng.randint(1, seq + 1, n)
        mask = (np.arange(seq)[None, :] < lengths[:, None]).astype("float32")
        out.append({"ids": ids, "attn_mask": mask})
    return out


def _fused_strategy(fluid):
    bs = fluid.BuildStrategy()
    bs.fuse_attention = True
    return bs


def _port_program():
    """The port's frozen program and CompiledProgram, its logits name,
    and its parameter names in creation order."""
    main, _, logits = t_build(train=False, **SMALL)
    frozen = freeze_program(main, FEEDS, [logits], scope=tfluid.Scope())
    cp = tfluid.CompiledProgram(frozen, _fused_strategy(tfluid))
    return cp, logits.name, [p.name for p in main.all_parameters()]


def _jax_reference(logits, requests):
    """paddle_tpu: startup, freeze, fuse, and one Executor.run per
    request.  Returns (parameter values by name, logits per request)."""
    main, startup, _ = j_build(**SMALL)
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup)
    scope = jfluid.global_scope()
    params = {p.name: np.asarray(scope.find_var(p.name))
              for p in main.all_parameters()}
    frozen = j_freeze(main, FEEDS, [logits])
    cp = jfluid.CompiledProgram(frozen, _fused_strategy(jfluid))
    answers = [np.asarray(exe.run(cp, feed=f, fetch_list=[logits])[0])
               for f in requests]
    assert [op.type for op in frozen.global_block().ops].count(
        "fused_multihead_attention") == SMALL["layers"]
    return params, answers


def test_served_answers_match_reference():
    cp, logits, names = _port_program()
    requests = _requests()
    params, expected = _jax_reference(logits, requests)
    assert names == list(params)                 # same parameters, same order
    scope = interop.scope_from_numpy(params, tfluid.Scope(),
                                     tfluid.CPUPlace())
    with ServingEngine(cp, executor=tfluid.Executor(tfluid.CPUPlace()),
                       scope=scope, max_batch=16) as eng:
        futures = [eng.submit(f) for f in requests]
        answers = [fut.result(timeout=60)[logits] for fut in futures]
        stats = eng.stats()
    ops = [op.type for op in cp.program.global_block().ops]
    assert ops.count("fused_multihead_attention") == SMALL["layers"]
    assert stats["requests"] == len(ROWS) and stats["batches"] >= 3
    for n, got, want in zip(ROWS, answers, expected):
        assert got.shape == (n, 2)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_padding_rows_never_reach_an_answer():
    """A 3-row request pads to the 4-row bucket; the answer holds its 3
    rows only, equal to the same rows run without padding."""
    cp, logits, names = _port_program()
    rng = np.random.RandomState(1)
    params = {n: rng.randn(*cp.program.global_block().var(n).shape)
              .astype("float32") * 0.1 for n in names}
    scope = interop.scope_from_numpy(params, tfluid.Scope(),
                                     tfluid.CPUPlace())
    req = _requests(seed=2, rows=(3,))[0]
    exe = tfluid.Executor(tfluid.CPUPlace())
    with ServingEngine(cp, executor=exe, scope=scope, max_batch=8,
                       max_wait_us=0) as eng:
        got = eng.infer(req, timeout=60)[logits]
    assert eng.bucket_edges == (1, 2, 4, 8)
    assert got.shape == (3, 2)
    plain = tfluid.Executor(tfluid.CPUPlace())
    cp.program._hints["shape_bucketing"] = False
    want = plain.run(cp, feed=req, fetch_list=[logits], scope=scope)[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_queue_full_and_closed_engine_reject():
    cp, logits, _ = _port_program()
    eng = ServingEngine(cp, executor=tfluid.Executor(tfluid.CPUPlace()),
                        scope=tfluid.Scope(), queue_depth=2,
                        auto_start=False)
    req = _requests(rows=(1,))[0]
    queued = [eng.submit(req), eng.submit(req)]
    with pytest.raises(QueueFullError):
        eng.submit(req)
    assert eng.stats()["rejected"] == 1
    eng.close()
    for fut in queued:               # admitted, never started: rejected
        with pytest.raises(EngineClosedError):
            fut.result(timeout=5)
    with pytest.raises(EngineClosedError):
        eng.submit(req)


def test_batch_reduction_under_bucketing_refuses():
    """A mean over the padded batch axis leaves the padding rows out: 3
    rows padded to a bucket of 4 give the unpadded answer and the
    reference's answer under the same bucketing."""
    x_np = np.random.RandomState(4).randn(3, 4).astype("float32")
    answers = {}
    for name, pkg, exe in (
            ("port", tfluid, tfluid.Executor(tfluid.CPUPlace())),
            ("reference", jfluid, jfluid.Executor())):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.data("x", [-1, 4])
            out = pkg.layers.reduce_mean(x, dim=[0])
        main._hints["shape_bucketing"] = True
        answers[name] = np.asarray(
            exe.run(main, feed={"x": x_np}, fetch_list=[out])[0])
        if pkg is tfluid:
            main._hints["shape_bucketing"] = False
            answers["unpadded"] = exe.run(main, feed={"x": x_np},
                                          fetch_list=[out])[0]
    np.testing.assert_allclose(answers["port"], x_np.mean(0), rtol=1e-6)
    np.testing.assert_allclose(answers["port"], answers["unpadded"],
                               rtol=1e-6)
    np.testing.assert_allclose(answers["port"], answers["reference"],
                               rtol=1e-6)
