"""The PaddleBox CTR tier of paddle_tpu_torch against paddle_tpu: the 26
op types it brings, the builders (``fluid.layers``' ``data_norm``,
``hash``, ``continuous_value_model``, ``filter_by_instag``, ``auc`` and
``fluid.contrib.layers``), the join tower of ``chip_smoke.py`` phase 4v
at a small width, and the ``BuildStrategy`` repair.

- Op types the op sweep (``test_torch_op_sweep.py``) cannot feed run here
  on seeded numpy inputs in both packages: floats within rtol 1e-5 (and
  1e-5 of the output's largest value), ids equal; ``generic_grad`` within
  rtol 1e-4.  ``tdm_sampler`` and ``shuffle_batch`` draw random numbers
  and are held to their contracts (ROADMAP ground rule 5).
- Each reference quirk the port copies has a test, in both packages.
- The mirrors of ``tests/test_ctr_accessor.py::TestDataNorm`` and
  ``tests/test_contrib.py::TestContribLayersExecute``'s CTR cases run on
  the port.
- The join tower (4 slots, dim 8, batch 64, 2 Adam steps through
  ``fuse_optimizer``) from one box state and one scope in both
  executors: losses within rtol 1e-5, the first step's gradients at
  cosine 1e-6 of 1 and norm within 1e-5, ``data_norm``'s statistics
  within 1e-5 of their largest value, the AUC within 1e-6.  The reference
  cannot start the cache's Adam moments (its startup fills a [-1, dim]
  shape): its scope takes the port's zeros at the cache's shape.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu.dygraph import base as jdy
from paddle_tpu.fluid.core import Scope as JScope, scope_guard as jguard
from paddle_tpu.fluid.framework import reset_unique_name as j_reset
from paddle_tpu.ops import registry as jreg

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.distributed.ps.box import (get_box_wrapper,
                                                 reset_box_wrappers)
from paddle_tpu_torch.dygraph import base as tdy
from paddle_tpu_torch.fluid.framework import reset_unique_name as t_reset
from paddle_tpu_torch.ops import registry as treg

import chip_smoke as C
from test_torch_op_sweep import (_jctx, _tctx, assert_outputs_match,
                                 run_both)
from test_torch_op_sweep_grad import check_generic_grad

jax.config.update("jax_platforms", "cpu")

RTOL = 1e-5

CTR_OPS = (
    "cvm", "continuous_value_model", "fused_seqpool_cvm", "batch_fc",
    "scaled_fc", "rank_attention", "cross_norm_hadamard",
    "filter_by_instag", "hash", "pyramid_hash", "tdm_child", "tdm_sampler",
    "store_q_value", "merge_ids", "ps_lookup_rows", "data_norm",
    "fused_embedding_seq_pool", "fusion_seqpool_concat",
    "fusion_seqpool_cvm_concat", "scaled_int8fc",
    "fused_seqpool_cvm_with_pcoc", "auc", "partial_concat", "partial_sum",
    "shuffle_batch", "pull_box_extended_sparse")


def _r(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype("float32")


def test_the_26_op_types_are_registered():
    assert len(set(CTR_OPS)) == 26
    assert set(CTR_OPS) <= set(treg.all_ops()) & set(jreg.all_ops())
    assert len(treg.all_ops()) == 488


# --- the op types the sweep cannot feed ---------------------------------------
def _tags(n, seed):
    return np.random.RandomState(seed).randint(0, 8, (n, 2)).astype("int64")


MERGE_IDS = np.random.RandomState(5).randint(0, 40, 30).astype("int64")

OP_CASES = {
    "auc": ("auc", {"Predict": np.random.RandomState(1).rand(32, 2)
                    .astype("float32"),
                    "Label": np.random.RandomState(2).randint(0, 2, (32, 1))
                    .astype("int64"),
                    "StatPos": np.arange(65, dtype="float32")[None] % 3,
                    "StatNeg": np.arange(65, dtype="float32")[None] % 5},
            {"num_thresholds": 64}),
    "filter_by_instag": ("filter_by_instag",
                         {"Ins": _r(16, 6, seed=3),
                          "Ins_tag": _tags(16, 4),
                          "Filter_tag": np.array([1, 4, 6], "int64")},
                         {"is_lod": False}),
    "merge_ids": ("merge_ids", {"Ids": MERGE_IDS, "X": [
        _r(int((MERGE_IDS % 4 == s).sum()), 4, seed=6 + s)
        for s in range(4)]}, {}),
    "pull_box_extended_sparse": (
        "pull_box_extended_sparse",
        {"W": _r(32, 8, seed=10),
         "Ids": [np.random.RandomState(11 + i).randint(0, 32, (6, 3))
                 .astype("int64") for i in range(2)]},
        {"emb_extended_size": 4}),
    "scaled_int8fc": ("scaled_int8fc",
                      {"Input": _r(8, 12, seed=12), "W": _r(12, 5, seed=13),
                       "Bias": _r(5, seed=14)},
                      {"input_scale": 0.05, "weight_scale": 0.02}),
    "tdm_child": ("tdm_child",
                  {"X": np.array([[1], [2], [5], [0]], "int64"),
                   "TreeInfo": np.array(
                       [[0, 0, 0, 0, 0], [0, 1, 0, 2, 3], [0, 2, 1, 4, 5],
                        [0, 2, 1, 6, 0], [7, 3, 2, 0, 0], [8, 3, 2, 0, 0],
                        [9, 3, 3, 0, 0]], "int64")},
                  {"child_nums": 2}),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_forward_matches_reference(case):
    op, ins, attrs = OP_CASES[case]
    ref, port = run_both(op, ins, attrs)
    assert_outputs_match(ref, port, RTOL, case)


def test_scaled_int8fc_generic_grad_matches_reference():
    """The product of the rounded inputs: every gradient 0 through
    round, in both packages, and the bias's is the cotangent's sum."""
    op, ins, attrs = OP_CASES["scaled_int8fc"]
    check_generic_grad(op, ins, attrs, ["Input", "W", "Bias"], rtol=1e-4)


def test_scaled_int8fc_rounds_half_to_even():
    ins = {"Input": np.array([[0.5, 1.5, 2.5, -0.5]], "float32"),
           "W": np.eye(4, dtype="float32")}
    ref, port = run_both("scaled_int8fc", ins, {})
    np.testing.assert_array_equal(port["Out"][0].numpy(), [[0, 2, 2, 0]])
    np.testing.assert_array_equal(np.asarray(ref["Out"][0]), [[0, 2, 2, 0]])


@pytest.mark.parametrize("x64", [False, True])
def test_hash_matches_both_reference_branches(x64):
    """Below 2^32 the reference's two branches agree; from 2^32 the port
    follows its x64 branch, which mixes the high word in."""
    rng = np.random.RandomState(20)
    if x64:
        ids = rng.randint(0, 1 << 40, (64, 3), dtype=np.int64)
        ids[:4] = [[1 << 32, (1 << 33) + 5, (1 << 40) - 1]] * 4
    else:
        ids = rng.randint(0, 1 << 31, (64, 3)).astype(np.int64)
        ids[0] = [0, (1 << 31) - 1, 12345]
    attrs = {"num_hash": 3, "mod_by": 1_000_003}
    if x64:
        with jax.enable_x64(True):
            want = np.asarray(jreg.get_op("hash").fn(
                {"X": [jnp.asarray(ids)]}, attrs, _jctx())["Out"][0])
    else:
        want = np.asarray(jreg.get_op("hash").fn(
            {"X": [jnp.asarray(ids)]}, attrs, _jctx())["Out"][0])
    got = treg.get_op("hash").fn({"X": [torch.from_numpy(ids)]}, attrs,
                                 _tctx())["Out"][0]
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (64, 3, 3) and int(got.min()) >= 0


def test_tdm_sampler_contract():
    """Column 0 of each layer's block is the item's travel node (label 1,
    mask set); its negatives are nodes of that layer (label 0)."""
    travel = np.array([[1, 3], [2, 5], [2, 6]], "int64")   # 3 items
    layer = np.array([[1, 2, 0, 0], [3, 4, 5, 6]], "int64")
    x = np.array([[0], [2], [1], [2]], "int64")
    outs = treg.get_op("tdm_sampler").fn(
        {"X": [torch.from_numpy(x)], "Travel": [torch.from_numpy(travel)],
         "Layer": [torch.from_numpy(layer)]},
        {"neg_samples_num_list": [1, 2], "op_seed": 3}, _tctx())
    out, lab, mask = (outs[k][0].numpy()[..., 0]
                      for k in ("Out", "Labels", "Mask"))
    assert out.shape == lab.shape == mask.shape == (4, 5)
    np.testing.assert_array_equal(out[:, 0], travel[x[:, 0], 0])
    np.testing.assert_array_equal(out[:, 2], travel[x[:, 0], 1])
    np.testing.assert_array_equal(lab, np.tile([1, 0, 1, 0, 0], (4, 1)))
    assert set(out[:, 1]) <= set(layer[0])
    assert set(out[:, 3:].ravel()) <= set(layer[1])
    np.testing.assert_array_equal(mask, (out != 0).astype(int))


def test_shuffle_batch_contract():
    """A permutation; Out == X[ShuffleIdx]; the gradient scatters back."""
    x = _r(16, 3, seed=21)
    ins = {"X": [torch.from_numpy(x)]}
    outs = treg.get_op("shuffle_batch").fn(ins, {"op_seed": 4}, _tctx())
    idx = outs["ShuffleIdx"][0].numpy()
    assert sorted(idx) == list(range(16)) and (idx != np.arange(16)).any()
    np.testing.assert_array_equal(outs["Out"][0].numpy(), x[idx])
    g = _r(16, 3, seed=22)
    grads = treg.get_op("generic_grad").fn(
        {"I_X": [torch.from_numpy(x)], "G_Out": [torch.from_numpy(g)]},
        {"fwd_type": "shuffle_batch", "fwd_attrs": {"op_seed": 4},
         "grad_slots": ["X"], "in_slots": ["X"]}, _tctx())
    want = np.zeros_like(g)
    want[idx] = g
    np.testing.assert_array_equal(grads["GI_X"][0].numpy(), want)


# --- the reference's quirks, copied --------------------------------------------
def _outs(res, slot="Out"):
    return [np.asarray(v.numpy() if hasattr(v, "numpy") else v)
            for v in res[slot]]


def test_fused_seqpool_cvm_quirks():
    """SUM whatever ``pooltype`` says, CVM unread, one Length for every
    slot, and log(x + 1) of the pooled columns 0 and 1: a pooled value
    of -1 or less gives NaN."""
    xs = [_r(4, 3, 5, seed=30), _r(4, 3, 5, seed=31)]
    xs[0][0, :, 0] = -1.0                       # pools to -3: NaN
    length = np.array([3, 1, 0, 2], "int64")
    base = {"X": xs, "CVM": _r(4, 2, seed=32), "Length": length}
    for pkg in (0, 1):
        got = [_outs(run_both("fused_seqpool_cvm", ins, attrs)[pkg])
               for ins, attrs in (
                   (base, {"pooltype": "SUM"}),
                   (base, {"pooltype": "AVERAGE", "cvm_offset": 7}),
                   (dict(base, CVM=_r(4, 2, seed=33)), {}))]
        for other in got[1:]:
            for a, b in zip(got[0], other):
                np.testing.assert_array_equal(a, b)
        out0, out1 = got[0]
        assert np.isnan(out0[0, 0])
        pooled = (xs[1] * (np.arange(3)[None] < length[:, None])[..., None]
                  ).sum(1)
        np.testing.assert_allclose(out1[:, 2:], pooled[:, 2:], rtol=1e-6)
        np.testing.assert_allclose(out1[2], 0.0)          # empty row


@pytest.mark.parametrize("op,lead", [("fused_seqpool_cvm_with_pcoc", 3),
                                     ("fusion_seqpool_cvm_concat", 2)])
def test_cvm_variants_strip_without_log(op, lead):
    xs = [_r(4, 3, 6, seed=34), _r(4, 3, 6, seed=35)]
    pooled = [x.sum(1) for x in xs]
    for use_cvm in (True, False):
        ref, port = run_both(op, {"X": xs}, {"use_cvm": use_cvm})
        want = [p if use_cvm else p[:, lead:] for p in pooled]
        if op == "fusion_seqpool_cvm_concat":
            want = [np.concatenate(want, -1)]
        for got in (_outs(ref), _outs(port)):
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, rtol=1e-6)


def test_batch_fc_is_always_relu():
    ins = {"Input": _r(2, 4, 3, seed=36), "W": _r(2, 3, 5, seed=37),
           "Bias": _r(2, 5, seed=38)}
    for pkg in (0, 1):
        relu, sig = (_outs(run_both("batch_fc", ins, {"activation": a})[pkg])
                     for a in ("relu", "sigmoid"))
        np.testing.assert_array_equal(relu[0], sig[0])
        assert (relu[0] == 0).any()


def test_scaled_fc_reads_no_grad_scale_factor():
    ins = {"Input": _r(4, 6, seed=39), "W": _r(6, 3, seed=40),
           "Bias": _r(3, seed=41)}
    for f in (1.0, 5.0):
        check_generic_grad("scaled_fc", ins,
                           {"input_scale_factor": 0.5,
                            "bias_scale_factor": 2.0,
                            "grad_scale_factor": f}, rtol=1e-4)
    g = [treg.get_op("generic_grad").fn(
        {"I_" + k: [torch.from_numpy(v)] for k, v in ins.items()}
        | {"G_Out": [torch.ones(4, 3)]},
        {"fwd_type": "scaled_fc", "fwd_attrs": {"grad_scale_factor": f},
         "grad_slots": ["Input"], "in_slots": list(ins)}, _tctx())
        for f in (1.0, 5.0)]
    np.testing.assert_array_equal(g[0]["GI_Input"][0].numpy(),
                                  g[1]["GI_Input"][0].numpy())


def _cross_norm_step(fluid, reset, decay):
    reset()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", [-1, 12])
        out = fluid.contrib.layers.cross_norm_layer_hadamard(
            x, fields_num=2, embed_dim=3, summary_decay_rate=decay)
        loss = fluid.layers.mean(out)
        fluid.optimizer.SGDOptimizer(0.5).minimize(loss)
    summ = [p.name for p in main.global_block().all_parameters()][0]
    return main, startup, out, summ


def test_cross_norm_summary_is_a_trained_parameter():
    """SummaryInput's rows 0 and 1 are the mean and the scale, a
    parameter SGD moves; ``summary_decay_rate`` is not read."""
    feed = {"x": _r(5, 12, seed=42)}
    moved = {}
    for pkg, fluid, reset in (("ref", jfluid, j_reset),
                              ("port", tfluid, t_reset)):
        for decay in (0.9999999, 0.5):
            main, startup, out, summ = _cross_norm_step(fluid, reset, decay)
            if pkg == "ref":
                scope, exe = JScope(), jfluid.Executor()
                with jguard(scope):
                    exe.run(startup)
                    exe.run(main, feed=feed, fetch_list=[out])
                    moved[pkg, decay] = np.asarray(scope.find_var(summ))
            else:
                scope = tfluid.Scope()
                exe = tfluid.Executor(tfluid.CPUPlace())
                exe.run(startup, scope=scope)
                exe.run(main, feed=feed, fetch_list=[out], scope=scope)
                moved[pkg, decay] = np.asarray(scope.find_var(summ))
    init = np.concatenate([np.zeros((1, 18)), np.ones((1, 18))])
    for decay in (0.9999999, 0.5):
        assert not np.allclose(moved["port", decay], init)
        np.testing.assert_allclose(moved["port", decay], moved["ref", decay],
                                   rtol=1e-6)
    np.testing.assert_array_equal(moved["port", 0.5],
                                  moved["port", 0.9999999])


def test_filter_by_instag_zeroes_and_never_compacts():
    """Rows without a filter tag are zeroed in place, LossWeight 0; no
    gradient flows through it (a leaf op in both packages); ``is_lod``
    and ``out_val_if_empty`` are not read."""
    op, ins, attrs = OP_CASES["filter_by_instag"]
    hit = np.isin(ins["Ins_tag"], ins["Filter_tag"]).any(1)
    assert hit.any() and not hit.all()
    for pkg in (0, 1):
        res = [run_both(op, ins, a)[pkg] for a in (
            attrs, {"is_lod": True, "out_val_if_empty": 7})]
        for r in res:
            out, w = _outs(r)[0], _outs(r, "LossWeight")[0]
            assert out.shape == ins["Ins"].shape
            np.testing.assert_array_equal(out[~hit], 0.0)
            np.testing.assert_array_equal(out[hit], ins["Ins"][hit])
            np.testing.assert_array_equal(w[:, 0], hit.astype("float32"))
            np.testing.assert_array_equal(
                _outs(r, "IndexMap")[0], np.stack([np.arange(16)] * 2, 1))
    assert not treg.get_op(op).differentiable
    assert not jreg.get_op(op).differentiable


def test_fused_embedding_seq_pool_reads_no_padding_idx():
    ins = {"W": _r(10, 4, seed=43),
           "Ids": np.array([[1, 0, 3], [0, 0, 2]], "int64")}
    for pkg in (0, 1):
        a, b = (_outs(run_both("fused_embedding_seq_pool", ins,
                               {"padding_idx": p})[pkg])[0]
                for p in (-1, 0))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a[1], ins["W"][[0, 0, 2]].sum(0),
                                   rtol=1e-6)


def test_tdm_sampler_reads_no_output_flags():
    ins = {"X": [torch.tensor([[0], [1]])],
           "Travel": [torch.tensor([[1, 3], [2, 5]])],
           "Layer": [torch.tensor([[1, 2], [3, 5]])]}
    outs = [treg.get_op("tdm_sampler").fn(
        ins, {"op_seed": 5, "output_positive": pos, "output_list": lst},
        _tctx()) for pos, lst in ((True, True), (False, False))]
    for k in ("Out", "Labels", "Mask"):
        np.testing.assert_array_equal(outs[0][k][0].numpy(),
                                      outs[1][k][0].numpy())


def _bucketed(ctx, valid, padded):
    ctx.batch_valid, ctx.batch_padded = valid, padded
    return ctx


def test_auc_masks_padded_rows_and_reads_the_last_column():
    """Under shape bucketing the padded rows add nothing to the
    histograms; ``Predict[:, -1]`` is read, ``curve`` and ``slide_steps``
    are not."""
    op, ins, attrs = OP_CASES["auc"]
    full = {k: v[:20] if k in ("Predict", "Label") else v
            for k, v in ins.items()}
    pad = dict(full, Predict=np.concatenate([full["Predict"],
                                             np.ones((12, 2), "float32")]),
               Label=np.concatenate([full["Label"],
                                     np.ones((12, 1), "int64")]))
    want = run_both(op, full, attrs)
    jt = {k: [jnp.asarray(v)] for k, v in pad.items()}
    tt = {k: [torch.from_numpy(v)] for k, v in pad.items()}
    ref = jreg.get_op(op).fn(jt, attrs, _bucketed(_jctx(), 20, 32))
    for extra in ({}, {"curve": "PR", "slide_steps": 5}):
        port = treg.get_op(op).fn(tt, dict(attrs, **extra),
                                  _bucketed(_tctx(), 20, 32))
        assert_outputs_match(ref, port, RTOL, "auc bucketed")
        assert_outputs_match(want[0], port, RTOL, "auc bucketed vs 20 rows")
    flipped = dict(full, Predict=full["Predict"][:, ::-1].copy())
    ref_f, port_f = run_both(op, flipped, attrs)
    assert_outputs_match(ref_f, port_f, RTOL, "auc column 0 last")
    assert float(port_f["AUC"][0]) != pytest.approx(
        float(want[1]["AUC"][0]), rel=1e-3)


def test_data_norm_statistics_see_padded_rows():
    """The reference's data_norm does not read the batch mask: a bucketed
    batch's padded rows enter the statistics, in both packages."""
    x = _r(6, 4, seed=44, scale=3.0)
    padded = np.concatenate([x, np.zeros((2, 4), "float32")])
    stats = {"BatchSize": np.full(4, 1e4, "float32"),
             "BatchSum": np.zeros(4, "float32"),
             "BatchSquareSum": np.full(4, 1e4, "float32")}
    attrs = {"summary_decay_rate": 1.0, "sync_stats": True}
    ins = dict(stats, X=padded)
    ref = jreg.get_op("data_norm").fn({k: [jnp.asarray(v)]
                                       for k, v in ins.items()}, attrs,
                                      _bucketed(_jctx(), 6, 8))
    port = treg.get_op("data_norm").fn({k: [torch.from_numpy(v)]
                                        for k, v in ins.items()}, attrs,
                                       _bucketed(_tctx(), 6, 8))
    assert_outputs_match(ref, port, RTOL, "data_norm bucketed")
    np.testing.assert_allclose(port["BatchSizeOut"][0].numpy(), 1e4 + 8)


def test_pull_box_extended_sparse_builder_appends_no_w():
    """The reference's ``_pull_box_extended_sparse`` appends no ``W``, and
    the lowering reads it: both packages raise KeyError('W') when the op
    runs."""
    ids = np.array([[1, 2]], "int64")
    with jdy.guard():
        with pytest.raises(KeyError, match="W"):
            jfluid.contrib.layers._pull_box_extended_sparse(
                jdy.to_variable(ids), 8)
    with tdy.guard(tfluid.CPUPlace()):
        with pytest.raises(KeyError, match="W"):
            tfluid.contrib.layers._pull_box_extended_sparse(
                tdy.to_variable(ids), 8)


# --- the reference's own cases, on the port -----------------------------------
class TestDataNorm:
    """tests/test_ctr_accessor.py::TestDataNorm on the port."""

    def _build(self, slot_dim=-1, c=6):
        t_reset()
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.data("dn_x", [-1, c])
            y = tfluid.layers.data_norm(x, name="dn", slot_dim=slot_dim,
                                        summary_decay_rate=1.0)
            loss = tfluid.layers.mean(y)
            tfluid.optimizer.SGDOptimizer(0.0).minimize(loss)
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        return exe, scope, main, y

    def test_forward_uses_summary_not_batch(self):
        exe, s, main, y = self._build()
        x = (np.random.RandomState(0).randn(8, 6) * 3 + 5).astype("float32")
        yv, = exe.run(main, feed={"dn_x": x}, fetch_list=[y], scope=s)
        np.testing.assert_allclose(yv, x, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(s.find_var("dn.batch_size")),
                                   1e4 + 8, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(s.find_var("dn.batch_sum")),
                                   x.sum(0), rtol=1e-5)
        yv2, = exe.run(main, feed={"dn_x": x}, fetch_list=[y], scope=s)
        mean = x.sum(0) / (1e4 + 8)
        scale = np.sqrt((1e4 + 8) / (1e4 + (x ** 2).sum(0) + 8 * 1e-4))
        np.testing.assert_allclose(yv2, (x - mean) * scale, rtol=1e-4)

    def test_eval_clone_freezes_stats(self):
        exe, s, main, y = self._build()
        x = np.random.RandomState(1).randn(4, 6).astype("float32")
        exe.run(main.clone(for_test=True), feed={"dn_x": x},
                fetch_list=[y.name], scope=s)
        np.testing.assert_allclose(np.asarray(s.find_var("dn.batch_size")),
                                   1e4)

    def test_slot_dim_skips_zero_show(self):
        exe, s, main, y = self._build(slot_dim=3)
        x = np.ones((4, 6), np.float32)
        x[2, 0] = 0.0
        exe.run(main, feed={"dn_x": x}, fetch_list=[y], scope=s)
        np.testing.assert_allclose(np.asarray(s.find_var("dn.batch_sum")),
                                   np.ones(6), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(s.find_var("dn.batch_size")),
                                   1e4 + 1.0, rtol=1e-6)

    def test_grad_is_dy_times_scales(self):
        t_reset()
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.data("g_x", [-1, 4])
            x.stop_gradient = False
            y = tfluid.layers.data_norm(x, name="gdn",
                                        param_attr={"batch_square": 4e4})
            grads = tfluid.backward.gradients(tfluid.layers.reduce_sum(y),
                                              [x])
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        xv = np.random.RandomState(2).randn(5, 4).astype("float32")
        gv, = exe.run(main, feed={"g_x": xv}, fetch_list=[grads[0]],
                      scope=scope)
        np.testing.assert_allclose(gv, 0.5 * np.ones_like(xv), rtol=1e-6)


def _rand(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


@pytest.fixture
def dygraph():
    with tdy.guard(tfluid.CPUPlace()):
        yield tfluid.contrib.layers, tdy.to_variable


class TestContribLayersExecute:
    """tests/test_contrib.py::TestContribLayersExecute's CTR cases on the
    port's tracer."""

    def test_ctr_tier(self, dygraph):
        CL, tv = dygraph
        r = np.random.RandomState(0)
        x = tv(_rand((4, 6)))
        assert CL.fused_elemwise_activation(
            x, tv(_rand((4, 6), 1)), ["elementwise_add", "relu"]
        ).shape == (4, 6)
        assert CL.shuffle_batch(x).shape == (4, 6)
        assert CL.partial_concat([x, x], 0, 3).shape == (4, 6)
        assert CL.partial_sum([x, x], 0, 3).shape == (4, 3)
        assert CL.batch_fc(tv(_rand((3, 4, 8))), [3, 8, 5], None,
                           [3, 5], None).shape == (3, 4, 5)
        ro = np.zeros((4, 7), "int32")
        ro[:, 0] = 1
        ro[:, 2] = np.arange(4)
        assert CL.rank_attention(x, tv(ro), [8, 30], None,
                                 max_rank=3).shape == (4, 5)
        assert CL.cross_norm_layer_hadamard(
            tv(_rand((4, 12))), fields_num=2, embed_dim=3).shape == (4, 18)
        assert CL.scaled_fc(x, 5, 1.0, 1.0, 1.0).shape == (4, 5)
        assert CL.scaled_int8fc(x, 5, 0.1, 0.1).shape == (4, 5)
        ids = tv(r.randint(0, 50, (4, 3)).astype("int64"))
        assert CL.fused_embedding_seq_pool(ids, [50, 16]).shape == (4, 16)
        cvm = tv(np.ones((4, 2), "float32"))
        outs = CL.fused_seqpool_cvm([tv(_rand((4, 5, 8)))], "sum", cvm)
        assert outs[0].shape == (4, 8)

    def test_text_match_tier(self, dygraph):
        CL, tv = dygraph
        xx, yy = tv(_rand((2, 5, 8))), tv(_rand((2, 7, 8), 1))
        mm, _tmp = CL.match_matrix_tensor(xx, yy, channel_num=3)
        assert mm.shape == (2, 3, 5, 7)
        row = tv(np.zeros((2, 5), "float32"))
        col = tv(np.zeros((2, 7), "float32"))
        vc = CL.var_conv_2d(mm, row, col, input_channel=3,
                            output_channel=4, filter_size=3)
        assert vc.shape == (2, 4, 5, 7)
        tp = CL.sequence_topk_avg_pooling(tv(_rand((2, 3, 9))), row, col,
                                          topks=[1, 3], channel_num=3)
        assert tp.shape[0] == 2
        ph = CL.search_pyramid_hash(
            tv(np.arange(6).reshape(3, 2).astype("int64")), num_emb=16,
            space_len=64, pyramid_layer=2, rand_len=16,
            drop_out_percent=0, is_training=True, use_filter=False,
            white_list_len=0, black_list_len=0, seed=0, lr=1.0)
        assert ph.shape == (3, 16)

    def test_tdm_tier(self, dygraph):
        CL, tv = dygraph
        x = tv(np.arange(3).reshape(3, 1).astype("int64"))
        child, mask = CL.tdm_child(x, node_nums=8, child_nums=2)
        assert child.shape == (3, 1, 2) and mask.shape == (3, 1, 2)
        out, labels, m = CL.tdm_sampler(x, [1, 1], [2, 4], 8)
        assert out.shape == labels.shape == m.shape == (3, 4, 1)

    def test_ctr_metric_bundle(self, dygraph):
        CL, tv = dygraph
        pred = tv(np.array([[0.2], [0.8]], "float32"))
        lab = tv(np.array([[0.0], [1.0]], "float32"))
        sq, ab, pr, q = CL.ctr_metric_bundle(pred, lab)
        np.testing.assert_allclose(float(sq.numpy()), 0.08, rtol=1e-5)
        np.testing.assert_allclose(float(ab.numpy()), 0.4, rtol=1e-5)
        np.testing.assert_allclose(float(pr.numpy()), 1.0, rtol=1e-5)
        np.testing.assert_allclose(float(q.numpy()), 0.8, rtol=1e-5)


# --- the join tower ---------------------------------------------------------
JOIN_TEST = dict(C.JOIN_HOST, batch=64, steps=2)
STATS = ("join_dn.batch_size", "join_dn.batch_sum",
         "join_dn.batch_square_sum")


def _join_built(fluid, reset):
    reset()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = C.SEED
    with fluid.program_guard(main, startup):
        outs = C.ctr_join_program(fluid, JOIN_TEST)
    bs = fluid.BuildStrategy()
    bs.fuse_optimizer = True
    fetch = [outs[0], outs[1]] + [g for _, g in outs[-1]]
    return main, startup, fetch, fluid.CompiledProgram(main, bs)


@pytest.fixture(scope="module")
def join_runs():
    """Both executors' fetches of the two steps and the statistics after,
    from one box state (the port's begin_pass) and one scope (the port's
    startup, the cache, the cache's zero Adam moments)."""
    reset_box_wrappers()
    tm, ts, tfetch, tprog = _join_built(tfluid, t_reset)
    box = get_box_wrapper(JOIN_TEST["table"], dim=JOIN_TEST["dim"],
                          init_kind="gaussian", init_scale=0.01)
    raw = C.ctr_join_raw_ids(JOIN_TEST, JOIN_TEST["steps"], C.SEED + 1)
    cache = box.begin_pass(raw)
    feeds = [C.ctr_join_feed(JOIN_TEST, box.slots_of(r.reshape(-1))
                             .reshape(r.shape), C.SEED + 10 + i)
             for i, r in enumerate(raw)]
    box.abandon_pass()
    reset_box_wrappers()
    place = tfluid.CPUPlace()
    exe, scope = tfluid.Executor(place), tfluid.Scope()
    exe.run(ts, scope=scope)
    init = interop.scope_to_numpy(
        scope, [n for n, v in tm.global_block().vars.items()
                if v.persistable and scope.find_var(n) is not None])
    init[JOIN_TEST["table"] + "@HBMCACHE"] = np.asarray(cache)
    for n, (param, fill) in tm._hints["runtime_shaped_state"].items():
        init[n] = np.full_like(init[param], fill)
    scope = interop.scope_from_numpy(init, tfluid.Scope(), place)
    port = [exe.run(tprog, feed=f, fetch_list=tfetch, scope=scope)
            for f in feeds]
    port_stats = interop.scope_to_numpy(scope, STATS)
    jm, _, jfetch, jprog = _join_built(jfluid, j_reset)
    assert [v.name for v in jfetch] == [v.name for v in tfetch]
    jscope, jexe = JScope(), jfluid.Executor()
    with jguard(jscope):
        for n, v in init.items():
            jscope.set_var(n, jnp.asarray(v))
        ref = [[np.asarray(v) for v in jexe.run(jprog, feed=f,
                                                 fetch_list=jfetch)]
               for f in feeds]
        ref_stats = {n: np.asarray(jscope.find_var(n)) for n in STATS}
    return {"port": port, "ref": ref, "port_stats": port_stats,
            "ref_stats": ref_stats, "main": tm}


def test_join_tower_runs_one_fused_adam(join_runs):
    ops = [op.type for op in join_runs["main"].global_block().ops]
    assert ops.count("fused_adam") == 1 and "adam" not in ops
    for op in ("pull_box_sparse", "fused_seqpool_cvm", "data_norm",
               "cross_norm_hadamard", "batch_fc", "rank_attention",
               "scaled_fc", "filter_by_instag", "auc"):
        assert op in ops, op


def test_join_tower_losses_and_auc_match_reference(join_runs):
    for got, want in zip(join_runs["port"], join_runs["ref"]):
        np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
        np.testing.assert_allclose(float(got[1]), float(want[1]), atol=1e-6)


def test_join_tower_first_step_gradients_match_reference(join_runs):
    cos, norm = C._cosine(join_runs["port"][0][2:], join_runs["ref"][0][2:])
    assert 1 - cos < 1e-6 and abs(norm - 1) < 1e-5


@pytest.mark.parametrize("name", STATS)
def test_join_tower_data_norm_statistics_match_reference(join_runs, name):
    got, want = join_runs["port_stats"][name], join_runs["ref_stats"][name]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_box_cache_moments_restart_with_a_new_pass():
    """The cache's Adam moments are sized at run time and dropped when a
    pass's cache is staged (distributed/trainer.py)."""
    from paddle_tpu_torch.distributed.trainer import _stage_cache
    main = _join_built(tfluid, t_reset)[0]
    names = sorted(main._hints["runtime_shaped_state"])
    assert names == [f"AdamOptimizer_moment{i}_{JOIN_TEST['table']}"
                     f"@HBMCACHE" for i in (1, 2)]
    scope = tfluid.Scope()
    for n in names:
        scope.set_var(n, torch.ones(3, 8))
    _stage_cache(main, scope, main._hints["box_plan"], np.zeros((4, 8)))
    assert all(scope.find_var(n) is None for n in names)


# --- the BuildStrategy repair ---------------------------------------------------
def test_build_strategy_has_the_reference_knobs():
    assert vars(tfluid.BuildStrategy()) == vars(jfluid.BuildStrategy())


def _graphviz_dump(fluid, reset, path):
    """A forward program through two passes with the dumps on (with a
    backward the dumps differ: the port's shape inference gives every
    ``@GRAD`` var a shape, the reference's only some;
    ``test_torch_quant_tier.py::test_grad_var_shapes_match_the_reference``)."""
    reset()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", [-1, 8])
        h = fluid.layers.fc(x, 8, act="relu")
        out = fluid.layers.mean(fluid.layers.fc(h, 1) + h)
        fluid.layers.scale(x, 2.0)                  # dead: dce drops it
    bs = fluid.BuildStrategy()
    bs.fuse_elewise_add_act_ops = True
    bs.enable_dce = True
    bs.debug_graphviz_path = path
    fluid.CompiledProgram(main, bs)._apply_ir_passes([out.name])
    return {f: open(os.path.join(path, f)).read()
            for f in sorted(os.listdir(path))}


def test_debug_graphviz_path_writes_the_reference_dot_files(tmp_path):
    want = _graphviz_dump(jfluid, j_reset, str(tmp_path / "ref"))
    got = _graphviz_dump(tfluid, t_reset, str(tmp_path / "port"))
    assert list(got) == list(want) == [
        "00_input.dot", "01_fuse_elewise_add_act.dot", "02_dce.dot"]
    assert got["01_fuse_elewise_add_act.dot"] != got["00_input.dot"]
    for name in want:
        assert got[name] == want[name].replace(
            str(tmp_path / "ref"), str(tmp_path / "port")), name


@pytest.mark.parametrize("knob,value", [
    ("sync_batch_norm", True), ("sharding_mesh", {"dp": 2}),
    ("num_trainers", 2), ("trainers_endpoints", ["127.0.0.1:6170"]),
    ("nccl_comm_num", 2), ("collective_mode", "grad_allreduce")])
def test_multi_card_knob_raises_naming_item_10(knob, value):
    bs = tfluid.BuildStrategy()
    setattr(bs, knob, value)
    with pytest.raises(NotImplementedError, match=f"{knob}.*item 10"):
        tfluid.passes.passes_for_build_strategy(bs)
    setattr(bs, knob, getattr(tfluid.BuildStrategy(), knob))
    tfluid.passes.passes_for_build_strategy(bs)


def test_fuse_grad_size_hint_is_read():
    t_reset()
    main = tfluid.Program()
    main._hints["fuse_grad_size_in_num"] = 8
    bs = tfluid.BuildStrategy()
    tfluid.CompiledProgram(main, bs)._apply_ir_passes([])
    assert bs.fuse_grad_size_in_num == 8
