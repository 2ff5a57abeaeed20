"""The sequence tier's 29 op types in both packages, op by op: the eight
padded-LoD ops of ``ops/sequence_extra.py``, the five of
``fluid/layers/sequence_lod.py``, ``sequence_reshape`` and
``sequence_topk_avg_pooling``, the thirteen of ``ops/nlp_ops.py`` (the
CRF, CTC, chunk and edit-distance ops, the sampled heads, the text-
matching convolutions) and ``center_loss``.

- Forward: every output within rtol 1e-4 of its largest value, integer
  outputs equal (values, not dtypes: the reference's ids are int32).
- Through ``generic_grad``: every float input gradient from one random
  cotangent, within rtol 1e-4.
- ``crf_decoding``'s Viterbi paths: each decoded path's CRF score
  within rtol 1e-5 of the reference path's, and the paths equal wherever
  the best path beats the best path that differs from it (found from
  the max-marginals, ``chip_smoke._viterbi_margin``, phase 4t's rule) by
  more than 1e-3 (``viterbi_check``, which ``test_torch_srl.py`` uses too
  and which returns how many rows it held exactly).
- ``nce`` and ``sample_logits`` draw their negatives from the op's seed
  (Philox on the card, torch's generator on the host), so nothing
  compares draws across packages: ROADMAP ground rule 5's contract
  holds them instead (the costs are a numpy formula of the port's own
  samples, the samples lie in [0, V) and are uniform within 6 sigma, one
  seed one draw, and the gradient is the formula's).
"""
import numpy as np
import pytest
import torch

import jax

import chip_smoke as C
from paddle_tpu_torch.ops import registry as treg

jax.config.update("jax_platforms", "cpu")

RTOL = 1e-4
VITERBI_MARGIN = C.VITERBI_MARGIN


# the op sweep's helpers, imported at the call: the sweep imports this
# module's OP_CASES
def run_both(*args, **kw):
    import test_torch_op_sweep
    return test_torch_op_sweep.run_both(*args, **kw)


def assert_outputs_match(*args, **kw):
    import test_torch_op_sweep
    return test_torch_op_sweep.assert_outputs_match(*args, **kw)


def check_generic_grad(*args, **kw):
    import test_torch_op_sweep_grad
    return test_torch_op_sweep_grad.check_generic_grad(*args, **kw)


def _r(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _ints(hi, *shape, seed=0):
    return np.random.RandomState(seed).randint(0, hi, shape).astype("int64")


LEN = np.array([5, 3, 1], "int64")          # B = 3 rows of T = 5
LEN6 = np.array([6, 4, 2], "int64")
OP_CASES = {
    # ops/sequence_extra.py
    "sequence_conv": ("sequence_conv", {"X": _r(3, 5, 4, seed=1),
                                        "Filter": _r(12, 6, seed=2),
                                        "Length": LEN},
                      {"contextLength": 3, "contextStart": -1}),
    "sequence_conv window past both ends": (
        "sequence_conv", {"X": _r(3, 5, 4, seed=1),
                          "Filter": _r(32, 3, seed=3)},
        {"contextLength": 8, "contextStart": -6}),
    "sequence_expand_as": ("sequence_expand_as", {"X": _r(3, 4, seed=4),
                                                  "Y": _r(3, 5, 2, seed=5)},
                           {}),
    "sequence_pad longer": ("sequence_pad",
                            {"X": _r(3, 5, 4, seed=6),
                             "PadValue": np.array([0.5], "float32"),
                             "Length": LEN}, {"padded_length": 7}),
    "sequence_pad a step's value": ("sequence_pad",
                                    {"X": _r(3, 5, 4, seed=6),
                                     "PadValue": _r(4, seed=7),
                                     "Length": LEN}, {"padded_length": 4}),
    "sequence_unpad": ("sequence_unpad", {"X": _r(3, 5, 4, seed=8),
                                          "Length": LEN}, {}),
    "sequence_slice": ("sequence_slice",
                       {"X": _r(3, 5, 4, seed=9),
                        "Offset": np.array([[1], [0], [3]], "int64"),
                        "Length": np.array([[3], [2], [2]], "int64")}, {}),
    "sequence_erase": ("sequence_erase", {"X": _ints(6, 3, 7, seed=10)},
                       {"tokens": [2, 4]}),
    "sequence_enumerate": ("sequence_enumerate",
                           {"X": _ints(8, 3, 5, seed=11)},
                           {"win_size": 3, "pad_value": 9}),
    "sequence_scatter": ("sequence_scatter",
                         {"X": _r(3, 4, seed=12),
                          "Ids": np.array([[0], [2], [2], [-1], [7]],
                                          "int64"),
                          "Updates": _r(5, 4, seed=13)}, {}),
    # fluid/layers/sequence_lod.py
    "sequence_mask": ("sequence_mask", {"X": LEN},
                      {"maxlen": 6, "out_dtype": "int64"}),
    "sequence_mask from the longest": ("sequence_mask", {"X": LEN6},
                                       {"maxlen": -1, "out_dtype": "float32"}),
    "sequence_softmax": ("sequence_softmax", {"X": _r(3, 5, seed=14),
                                              "Length": LEN}, {}),
    "sequence_softmax without lengths": ("sequence_softmax",
                                         {"X": _r(3, 5, 2, seed=15)}, {}),
    "sequence_expand": ("sequence_expand", {"X": _r(3, 4, seed=16),
                                            "Y": _r(3, 5, seed=17)}, {}),
    "sequence_reverse": ("sequence_reverse", {"X": _r(3, 5, 4, seed=18),
                                              "Length": LEN}, {}),
    "sequence_concat": ("sequence_concat", {"X": [_r(3, 2, 4, seed=19),
                                                  _r(3, 3, 4, seed=20)]}, {}),
    # ops/catalog_tail_ops.py
    "sequence_reshape": ("sequence_reshape", {"X": _r(3, 4, 6, seed=21)},
                         {"new_dim": 8}),
    "sequence_topk_avg_pooling": ("sequence_topk_avg_pooling",
                                  {"X": _r(2, 3, 6, seed=22)},
                                  {"topks": [1, 3, 9]}),
    # ops/nlp_ops.py: the CRF tier
    "linear_chain_crf": ("linear_chain_crf",
                         {"Emission": _r(3, 5, 4, seed=23),
                          "Transition": _r(6, 4, seed=24),
                          "Label": _ints(4, 3, 5, seed=25), "Length": LEN},
                         {}),
    "linear_chain_crf [B, T, 1] labels, no lengths": (
        "linear_chain_crf", {"Emission": _r(2, 4, 3, seed=26),
                             "Transition": _r(5, 3, seed=27),
                             "Label": _ints(3, 2, 4, 1, seed=28)}, {}),
    "crf_decoding": ("crf_decoding", {"Emission": _r(3, 5, 4, seed=29),
                                      "Transition": _r(6, 4, seed=30),
                                      "Length": LEN}, {}),
    "chunk_eval": ("chunk_eval",
                   {"Inference": np.array([[0, 1, 1, 2, 3, 4],
                                           [4, 5, 0, 0, 2, 2],
                                           [1, 3, 5, 0, 0, 0]], "int64"),
                    "Label": np.array([[0, 1, 1, 2, 2, 4],
                                       [4, 5, 0, 1, 2, 3],
                                       [1, 3, 4, 4, 4, 4]], "int64"),
                    "SeqLength": LEN6},
                   {"chunk_scheme": "IOB", "num_chunk_types": 3}),
    # the CTC tier
    "warpctc": ("warpctc", {"Logits": _r(3, 6, 5, seed=31),
                            "Label": np.array([[1, 2, 0], [3, 3, 1],
                                               [0, 0, 0]], "int64"),
                            "LogitsLength": np.array([6, 5, 4], "int64"),
                            "LabelLength": np.array([2, 3, 0], "int64")},
                {"blank": 0}),
    "warpctc norm_by_times, the last class blank": (
        "warpctc", {"Logits": _r(2, 7, 4, seed=32),
                    "Label": np.array([[1, 1, 2], [0, 2, 3]], "int64")},
        {"blank": 3, "norm_by_times": True}),
    "ctc_align": ("ctc_align", {"Input": _ints(4, 3, 8, seed=33)},
                  {"blank": 0}),
    "ctc_align padding value": ("ctc_align",
                                {"Input": _ints(3, 2, 6, seed=34)},
                                {"blank": 2, "padding_value": -1}),
    "edit_distance": ("edit_distance",
                      {"Hyps": _ints(4, 3, 5, seed=35),
                       "Refs": _ints(4, 3, 4, seed=36),
                       "HypsLength": np.array([5, 2, 0], "int64"),
                       "RefsLength": np.array([4, 4, 1], "int64")}, {}),
    "edit_distance not normalized, no lengths": (
        "edit_distance", {"Hyps": _ints(3, 4, 9, seed=37),
                          "Refs": _ints(3, 4, 7, seed=38)},
        {"normalized": False}),
    # the heads and the text-matching convolutions
    "hierarchical_sigmoid": ("hierarchical_sigmoid",
                             {"X": _r(4, 5, seed=39), "W": _r(6, 5, seed=40),
                              "Bias": _r(1, 6, seed=41),
                              "Label": np.array([[0], [6], [3], [5]],
                                                "int64")},
                             {"num_classes": 7}),
    "im2sequence": ("im2sequence", {"X": _r(2, 3, 5, 6, seed=42)},
                    {"kernels": [3, 2], "strides": [2, 1],
                     "paddings": [1, 0, 0, 1]}),
    "match_matrix_tensor": ("match_matrix_tensor",
                            {"X": _r(2, 3, 4, seed=43),
                             "Y": _r(2, 5, 4, seed=44),
                             "W": _r(4, 2, 4, seed=45)}, {}),
    "var_conv_2d strided SAME": ("var_conv_2d",
                                 {"X": _r(2, 2, 5, 6, seed=46),
                                  "W": _r(3, 12, seed=47)},
                                 {"output_channel": 3, "input_channel": 2,
                                  "kernel_h": 3, "kernel_w": 2,
                                  "stride_h": 2, "stride_w": 3}),
    "tree_conv": ("tree_conv",
                  {"NodesVector": _r(2, 5, 3, seed=48),
                   "EdgeSet": np.array([[[0, 1], [0, 2], [1, 3], [1, 4]],
                                        [[0, 1], [1, 2], [0, 0], [0, 0]]],
                                       "int64"),
                   "Filter": _r(3, 2, 2, 4, seed=49)}, {}),
    # ops/misc_ops.py
    "center_loss": ("center_loss",
                    {"X": _r(5, 4, seed=50),
                     "Label": np.array([[0], [2], [2], [1], [0]], "int64"),
                     "Centers": _r(3, 4, seed=51),
                     "CenterUpdateRate": np.array([0.3], "float32")},
                    {"need_update": True}),
}

RANDOM_OPS = ("nce", "sample_logits")
NEW_OP_TYPES = {case[0] for case in OP_CASES.values()} | set(RANDOM_OPS)


def test_the_29_op_types_are_registered():
    from paddle_tpu.ops import registry as jreg
    assert len(NEW_OP_TYPES) == 29
    assert NEW_OP_TYPES <= set(treg.all_ops()) & set(jreg.all_ops())
    assert len(treg.all_ops()) == 488     # with detection, CTR, quant, fused, plumbing


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_matches_reference(case):
    op, ins, attrs = OP_CASES[case]
    ref, port = run_both(op, ins, attrs)
    if op == "crf_decoding":
        viterbi_check(ins["Emission"], ins["Transition"],
                      ref["ViterbiPath"][0], port["ViterbiPath"][0],
                      ins.get("Length"))
    else:
        assert_outputs_match(ref, port, RTOL, case)
    if treg.get_op(op).differentiable:
        check_generic_grad(op, ins, attrs, rtol=RTOL, ref=ref)


# --- the Viterbi paths ------------------------------------------------------
def viterbi_check(em, trans, want, got, length=None):
    """The rule of the module docstring; returns the number of rows whose
    paths were compared exactly."""
    em, trans = np.asarray(em), np.asarray(trans)
    want, got = np.asarray(want), np.asarray(got)
    assert got.shape == want.shape
    length = np.full(em.shape[0], em.shape[1]) if length is None \
        else np.asarray(length).reshape(-1)
    np.testing.assert_allclose(C._path_scores(em, trans, got, length),
                               C._path_scores(em, trans, want, length),
                               rtol=1e-5, atol=1e-5)
    clear = C._viterbi_margin(em, trans, length) > VITERBI_MARGIN
    np.testing.assert_array_equal(got[clear], want[clear])
    return int(clear.sum())


def test_viterbi_rows_are_held_exactly():
    """Every row of the ``crf_decoding`` case clears the margin, so its
    paths are compared exactly; a tie built on purpose is not."""
    _, ins, _ = OP_CASES["crf_decoding"]
    assert (C._viterbi_margin(ins["Emission"], ins["Transition"], LEN)
            > VITERBI_MARGIN).all()
    em = np.zeros((1, 3, 2), "float32")
    tr = np.zeros((4, 2), "float32")
    assert C._viterbi_margin(em, tr, [3])[0] == 0.0


# --- ground rule 5: the sampled heads ---------------------------------------
def _port(op, ins, attrs, seed=0):
    ctx = treg.LoweringContext(base_seed=seed)
    return treg.get_op(op).fn({k: [torch.from_numpy(np.asarray(v))]
                               for k, v in ins.items()}, dict(attrs), ctx)


def _log_sigmoid(v):
    return -np.logaddexp(0.0, -v)


NCE = ({"Input": _r(2000, 6, seed=52), "Weight": _r(20, 6, seed=53),
        "Bias": _r(20, seed=54),
        "Label": _ints(20, 2000, 1, seed=55)},
       {"num_total_classes": 20, "num_neg_samples": 10, "op_seed": 3})


def test_nce_contract():
    ins, attrs = NCE
    out = {k: v[0].numpy() for k, v in _port("nce", ins, attrs).items()}
    s = out["SampleLabels"]
    assert s.shape == (2000, 11)
    np.testing.assert_array_equal(s[:, :1], ins["Label"])
    neg = s[:, 1:]
    assert neg.min() >= 0 and neg.max() < 20
    hist = np.bincount(neg.reshape(-1), minlength=20)
    assert np.abs(hist - neg.size / 20).max() < 6 * np.sqrt(
        neg.size / 20 * (1 - 1 / 20))
    logits = np.einsum("bd,bsd->bs", ins["Input"], ins["Weight"][s]) \
        + ins["Bias"][s]
    np.testing.assert_allclose(out["SampleLogits"], logits, rtol=1e-5,
                               atol=1e-5)
    shifted = logits - np.log(10 / 20)
    lbl = np.arange(11)[None] < 1
    cost = -np.where(lbl, _log_sigmoid(shifted),
                     _log_sigmoid(-shifted)).sum(1, keepdims=True)
    np.testing.assert_allclose(out["Cost"], cost, rtol=1e-5, atol=1e-5)
    again = _port("nce", ins, attrs)["SampleLabels"][0].numpy()
    other = _port("nce", ins, dict(attrs, op_seed=4))["SampleLabels"][0]
    assert np.array_equal(again, s) and not np.array_equal(other.numpy(), s)


def test_nce_gradient_is_the_formulas():
    """``generic_grad`` of ``nce``'s Cost: dInput = Σ_s (σ(shifted) −
    true) · W[s] over the port's own samples (the vjp reruns the op on
    its seed, so the samples are the forward's)."""
    ins, attrs = NCE
    ins = {k: v[:64] if k in ("Input", "Label") else v
           for k, v in ins.items()}
    s = _port("nce", ins, attrs)["SampleLabels"][0].numpy()
    g = _r(64, 1, seed=56)
    gins = {"I_" + k: [torch.from_numpy(np.asarray(v))]
            for k, v in ins.items()}
    gins["G_Cost"] = [torch.from_numpy(g)]
    got = treg.get_op("generic_grad").fn(
        gins, {"fwd_type": "nce", "fwd_attrs": dict(attrs),
               "grad_slots": ["Input"], "in_slots": list(ins)},
        treg.LoweringContext(base_seed=0))["GI_Input"][0].numpy()
    logits = np.einsum("bd,bsd->bs", ins["Input"], ins["Weight"][s]) \
        + ins["Bias"][s]
    dlogit = (1 / (1 + np.exp(-(logits - np.log(10 / 20))))
              - (np.arange(11)[None] < 1)) * g
    want = np.einsum("bs,bsd->bd", dlogit, ins["Weight"][s])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_sample_logits_contract():
    """The true classes' columns are the reference's; the sampled ones
    the same formula over the port's own uniform samples."""
    ins = {"Logits": _r(500, 30, seed=57), "Labels": _ints(30, 500, 2,
                                                            seed=58)}
    attrs = {"num_samples": 8, "op_seed": 5}
    ref, port = run_both("sample_logits", ins, attrs)
    got = {k: v[0].numpy() for k, v in port.items()}
    np.testing.assert_allclose(got["SampledLogits"][:, :2],
                               np.asarray(ref["SampledLogits"][0])[:, :2],
                               rtol=1e-6)
    s = got["Samples"]
    np.testing.assert_array_equal(s[:, :2], ins["Labels"])
    neg = s[:, 2:]
    assert neg.min() >= 0 and neg.max() < 30
    hist = np.bincount(neg.reshape(-1), minlength=30)
    assert np.abs(hist - neg.size / 30).max() < 6 * np.sqrt(
        neg.size / 30 * (1 - 1 / 30))
    want = np.take_along_axis(ins["Logits"], s, 1) \
        - np.log(np.float32(1 / 30) * 8 + 1e-20)
    np.testing.assert_allclose(got["SampledLogits"], want, rtol=1e-6)
    for slot in ("Probabilities", "LogitsDim", "LabelsDim", "SampledLabels"):
        np.testing.assert_allclose(got[slot], np.asarray(ref[slot][0]),
                                   rtol=1e-6, err_msg=slot)
    other = _port("sample_logits", ins, dict(attrs, op_seed=6))["Samples"][0]
    assert not np.array_equal(other.numpy(), s)
