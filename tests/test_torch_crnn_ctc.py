"""CRNN-CTC (``chip_smoke.crnn_program``, the phase 4t model:
``ocr_recognition``'s convolution tower, ``im2sequence``, a forward and
a reverse ``dynamic_gru``, ``warpctc``, ``ctc_greedy_decoder`` and
``edit_distance``) in both packages at [2, 1, 16, 32], channels 4 to 8,
hidden 8 and 5 classes.  From the reference's initial values with the
batch-norm scales set to 1 in both (the model's N(0, 0.01) scales leave
the features near 1e-10, where the logits would not see the images), two
Momentum steps: each step's CTC loss within rtol 1e-4, the logits within
rtol 1e-4 of their largest value, the first step's gradients within
rtol 1e-4 of the largest gradient (the biases of the convolutions ahead
of a batch norm have an analytic gradient of 0, the norm taking out the
mean, so theirs are float32 noise near 1e-6 in both packages), the
decoded rows, their lengths and the edit distances equal where every
step's best class beats the runner-up by more than 1e-3.  Then the CTC
tier's extra checks: ``warpctc`` against ``F.ctc_loss``, the
``cummin`` edit distance against the textbook table, ``im2sequence``'s
channel-major features.
"""
import numpy as np
import torch

import jax

import chip_smoke as C

from paddle_tpu_torch.ops import registry as treg

from test_torch_rnn_ops import _close, _programs
from test_torch_sequence_ops import OP_CASES, _ints, _port, run_both

jax.config.update("jax_platforms", "cpu")

CRNN = dict(C.CRNN, classes=5, channels=(4, 4, 8, 8), hidden=8, height=16,
            width=32, min_label=1, max_label=2)
BATCH = 2
RTOL = 1e-4
ARGMAX_MARGIN = 1e-3


def _crnn(fluid):
    loss, dec, dec_len, dist, greedy, pg = C.crnn_program(fluid, CRNN, BATCH)
    logits = [op for op in fluid.default_main_program().global_block().ops
              if op.type == "warpctc"][0].inputs["Logits"][0]
    logits = fluid.default_main_program().global_block().var(logits)
    return [loss, logits, dec, dec_len, dist, greedy] + [
        g for _, g in sorted(pg, key=lambda t: t[0].name)]


def _unit_bn_scales(main, values):
    for op in main.global_block().ops:
        if op.type == "batch_norm":
            name = op.inputs["Scale"][0]
            values[name] = np.ones_like(values[name])
    return values


def test_crnn_ctc_matches_reference():
    run = _programs(_crnn, prepare=_unit_bn_scales)
    held = 0
    for step in range(2):
        feed = C.crnn_feed(CRNN, BATCH, 200 + step)
        ref, port = run(feed)
        _close(port[:2], ref[:2], f"step {step}: loss, logits", RTOL)
        top2 = np.sort(ref[1], axis=-1)[..., -2:]
        clear = ((top2[..., 1] - top2[..., 0]) > ARGMAX_MARGIN).all(1)
        for i, what in ((2, "decoded rows"), (3, "their lengths"),
                        (4, "edit distances")):
            np.testing.assert_array_equal(
                port[i].reshape(BATCH, -1)[clear],
                np.asarray(ref[i]).reshape(BATCH, -1)[clear], what)
        np.testing.assert_array_equal(port[5], port[2])  # the builder's rows
        held += int(clear.sum())
        if step == 0:
            top = max(float(np.abs(g).max()) for g in ref[6:])
            for i, (g, w) in enumerate(zip(port[6:], ref[6:])):
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * top,
                                           err_msg=f"gradient {i}")
    assert held >= BATCH          # 2 of the 4 rows clear the margin


def test_ctc_empty_label_and_all_blank_path():
    """An empty label's loss is the all-blank path's, -Σ log p(blank):
    not the doubled gather's (+ln 2)."""
    logits = np.random.RandomState(59).randn(1, 4, 3).astype("float32")
    ins = {"Logits": logits, "Label": np.zeros((1, 2), "int64"),
           "LabelLength": np.array([0], "int64")}
    out = _port("warpctc", ins, {"blank": 0})
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    np.testing.assert_allclose(out["Loss"][0].numpy(),
                               [[-logp[0, :, 0].sum()]], rtol=1e-5)
    assert not out["WarpCTCGrad"][0].numpy().any()


def test_warpctc_against_torch_ctc_loss():
    """The op's loss is ``F.ctc_loss``'s with ``reduction='none'`` on the
    same log-probabilities (time-major there), and so is its gradient at
    every step within a row's length (torch's gradient past it is not
    zero)."""
    ins = OP_CASES["warpctc"][1]
    logits = torch.from_numpy(ins["Logits"]).requires_grad_()
    loss = treg.get_op("warpctc").fn(
        {"Logits": [logits], "Label": [torch.from_numpy(ins["Label"])],
         "LogitsLength": [torch.from_numpy(ins["LogitsLength"])],
         "LabelLength": [torch.from_numpy(ins["LabelLength"])]},
        {"blank": 0}, treg.LoweringContext())["Loss"][0]
    lib = torch.nn.functional.ctc_loss(
        torch.log_softmax(logits, -1).transpose(0, 1),
        torch.from_numpy(ins["Label"]),
        torch.from_numpy(ins["LogitsLength"]),
        torch.from_numpy(ins["LabelLength"]), blank=0, reduction="none")
    np.testing.assert_allclose(loss.detach().numpy().reshape(-1),
                               lib.detach().numpy(), rtol=1e-5)
    g1, = torch.autograd.grad(loss.sum(), logits)
    g2, = torch.autograd.grad(lib.sum(), logits)
    valid = np.arange(6)[None] < ins["LogitsLength"][:, None]
    np.testing.assert_allclose(g1.numpy()[valid], g2.numpy()[valid],
                               rtol=1e-4, atol=1e-6)
    assert not g1.numpy()[~valid].any()


def test_edit_distance_against_a_plain_table():
    """The ``cummin`` row against the textbook Levenshtein table."""
    hyp, ref = _ints(5, 6, 9, seed=60), _ints(5, 6, 7, seed=61)
    hl, rl = np.array([9, 4, 0, 7, 1, 3]), np.array([7, 7, 2, 0, 5, 1])
    out = _port("edit_distance", {"Hyps": hyp, "Refs": ref, "HypsLength": hl,
                                  "RefsLength": rl},
                {"normalized": False})["Out"][0].numpy().reshape(-1)
    for i in range(6):
        a, b = hyp[i, :hl[i]], ref[i, :rl[i]]
        d = np.arange(len(b) + 1)
        for x in a:
            nd = [d[0] + 1]
            for j in range(1, len(b) + 1):
                nd.append(min(d[j] + 1, nd[-1] + 1,
                              d[j - 1] + (b[j - 1] != x)))
            d = np.array(nd)
        assert out[i] == d[-1], i


def test_im2sequence_is_channel_major():
    """A filter taller than wide: the features are (C, kh, kw), as
    ``F.unfold`` and XLA's patches order them."""
    x = np.arange(2 * 2 * 3 * 2, dtype="float32").reshape(2, 2, 3, 2)
    out = _port("im2sequence", {"X": x}, {"kernels": [3, 1]})["Out"][0]
    assert out.shape == (4, 6)
    np.testing.assert_array_equal(out[0].numpy(), x[0, :, :, 0].reshape(-1))
    ref, port = run_both("im2sequence", {"X": x}, {"kernels": [3, 1]})
    np.testing.assert_array_equal(port["Out"][0].numpy(),
                                  np.asarray(ref["Out"][0]))
