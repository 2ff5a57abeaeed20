"""The book's semantic role labeller (``chip_smoke.srl_program``, the
phase 4t model: ``db_lstm`` through ``linear_chain_crf``,
``crf_decoding`` and ``chunk_eval``) in both packages at a small width:
depth 3, hidden 32, a 200-word dictionary, 9 labels, 4 sentences padded
to 10 with lengths from the seed.  From the reference's initial values,
three SGD steps: each step's CRF loss within rtol 1e-4, the first step's
gradients within rtol 1e-4 of each one's largest value, the Viterbi
paths under ``test_torch_sequence_ops.viterbi_check``'s margin rule and
``chunk_eval``'s outputs equal.
"""
import numpy as np

import jax

import chip_smoke as C

from test_torch_rnn_ops import _close, _programs
from test_torch_sequence_ops import viterbi_check

jax.config.update("jax_platforms", "cpu")

SRL = dict(C.SRL, words=200, preds=30, labels=9, hidden=32, depth=3)
BATCH, STEPS = 4, 10
RTOL = 1e-4


def _srl(fluid):
    loss, emission, path, chunks, pg = C.srl_program(fluid, SRL, BATCH,
                                                     STEPS)
    crfw = fluid.default_main_program().global_block().var("crfw")
    return [loss, emission, path, crfw] + list(chunks) + [
        g for _, g in sorted(pg, key=lambda t: t[0].name)]


def test_srl_matches_reference():
    run = _programs(_srl)
    held = 0
    for step in range(3):
        feed = C.srl_feed(SRL, BATCH, STEPS, 100 + step)
        feed["length"] = np.minimum(feed["length"], STEPS)
        ref, port = run(feed)
        _close(port[:2], ref[:2], f"step {step}: loss, emission", RTOL)
        held += viterbi_check(ref[1], ref[3], ref[2], port[2],
                              feed["length"])
        for i in range(4, 10):                       # chunk_eval's six
            np.testing.assert_allclose(port[i], np.asarray(ref[i]),
                                       rtol=1e-6, err_msg=f"chunk {i}")
        if step == 0:
            _close(port[10:], ref[10:], "first step's gradients", RTOL)
    # every row of the three steps is held exactly (none is near a tie)
    assert held == 3 * BATCH
