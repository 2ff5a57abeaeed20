"""NLP ops (counterpart of ``paddle_tpu/ops/nlp_ops.py``; this module
holds the beam-search three: ``beam_search``, ``gather_tree`` and
``beam_search_decode``).

Beams are dense: a step's scores are [B · beam, V] and a decoded
history is [T, B, beam].  Ids are int64 (the reference narrows them to
int32 through ``wide_int``).
"""
from __future__ import annotations

import torch

from .registry import register_op

_NEG = -1e30


@register_op("beam_search", nondiff_inputs=("pre_ids", "pre_scores", "ids",
                                            "scores"), differentiable=False)
def _beam_search(ins, attrs, ctx):
    """One step of beam_search_op.cc: ``scores`` [B · beam, V] of this
    step (with ``is_accumulated``, the default, already the prefix's sum;
    otherwise probabilities, whose logs are added to ``pre_scores``); a
    beam whose last id is ``end_id`` keeps only ``end_id`` at its own
    score.  The top ``beam_size`` (id, score) of each source sentence,
    and each one's parent row."""
    pre_ids = ins["pre_ids"][0].reshape(-1)
    pre_scores = ins["pre_scores"][0].reshape(-1, 1)
    scores = ins["scores"][0]
    beam = attrs.get("beam_size", 4)
    end_id = attrs.get("end_id", 1)
    nb, v = scores.shape
    src = nb // beam
    cand = scores if attrs.get("is_accumulated", True) \
        else torch.log(scores.clamp(min=1e-20)) + pre_scores
    is_end = torch.arange(v, device=scores.device)[None] == end_id
    kept = torch.where(is_end, pre_scores, torch.full_like(cand, _NEG))
    cand = torch.where((pre_ids == end_id)[:, None], kept, cand)
    top_scores, top_idx = torch.topk(cand.reshape(src, beam * v), beam)
    parent = top_idx // v + torch.arange(src, device=scores.device)[:, None] \
        * beam
    return {"selected_ids": [(top_idx % v).reshape(-1, 1)],
            "selected_scores": [top_scores.reshape(-1, 1)],
            "parent_idx": [parent.reshape(-1)]}


def _backtrace(ids, parents):
    """gather_tree_op.cc over ``ids`` and ``parents`` [T, B, beam]: from
    the last step back, each beam's token and then its parent's beam."""
    beam_idx = torch.arange(ids.shape[2], device=ids.device) \
        .expand(ids.shape[1:])
    toks = [None] * ids.shape[0]
    for t in range(ids.shape[0] - 1, -1, -1):
        toks[t] = torch.gather(ids[t], 1, beam_idx)
        beam_idx = torch.gather(parents[t].long(), 1, beam_idx)
    return torch.stack(toks)


@register_op("gather_tree", differentiable=False)
def _gather_tree(ins, attrs, ctx):
    """The full sequences [T, B, beam] that end at each last-step beam."""
    return {"Out": [_backtrace(ins["Ids"][0].long(), ins["Parents"][0])]}


@register_op("beam_search_decode", differentiable=False)
def _beam_search_decode(ins, attrs, ctx):
    """beam_search_decode_op.cc made dense: ``Ids`` and ``ParentIdx``
    stacked [T, B, beam], backtraced as ``gather_tree`` does;
    ``SentenceScores`` is ``Scores`` where given."""
    res = {"SentenceIds": [_backtrace(ins["Ids"][0].long(),
                                      ins["ParentIdx"][0])]}
    if ins.get("Scores"):
        res["SentenceScores"] = [ins["Scores"][0]]
    return res
