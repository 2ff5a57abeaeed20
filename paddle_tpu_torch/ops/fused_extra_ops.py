"""The CTR rows of the fused op catalog (counterpart of
``paddle_tpu/ops/fused_extra_ops.py``): ``fused_embedding_seq_pool``,
``fusion_seqpool_concat``, ``fusion_seqpool_cvm_concat``,
``scaled_int8fc`` and ``fused_seqpool_cvm_with_pcoc``, each the plain
composition of its parts, as in the reference.  The rest of that module
waits in ROADMAP queue A item 8's table.

As in the reference: ``fused_embedding_seq_pool`` never reads
``padding_idx``; the two CVM variants apply no log transform, they only
strip the leading columns when ``use_cvm`` is off.
"""
from __future__ import annotations

import torch

from .ctr_ops import _GatherRows
from .detection_ops import true_div
from .registry import register_op


def _p(ins, slot):
    return ins[slot][0]


@register_op("fused_embedding_seq_pool", nondiff_inputs=("Ids",))
def _fused_embedding_seq_pool(ins, attrs, ctx):
    """The rows of W summed (or averaged) a row of ids; the gather's
    gradient sums repeats in a fixed order (``_GatherRows``)."""
    w, ids = _p(ins, "W"), _p(ins, "Ids")
    emb = _GatherRows.apply(w, ids.reshape(ids.shape[0], -1).long())
    if attrs.get("combiner", "sum") == "sum":
        return {"Out": [torch.sum(emb, dim=1)]}
    return {"Out": [torch.mean(emb, dim=1)]}


@register_op("fusion_seqpool_concat")
def _fusion_seqpool_concat(ins, attrs, ctx):
    pool = attrs.get("pooltype", "SUM").upper()

    def red(x):
        if pool == "AVERAGE":
            return torch.mean(x, dim=1)
        if pool == "MAX":
            return torch.amax(x, dim=1)
        if pool == "SQRT":                 # sum / sqrt(len)
            return torch.sum(x, dim=1) / float(x.shape[1]) ** 0.5
        return torch.sum(x, dim=1)

    return {"Out": [torch.cat([red(x) if x.ndim == 3 else x
                               for x in ins["X"]], dim=-1)]}


@register_op("fusion_seqpool_cvm_concat")
def _fusion_seqpool_cvm_concat(ins, attrs, ctx):
    outs = [torch.sum(x, dim=1) if x.ndim == 3 else x for x in ins["X"]]
    if not attrs.get("use_cvm", True):
        outs = [x[:, 2:] for x in outs]   # show and click stripped
    return {"Out": [torch.cat(outs, dim=-1)]}


@register_op("scaled_int8fc")
def _scaled_int8fc(ins, attrs, ctx):
    """scaled_int8fc: the int8 product simulated in float32, the inputs
    and weights divided by their scales (rounded once, as the host
    rounds: ``true_div``), rounded half to even and clipped to [-127,
    127]."""
    x, w = _p(ins, "Input"), _p(ins, "W")
    sx = attrs.get("input_scale", 1.0)
    sw = attrs.get("weight_scale", 1.0)
    qx = torch.clamp(torch.round(true_div(x, sx)), -127, 127)
    qw = torch.clamp(torch.round(true_div(w, sw)), -127, 127)
    out = (qx @ qw) * (sx * sw)
    if ins.get("Bias"):
        out = out + ins["Bias"][0]
    return {"Out": [out]}


@register_op("fused_seqpool_cvm_with_pcoc")
def _fused_seqpool_cvm_with_pcoc(ins, attrs, ctx):
    outs = []
    for x in ins["X"]:
        pooled = torch.sum(x, dim=1) if x.ndim == 3 else x
        if not attrs.get("use_cvm", True):
            pooled = pooled[:, 3:]        # show, click and pcoc stripped
        outs.append(pooled)
    return {"Out": outs}
