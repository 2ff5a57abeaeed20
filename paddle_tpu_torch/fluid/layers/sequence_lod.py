"""Sequence ops without LoD: padded batches and explicit lengths
(counterpart of ``paddle_tpu/fluid/layers/sequence_lod.py``, the
``sequence_pool`` op and its layer).

A batch of sequences is a dense ``[batch, max_len, ...]`` tensor plus an
optional ``Length`` int tensor; the op masks the positions past each
row's length.  As in the reference, the op lowering lives beside its
layer.
"""
from __future__ import annotations

import torch

from ...ops.registry import register_op
from ..framework import in_dygraph_mode
from ..layer_helper import LayerHelper


def _mask(length, max_len, dtype):
    pos = torch.arange(max_len, device=length.device)
    return (pos[None, :] < length.reshape(-1, 1)).to(dtype)


@register_op("sequence_pool", nondiff_inputs=("Length",))
def _sequence_pool(ins, attrs, ctx):
    """x: [B, T, D] padded; Length: [B].  pooltype SUM / AVERAGE / SQRT /
    MAX / LAST / FIRST (sequence_pool_op.h semantics, padded layout)."""
    x = ins["X"][0]
    ptype = attrs.get("pooltype", "SUM").upper()
    if ins.get("Length"):
        length = ins["Length"][0]
        m = _mask(length, x.shape[1], x.dtype)[..., None]
    else:
        length = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                            device=x.device)
        m = torch.ones(x.shape[:2] + (1,), dtype=x.dtype, device=x.device)
    if ptype == "SUM":
        out = torch.sum(x * m, dim=1)
    elif ptype == "AVERAGE":
        out = torch.sum(x * m, dim=1) / torch.clamp(
            length.reshape(-1, 1).to(x.dtype), min=1)
    elif ptype == "SQRT":
        out = torch.sum(x * m, dim=1) / torch.sqrt(torch.clamp(
            length.reshape(-1, 1).to(x.dtype), min=1))
    elif ptype == "MAX":
        out = torch.amax(torch.where(m > 0, x, -torch.inf), dim=1)
        out = torch.where(torch.isfinite(out), out, 0.0)
    elif ptype == "LAST":
        idx = torch.clamp(length - 1, min=0).long()
        idx = idx.reshape(-1, 1, *([1] * (x.ndim - 2)))
        out = torch.take_along_dim(
            x, idx.expand(-1, 1, *x.shape[2:]), dim=1).squeeze(1)
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise NotImplementedError(f"sequence_pool type {ptype}")
    return {"Out": [out],
            "MaxIndex": [torch.zeros((1,), dtype=torch.int32,
                                     device=x.device)]}


def sequence_pool(input, pool_type="sum", length=None, is_test=False):
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    mi = helper.create_variable_for_type_inference(dtype="int32",
                                                   stop_gradient=True)
    inputs = {"X": [input]}
    if length is not None:
        inputs["Length"] = [length]
    op = helper.append_op("sequence_pool", inputs=inputs,
                          outputs={"Out": [out], "MaxIndex": [mi]},
                          attrs={"pooltype": pool_type.upper()})
    return op["Out"][0] if in_dygraph_mode() else out
