"""Catalog-tail lowerings (counterpart of
``paddle_tpu/ops/catalog_tail_ops.py``, the op paddle.tensor reaches)."""
from __future__ import annotations

import torch

from .registry import register_op


@register_op("equal_all", differentiable=False)
def _equal_all(ins, attrs, ctx):
    """One bool: same shape and every element equal."""
    x, y = ins["X"][0], ins["Y"][0]
    if x.shape != y.shape:
        return {"Out": [torch.tensor(False, device=x.device)]}
    return {"Out": [torch.all(torch.eq(x, y))]}
