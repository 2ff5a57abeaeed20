"""Plumbing lowerings (counterpart of ``paddle_tpu/ops/plumbing_ops.py``,
the op paddle.tensor reaches)."""
from __future__ import annotations

import torch

from .registry import register_op


@register_op("is_empty", differentiable=False)
def _is_empty(ins, attrs, ctx):
    x = ins["X"][0]
    return {"Out": [torch.tensor(x.numel() == 0, device=x.device)]}
