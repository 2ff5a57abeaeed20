"""Detection lowerings (counterpart of ``paddle_tpu/ops/detection_ops.py``,
the two the image layers reach): ``affine_grid``, the sampling grid of
an affine transform, and ``sigmoid_focal_loss``.  The rest of the module
is ROADMAP queue A item 8's."""
from __future__ import annotations

import torch

from .registry import register_op


@register_op("affine_grid")
def _affine_grid(ins, attrs, ctx):
    """``Theta [B, 2, 3]`` to the grid ``[B, H, W, 2]`` of the points
    ``theta · (x, y, 1)`` over [-1, 1]², corners aligned; the shape from
    ``output_shape`` or the ``OutputShape`` input."""
    theta = ins["Theta"][0]
    shape = attrs.get("output_shape", None)
    if shape is None and ins.get("OutputShape"):
        shape = [int(v) for v in ins["OutputShape"][0].reshape(-1).tolist()]
    _, _, h, w = shape
    ys = torch.linspace(-1.0, 1.0, h, device=theta.device)
    xs = torch.linspace(-1.0, 1.0, w, device=theta.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1)
    return {"Output": [torch.einsum("hwk,bak->bhwa", base.to(theta.dtype),
                                    theta)]}


@register_op("sigmoid_focal_loss", nondiff_inputs=("Label", "FgNum"))
def _sigmoid_focal_loss(ins, attrs, ctx):
    """``-α (1 - p)^γ log p`` one class against the rest (label ``c`` in
    [0, C], 0 the background, -1 a row left out), over ``max(FgNum,
    1)``."""
    x = ins["X"][0]
    label = ins["Label"][0].to(torch.int64).reshape(-1)
    fg = (ins["FgNum"][0].reshape(()).to(x.dtype) if ins.get("FgNum")
          else torch.ones((), dtype=x.dtype, device=x.device))
    gamma = attrs.get("gamma", 2.0)
    alpha = attrs.get("alpha", 0.25)
    c = x.shape[1]
    target = label[:, None] == (torch.arange(c, device=x.device) + 1)[None]
    valid = (label[:, None] != -1).to(x.dtype)
    p = torch.sigmoid(x)
    pt = torch.where(target, p, 1 - p)
    at = torch.where(target, alpha, 1 - alpha)
    bce = -torch.where(target, torch.nn.functional.logsigmoid(x),
                       torch.nn.functional.logsigmoid(-x))
    loss = valid * at * ((1 - pt) ** gamma) * bce / torch.clamp(fg, min=1.0)
    return {"Out": [loss]}
