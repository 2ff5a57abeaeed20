"""paddle.vision.ops (counterpart of ``paddle_tpu/vision/ops.py``): the
detection builders re-exported from the fluid layers, the
``DeformConv2D`` class and the fixed-k ``batched_nms`` that stands in for
the data-shaped ``multiclass_nms``."""
from __future__ import annotations

import torch

from ..fluid import layers as _L
from ..fluid.layers.detection import yolo_box
from ..fluid.layers import deformable_conv as deform_conv2d
from ..dygraph.layers import Layer
from ..fluid.layer_helper import LayerHelper

__all__ = ["yolo_loss", "yolo_box", "deform_conv2d", "DeformConv2D",
           "batched_nms"]


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    return _L.yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask,
                          class_num, ignore_thresh, downsample_ratio,
                          gt_score=gt_score,
                          use_label_smooth=use_label_smooth, name=name)


def _pair(v):
    return [v] * 2 if isinstance(v, int) else list(v)


class DeformConv2D(Layer):
    """The 2.0 class over the deformable convolution: ``deformable_conv``
    with a mask, ``deformable_conv_v1`` without."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        helper = LayerHelper("deform_conv2d")
        self.weight = helper.create_parameter(
            weight_attr, [out_channels, in_channels // groups]
            + _pair(kernel_size), "float32")
        self.bias = helper.create_parameter(
            bias_attr, [out_channels], "float32", is_bias=True) \
            if bias_attr is not False else None
        self._cfg = dict(stride=stride, padding=padding, dilation=dilation,
                         deformable_groups=deformable_groups, groups=groups)

    def forward(self, x, offset, mask=None):
        from ..fluid.layer_helper import emit_op
        c = self._cfg
        ins = {"Input": [x], "Offset": [offset], "Filter": [self.weight]}
        if mask is not None:
            ins["Mask"] = [mask]
        out = emit_op(
            "deform_conv2d",
            "deformable_conv" if mask is not None else "deformable_conv_v1",
            ins, ("Output",),
            {"strides": _pair(c["stride"]), "paddings": _pair(c["padding"]),
             "dilations": _pair(c["dilation"]), "groups": c["groups"],
             "deformable_groups": c["deformable_groups"],
             "im2col_step": 1})["Output"][0]
        if self.bias is not None:
            out = _L.elementwise_add(out, self.bias, axis=1)
        return out


def batched_nms(boxes, scores, iou_threshold=0.5, top_k=100,
                max_outputs=None):
    """Greedy NMS with a fixed-size answer: the indices of the surviving
    boxes, best first, padded with -1 to exactly ``top_k`` (int64).
    ``max_outputs`` is the older keyword for ``top_k``.  The suppression
    runs box by box, as the reference's loop does, without reading a
    value on the host."""
    if max_outputs is not None:
        top_k = max_outputs
    boxes = torch.as_tensor(getattr(boxes, "_value", boxes))
    scores = torch.as_tensor(getattr(scores, "_value", scores))
    n, dev = boxes.shape[0], boxes.device
    if n == 0:
        return torch.full((top_k,), -1, dtype=torch.int64, device=dev)
    order = torch.argsort(-scores, stable=True)
    b = boxes[order]
    area = torch.clamp(b[:, 2] - b[:, 0], min=0) \
        * torch.clamp(b[:, 3] - b[:, 1], min=0)
    lt = torch.maximum(b[:, None, :2], b[None, :, :2])
    rb = torch.minimum(b[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    iou = inter / torch.clamp(area[:, None] + area[None, :] - inter,
                              min=1e-9)
    earlier = torch.tril(torch.ones((n, n), dtype=torch.bool, device=dev),
                         diagonal=-1)
    over = earlier & (iou > iou_threshold)
    keep = torch.ones((n,), dtype=torch.bool, device=dev)
    for i in range(n):
        keep[i] = keep[i] & ~torch.any(over[i] & keep)
    idx = torch.arange(n, device=dev)
    kept = torch.sort(torch.where(keep, idx, n)).values
    padded = torch.cat([kept, torch.full((max(top_k - n, 0),), n,
                                         dtype=kept.dtype, device=dev)])
    padded = padded[:top_k]
    return torch.where(padded < n, order[torch.clamp(padded, max=n - 1)],
                       torch.full((), -1, dtype=torch.int64, device=dev))
