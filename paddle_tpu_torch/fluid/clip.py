"""Gradient clipping (counterpart of ``paddle_tpu/fluid/clip.py``):
``GradientClipByValue``, ``GradientClipByNorm`` and
``GradientClipByGlobalNorm``, each a callable over ``[(param, grad)]``
that appends the clipping ops and returns the clipped pairs, their
eager formulas over gradient tensors (``clip_eager``), and their 2.0
names."""
from __future__ import annotations

import torch

from . import layers


class GradientClipBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class GradientClipByValue(GradientClipBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        return [(p, layers.clip(g, self.min, self.max) if g is not None else g)
                for p, g in params_grads]


class GradientClipByNorm(GradientClipBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        return [(p, layers.clip_by_norm(g, self.clip_norm)
                 if g is not None else g) for p, g in params_grads]


class GradientClipByGlobalNorm(GradientClipBase):
    """Every grad times ``clip_norm / max(global_norm, clip_norm)``, the
    global norm taken over all grads together."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        sq = [layers.reduce_sum(layers.square(g)) for _, g in params_grads
              if g is not None]
        if not sq:
            return params_grads
        global_norm = layers.sqrt(layers.sums(sq))
        max_norm = layers.fill_constant([1], "float32", self.clip_norm)
        scale = layers.elementwise_div(
            max_norm, layers.elementwise_max(global_norm, max_norm))
        return [(p, layers.elementwise_mul(g, scale) if g is not None else g)
                for p, g in params_grads]


def clip_eager(clip, grads):
    """``clip``'s formula applied eagerly to a list of gradient tensors
    (the dygraph optimizers' path), in the given order; the global norm
    sums the squares parameter by parameter in that order."""
    if isinstance(clip, GradientClipByGlobalNorm):
        norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
        scale = clip.clip_norm / torch.clamp(norm, min=clip.clip_norm)
        return [g * scale for g in grads]
    if isinstance(clip, GradientClipByNorm):
        out = []
        for g in grads:
            n = torch.sqrt(torch.sum(torch.square(g)))
            out.append(torch.where(n > clip.clip_norm,
                                   g * (clip.clip_norm / n), g))
        return out
    if isinstance(clip, GradientClipByValue):
        return [torch.clamp(g, clip.min, clip.max) for g in grads]
    return None


# legacy API names
set_gradient_clip = None
ErrorClipByValue = GradientClipByValue

# 2.0 names for the same classes
ClipGradByValue = GradientClipByValue
ClipGradByNorm = GradientClipByNorm
ClipGradByGlobalNorm = GradientClipByGlobalNorm
