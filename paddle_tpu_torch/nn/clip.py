"""paddle.nn.clip (counterpart of ``paddle_tpu/nn/clip.py``): the fluid
gradient clips under their 2.0 names."""
from ..fluid.clip import (ClipGradByValue, ClipGradByNorm,
                          ClipGradByGlobalNorm, GradientClipByValue,
                          GradientClipByNorm, GradientClipByGlobalNorm,
                          ErrorClipByValue, set_gradient_clip)
from ..fluid.layers import clip_by_norm

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "ErrorClipByValue",
           "set_gradient_clip", "clip_by_norm"]
