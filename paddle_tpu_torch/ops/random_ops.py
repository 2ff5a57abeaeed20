"""Random-number ops over ``torch.Generator`` (counterpart of
``paddle_tpu/ops/random_ops.py``, the initializers' ops).

Each op instance carries a static ``op_seed`` assigned at graph-build
time; its generator is seeded from (step seed, op_seed) by
``LoweringContext.key_for``.  Torch and JAX draw different numbers from
the same seed: tests carry values across packages, never seeds.
"""
from __future__ import annotations

import torch

from ..fluid.framework import torch_dtype
from .registry import register_op


def _shape(ins, attrs):
    if ins.get("ShapeTensor"):
        return tuple(int(d) for d in ins["ShapeTensor"][0].tolist())
    return tuple(attrs["shape"])


def _dtype(attrs):
    d = attrs.get("dtype", "float32")
    return torch_dtype(d if d not in (None, -1) else "float32")


@register_op("uniform_random", stateful_rng=True, differentiable=False)
def _uniform_random(ins, attrs, ctx):
    gen = ctx.key_for(attrs.get("op_seed", attrs.get("seed", 0) or 0))
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    u = torch.rand(_shape(ins, attrs), generator=gen, device=ctx.device,
                   dtype=torch.float32)
    return {"Out": [(u * (hi - lo) + lo).to(_dtype(attrs))]}


@register_op("gaussian_random", stateful_rng=True, differentiable=False)
def _gaussian_random(ins, attrs, ctx):
    gen = ctx.key_for(attrs.get("op_seed", attrs.get("seed", 0) or 0))
    n = torch.randn(_shape(ins, attrs), generator=gen, device=ctx.device,
                    dtype=torch.float32)
    out = n * attrs.get("std", 1.0) + attrs.get("mean", 0.0)
    return {"Out": [out.to(_dtype(attrs))]}
