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


# the 2.0 surface (paddle.tensor's random functions): each draws from a
# generator keyed by its op's seed on the op's device, so a test holds
# them to a contract (range, shape, dtype, frequencies), not to the
# reference's bits
@register_op("truncated_gaussian_random", stateful_rng=True,
             differentiable=False)
def _truncated_gaussian(ins, attrs, ctx):
    """N(0, 1) cut to [-2, 2] by inverse-CDF sampling of the uniform
    between the two bounds' CDF values."""
    gen = ctx.key_for(attrs.get("op_seed", attrs.get("seed", 0) or 0))
    lo = 0.5 * (1 + torch.erf(torch.tensor(-2.0 / 2 ** 0.5)))
    u = torch.rand(tuple(attrs["shape"]), generator=gen, device=ctx.device,
                   dtype=torch.float64)
    p = lo.item() + u * (1 - 2 * lo.item())
    n = (2 ** 0.5 * torch.erfinv(2 * p - 1)).clamp(-2.0, 2.0).float()
    out = n * attrs.get("std", 1.0) + attrs.get("mean", 0.0)
    return {"Out": [out.to(_dtype(attrs))]}


@register_op("randint", stateful_rng=True, differentiable=False)
def _randint(ins, attrs, ctx):
    gen = ctx.key_for(attrs.get("op_seed", attrs.get("seed", 0) or 0))
    out = torch.randint(attrs.get("low", 0), attrs["high"],
                        _shape(ins, attrs), generator=gen,
                        device=ctx.device)
    return {"Out": [out.to(torch_dtype(attrs.get("dtype") or "int64"))]}


@register_op("randperm", stateful_rng=True, differentiable=False)
def _randperm(ins, attrs, ctx):
    gen = ctx.key_for(attrs.get("op_seed", attrs.get("seed", 0) or 0))
    out = torch.randperm(attrs["n"], generator=gen, device=ctx.device)
    return {"Out": [out.to(torch_dtype(attrs.get("dtype") or "int64"))]}


@register_op("bernoulli", stateful_rng=True, differentiable=False)
def _bernoulli(ins, attrs, ctx):
    x = ins["X"][0]
    gen = ctx.key_for(attrs.get("op_seed", 0))
    u = torch.rand(x.shape, generator=gen, device=x.device,
                   dtype=torch.float32)
    return {"Out": [(u < x).to(x.dtype)]}


@register_op("multinomial", stateful_rng=True, differentiable=False)
def _multinomial(ins, attrs, ctx):
    x = ins["X"][0]
    gen = ctx.key_for(attrs.get("op_seed", 0))
    return {"Out": [torch.multinomial(
        x.float(), attrs.get("num_samples", 1),
        replacement=attrs.get("replacement", False), generator=gen)]}
