"""Neural-net lowerings (counterpart of ``paddle_tpu/ops/nn_ops.py``, the
ops this slice runs)."""
from __future__ import annotations

import torch

from .registry import register_op


def bernoulli_keep(gen, shape, keep_prob, device):
    """Keep-mask drawn from ``gen``: uniform < keep_prob, as
    ``jax.random.bernoulli`` spells it.  On the meta device (shape
    inference) nothing is drawn."""
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.bool, device=device)
    u = torch.rand(shape, generator=gen, device=device)
    return u < keep_prob


@register_op("softmax")
def _softmax(ins, attrs, ctx):
    return {"Out": [torch.softmax(ins["X"][0], dim=attrs.get("axis", -1))]}


@register_op("dropout", stateful_rng=True, nondiff_outputs=("Mask",))
def _dropout(ins, attrs, ctx):
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    is_test = attrs.get("is_test", False) or ctx.is_test
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    ones = torch.ones_like(x, dtype=torch.uint8)
    if is_test:
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        return {"Out": [out], "Mask": [ones]}
    if p <= 0.0:
        return {"Out": [x], "Mask": [ones]}
    if p >= 1.0:        # everything dropped; also guards 1/(1-p) below
        return {"Out": [torch.zeros_like(x)],
                "Mask": [torch.zeros_like(x, dtype=torch.uint8)]}
    gen = ctx.key_for(attrs.get("op_seed", attrs.get("seed", 0) or 0))
    keep = bernoulli_keep(gen, x.shape, 1.0 - p, x.device)
    kept = x / (1.0 - p) if impl == "upscale_in_train" else x
    out = torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                              device=x.device))
    return {"Out": [out], "Mask": [keep.to(torch.uint8)]}
