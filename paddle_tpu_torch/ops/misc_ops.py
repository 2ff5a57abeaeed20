"""Fused compositions and optimizer variants (counterpart of
``paddle_tpu/ops/misc_ops.py`` and ``paddle_tpu/ops/fused_extra_ops.py``):
the two ops the pairwise fusion passes make, each the plain composition
of its parts, and the ``adamax`` update."""
from __future__ import annotations

import torch

from .math import _bcast
from .registry import register_op

_UNARY = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
          "identity": lambda v: v, "": lambda v: v}
_BINARY = {"elementwise_add": torch.add, "elementwise_mul": torch.mul,
           "elementwise_sub": torch.sub}


@register_op("adamax", differentiable=False)
def _adamax(ins, attrs, ctx):
    """Adam under the infinity norm: ``u = max(b2·u, |g|)``, the step
    bias-corrected by ``Beta1Pow`` (which the caller advances)."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m, u = ins["Moment"][0], ins["InfNorm"][0]
    lr = ins["LearningRate"][0].reshape(())
    b1p = ins["Beta1Pow"][0].reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m2 = b1 * m + (1 - b1) * g
    u2 = torch.maximum(b2 * u, torch.abs(g))
    p2 = p - (lr / (1 - b1p)) * m2 / (u2 + eps)
    return {"ParamOut": [p2], "MomentOut": [m2], "InfNormOut": [u2]}


@register_op("fused_elemwise_activation")
def _fused_elemwise_activation(ins, attrs, ctx):
    """fused_elemwise_activation_op.cc: ``functor_list`` such as
    ['elementwise_add', 'relu'] applied as f2(f1(x, y)), honouring the
    elementwise ``axis``; IntermediateOut is f1's result."""
    x, y = _bcast(ins["X"][0], ins["Y"][0], attrs.get("axis", -1))
    functors = attrs.get("functor_list", ["elementwise_add", "relu"])
    cur = inter = None
    for f in functors:
        if f in _BINARY:
            cur = _BINARY[f](x, y) if cur is None else _BINARY[f](cur, y)
        else:
            name = f.replace("scale", "identity")
            cur = _UNARY.get(name, _UNARY["identity"])(
                cur if cur is not None else x)
        inter = cur if inter is None else inter
    return {"Out": [cur], "IntermediateOut": [inter]}


@register_op("fused_bn_activation",
             nondiff_inputs=("Mean", "Variance"),
             nondiff_outputs=("MeanOut", "VarianceOut", "SavedMean",
                              "SavedVariance"))
def _fused_bn_activation(ins, attrs, ctx):
    """fused_bn_activation_op.cc, what the ``fuse_bn_act`` pass makes of
    batch_norm + act: ``batch_norm``'s lowering, then ``act_type`` on Y."""
    from .registry import get_op
    outs = get_op("batch_norm").fn(ins, attrs, ctx)
    act = attrs.get("act_type", "relu")
    outs["Y"] = [_UNARY[act](outs["Y"][0])]
    return outs
