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


# the 2.0 surface (paddle.tensor's tail)
@register_op("unique", differentiable=False)
def _unique(ins, attrs, ctx):
    """unique_op.cc with a static shape: the sorted unique values padded
    with 0 to the input's length, the inverse index (int32) and the
    count of unique values."""
    x = ins["X"][0].reshape(-1)
    u, inverse = torch.unique(x, sorted=True, return_inverse=True)
    out = torch.zeros_like(x)
    out[:u.numel()] = u
    return {"Out": [out], "Index": [inverse.to(torch.int32)],
            "UniqueCount": [torch.tensor([u.numel()], dtype=torch.int32,
                                         device=x.device)]}


@register_op("multiplex", nondiff_inputs=("Ids",))
def _multiplex(ins, attrs, ctx):
    """Row r of the output is row r of candidate ``X[Ids[r]]``."""
    ids = ins["Ids"][0].long().reshape(-1)
    stacked = torch.stack(ins["X"], dim=0)
    return {"Out": [stacked[ids, torch.arange(ids.shape[0],
                                              device=ids.device)]]}


@register_op("scatter_nd", nondiff_inputs=("Index", "Shape"))
def _scatter_nd(ins, attrs, ctx):
    idx, upd = ins["Index"][0], ins["Updates"][0]
    shape = [int(v) for v in ins["Shape"][0].tolist()] \
        if ins.get("Shape") else list(attrs["shape"])
    out = torch.zeros(shape, dtype=upd.dtype, device=upd.device)
    return {"Out": [out.index_put(tuple(idx.long().movedim(-1, 0)), upd,
                                  accumulate=True)]}


@register_op("histogram", differentiable=False)
def _histogram(ins, attrs, ctx):
    """``bins`` equal bins over [min, max] (the data's range when both
    are 0), the last bin closed; int64 counts."""
    x = ins["X"][0].reshape(-1).float()
    lo, hi = attrs.get("min", 0), attrs.get("max", 0)
    if lo == 0 and hi == 0:
        lo, hi = x.min().item(), x.max().item()
    return {"Out": [torch.histc(x, bins=attrs.get("bins", 100), min=lo,
                                max=hi).long()]}


@register_op("crop_tensor", nondiff_inputs=("Shape", "Offsets"))
def _crop_tensor(ins, attrs, ctx):
    """The window of ``shape`` (-1 keeps a dim) at ``offsets``."""
    x = ins["X"][0]
    shape = [int(s) for s in ins["Shape"][0].reshape(-1).tolist()] \
        if ins.get("Shape") else list(attrs.get("shape"))
    offsets = [int(o) for o in ins["Offsets"][0].reshape(-1).tolist()] \
        if ins.get("Offsets") else list(attrs.get("offsets",
                                                  [0] * x.ndim))
    shape = [x.shape[i] if s == -1 else s for i, s in enumerate(shape)]
    return {"Out": [x[tuple(slice(o, o + s)
                            for o, s in zip(offsets, shape))]]}
