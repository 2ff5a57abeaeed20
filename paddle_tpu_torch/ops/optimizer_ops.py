"""Optimizer update ops (counterpart of ``paddle_tpu/ops/optimizer_ops.py``:
SGD, Momentum, Adam, AdamW, Adagrad, RMSProp, Lamb and Adadelta, and the
bucketed forms of Adam and Momentum; Adamax is in ``misc_ops.py``, as in
the reference).

Each op consumes (param, grad, states...) and returns new values; the
executor writes the outputs back to the scope under the same names.  All
are non-differentiable.  SGD, Momentum, Adam, AdamW and Lamb take a
``MasterParam``, as the reference's do: the update then computes on that
float32 master, with the gradient widened to it, and ``ParamOut`` is the
new master rounded to the parameter's dtype (``MasterParamOut`` the
master itself).

``fused_adam`` is what the ``fuse_optimizer`` pass makes of a run of
``adam`` ops: one op per bucket.  On the card it is one call of the
hand-written multi-tensor kernel (``cuda_kernels.fused_adam``), which
reads every param, grad and moment where it lies, computes each param's
bias-corrected ``lr_t`` from ``LearningRate`` and its beta powers on the
card, and writes the new values into three flat buffers that the op
hands out as per-param views; nothing is concatenated and no per-element
``lr_t`` is made.  On the host the bucket is flattened and ``lr_t``
broadcast over each segment, as in the reference.  Either way it is
element for element the same arithmetic as the per-param op, each
multiply, add, square root and division rounded once, so the rewrite is
bit-identical to the per-param updates on either device.
``fused_momentum`` is the same for a run of ``momentum`` ops, on
``cuda_kernels.fused_momentum``: on the card one multi-tensor kernel call
that reads every param, grad and velocity where it lies and writes two
flat buffers handed out as views; on the host the bucket flattened.  Its
learning rate stays a ``[1]`` tensor on the card, which the kernel
reads, so a step never waits on the host.
"""
from __future__ import annotations

import functools
import math

import torch

from . import cuda_kernels
from .registry import register_op


def _p(ins, slot):
    return ins[slot][0]


def _mp_param(ins):
    """(param to update, grad, master or None): with a ``MasterParam``
    the update runs on the float32 master and the gradient is widened to
    it, so nothing accumulates in a low precision."""
    master = ins.get("MasterParam", [None])[0]
    p = master if master is not None else _p(ins, "Param")
    g = _p(ins, "Grad")
    if master is not None and g.dtype != master.dtype:
        g = g.to(master.dtype)
    return p, g, master


def _mp_outs(outs, ins, master_new):
    """``ParamOut`` the new master in the parameter's dtype,
    ``MasterParamOut`` the master."""
    outs["ParamOut"] = [master_new.to(_p(ins, "Param").dtype)]
    outs["MasterParamOut"] = [master_new]
    return outs


def _param_outs(outs, ins, p_new, master):
    if master is not None:
        return _mp_outs(outs, ins, p_new)
    outs["ParamOut"] = [p_new]
    return outs


def _adam_moments(m, v, g, b1, b2):
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * (g * g)
    return m_new, v_new


def _lr_t(lr, b1p, b2p):
    # reference adam_op.h: lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)
    return lr * torch.sqrt(1 - b2p) / (1 - b1p)


def _momentum_update(p, g, v, lr, mu, l2, nesterov):
    if l2:
        g = g + l2 * p
    v_new = mu * v + g
    if nesterov:
        return p - lr * (g + mu * v_new), v_new
    return p - lr * v_new, v_new


def _l2_coeff(attrs):
    rd = attrs.get("regularization_coeff", 0.0)
    return rd if attrs.get("regularization_method", "") == "l2_decay" \
        else 0.0


@register_op("sgd", differentiable=False)
def _sgd(ins, attrs, ctx):
    p, g, master = _mp_param(ins)
    lr = _p(ins, "LearningRate").reshape(())
    return _param_outs({}, ins, p - lr * g, master)


@register_op("momentum", differentiable=False)
def _momentum(ins, attrs, ctx):
    p, g, master = _mp_param(ins)
    v = _p(ins, "Velocity")
    lr = _p(ins, "LearningRate").reshape(())
    p_new, v_new = _momentum_update(p, g, v, lr, attrs.get("mu", 0.9),
                                    _l2_coeff(attrs),
                                    attrs.get("use_nesterov", False))
    return _param_outs({"VelocityOut": [v_new]}, ins, p_new, master)


@register_op("adam", differentiable=False)
def _adam(ins, attrs, ctx):
    p, g, master = _mp_param(ins)
    m, v = _p(ins, "Moment1"), _p(ins, "Moment2")
    b1p = _p(ins, "Beta1Pow").reshape(())
    b2p = _p(ins, "Beta2Pow").reshape(())
    lr = _p(ins, "LearningRate").reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_new, v_new = _adam_moments(m, v, g, b1, b2)
    p_new = p - _lr_t(lr, b1p, b2p) * m_new / (torch.sqrt(v_new) + eps)
    return _param_outs({"Moment1Out": [m_new], "Moment2Out": [v_new],
                        "Beta1PowOut": [(b1p * b1).reshape(1)],
                        "Beta2PowOut": [(b2p * b2).reshape(1)]},
                       ins, p_new, master)


@register_op("adamw", differentiable=False)
def _adamw(ins, attrs, ctx):
    """Adam, then the decoupled weight decay ``lr · coeff · p`` taken
    against the parameter (or master) before the update."""
    p, _, master = _mp_param(ins)
    coeff = attrs.get("coeff", 0.01)
    lr = _p(ins, "LearningRate").reshape(())
    out = _adam(ins, attrs, ctx)
    if not attrs.get("with_decay", True):
        return out
    if master is not None:
        return _mp_outs(out, ins, out["MasterParamOut"][0] - lr * coeff * p)
    out["ParamOut"] = [out["ParamOut"][0] - lr * coeff * p]
    return out


@register_op("adagrad", differentiable=False)
def _adagrad(ins, attrs, ctx):
    p, g, mom = _p(ins, "Param"), _p(ins, "Grad"), _p(ins, "Moment")
    lr = _p(ins, "LearningRate").reshape(())
    eps = attrs.get("epsilon", 1e-6)
    mom_new = mom + g * g
    return {"ParamOut": [p - lr * g / (torch.sqrt(mom_new) + eps)],
            "MomentOut": [mom_new]}


@register_op("rmsprop", differentiable=False)
def _rmsprop(ins, attrs, ctx):
    p, g = _p(ins, "Param"), _p(ins, "Grad")
    ms, mom = _p(ins, "MeanSquare"), _p(ins, "Moment")
    lr = _p(ins, "LearningRate").reshape(())
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mu = attrs.get("momentum", 0.0)
    ms_new = rho * ms + (1 - rho) * (g * g)
    if attrs.get("centered", False):
        mg_new = rho * _p(ins, "MeanGrad") + (1 - rho) * g
        mom_new = mu * mom + lr * g / torch.sqrt(ms_new - mg_new * mg_new
                                                 + eps)
        return {"ParamOut": [p - mom_new], "MeanSquareOut": [ms_new],
                "MomentOut": [mom_new], "MeanGradOut": [mg_new]}
    mom_new = mu * mom + lr * g / torch.sqrt(ms_new + eps)
    return {"ParamOut": [p - mom_new], "MeanSquareOut": [ms_new],
            "MomentOut": [mom_new]}


@register_op("lamb", differentiable=False)
def _lamb(ins, attrs, ctx):
    """Adam's moments, the update direction ``r`` with weight decay, and
    the layer's trust ratio ``|p| / |r|`` (1 where either norm is 0)."""
    p, g, master = _mp_param(ins)
    m, v = _p(ins, "Moment1"), _p(ins, "Moment2")
    b1p = _p(ins, "Beta1Pow").reshape(())
    b2p = _p(ins, "Beta2Pow").reshape(())
    lr = _p(ins, "LearningRate").reshape(())
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    m_new, v_new = _adam_moments(m, v, g, b1, b2)
    r = (m_new / (1 - b1p)) / (torch.sqrt(v_new / (1 - b2p)) + eps) + wd * p
    p_norm = torch.sqrt(torch.sum(p * p))
    r_norm = torch.sqrt(torch.sum(r * r))
    ratio = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                        torch.ones_like(p_norm))
    return _param_outs({"Moment1Out": [m_new], "Moment2Out": [v_new],
                        "Beta1PowOut": [(b1p * b1).reshape(1)],
                        "Beta2PowOut": [(b2p * b2).reshape(1)]},
                       ins, p - lr * ratio * r, master)


@register_op("adadelta", differentiable=False)
def _adadelta(ins, attrs, ctx):
    """The ratio of the running RMS of updates to that of gradients."""
    p, g = _p(ins, "Param"), _p(ins, "Grad")
    avg_sq_g = _p(ins, "AvgSquaredGrad")
    avg_sq_u = _p(ins, "AvgSquaredUpdate")
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    new_g = rho * avg_sq_g + (1 - rho) * g * g
    update = -torch.sqrt(avg_sq_u + eps) / torch.sqrt(new_g + eps) * g
    new_u = rho * avg_sq_u + (1 - rho) * update * update
    return {"ParamOut": [p + update], "AvgSquaredGradOut": [new_g],
            "AvgSquaredUpdateOut": [new_u]}


# ---------------------------------------------------------------------------
# bucketed updates (fuse_optimizer): concatenation changes layout, never
# values
# ---------------------------------------------------------------------------

def _flat(xs, dtype):
    return torch.cat([x.reshape(-1).to(dtype) for x in xs])


def _unflat(buf, templates, sizes):
    out, off = [], 0
    for t, s in zip(templates, sizes):
        out.append(buf[off:off + s].reshape(t.shape))
        off += s
    return out


def _flat_kernel_ok(p):
    """A CUDA bucket (``p`` its first param) takes its kernel, of any
    length: the reference's 1024-element floor is its [rows, 1024] lane
    padding, which is not copied.  The wrapper raises on a dtype the
    kernel does not take."""
    return p.device.type == "cuda"


@functools.lru_cache(maxsize=64)
def _view_specs(shapes):
    """(shape, strides, offset) of each param's view into a kernel output
    laid out by ``cuda_kernels.bucket_layout``."""
    offsets = cuda_kernels.bucket_layout(
        tuple(math.prod(s) for s in shapes))[0]
    specs = []
    for shape, off in zip(shapes, offsets):
        strides, step = [], 1
        for n in reversed(shape):
            strides.append(step)
            step *= n
        specs.append((tuple(shape), tuple(reversed(strides)), off))
    return tuple(specs)


def _views(buf, specs):
    return [buf.as_strided(shape, strides, off)
            for shape, strides, off in specs]


@register_op("fused_adam", differentiable=False)
def _fused_adam(ins, attrs, ctx):
    ps, gs = ins["Param"], ins["Grad"]
    ms, vs = ins["Moment1"], ins["Moment2"]
    b1ps, b2ps = ins["Beta1Pow"], ins["Beta2Pow"]
    lr = _p(ins, "LearningRate")
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    if _flat_kernel_ok(ps[0]):
        po, mo, vo, pows = cuda_kernels.fused_adam(ps, gs, ms, vs, lr, b1ps,
                                                   b2ps, b1, b2, eps)
        specs = _view_specs(tuple(p.shape for p in ps))
        return {"ParamOut": _views(po, specs),
                "Moment1Out": _views(mo, specs),
                "Moment2Out": _views(vo, specs),
                "Beta1PowOut": list(pows[0].unsqueeze(1).unbind()),
                "Beta2PowOut": list(pows[1].unsqueeze(1).unbind())}
    return _plain_fused_adam(ps, gs, ms, vs, lr, b1ps, b2ps, b1, b2, eps)


def _plain_fused_adam(ps, gs, ms, vs, lr, b1ps, b2ps, b1, b2, eps):
    """The kernel's plain version, what a CPU bucket runs: the bucket
    flattened, each param's ``lr_t`` broadcast over its segment, the
    per-param formula over the flat buffers, unflattened."""
    lr = lr.reshape(())
    sizes = [p.numel() for p in ps]
    cdt = ps[0].dtype
    lrts = [_lr_t(lr, p1.reshape(()), p2.reshape(())).to(cdt)
            for p1, p2 in zip(b1ps, b2ps)]
    p_f, g_f = _flat(ps, cdt), _flat(gs, cdt)
    m_f, v_f = _flat(ms, cdt), _flat(vs, cdt)
    lrt_f = torch.cat([t.expand(s) for t, s in zip(lrts, sizes)])
    m_new, v_new = _adam_moments(m_f, v_f, g_f, b1, b2)
    p_new = p_f - lrt_f * m_new / (torch.sqrt(v_new) + eps)
    return {"ParamOut": _unflat(p_new, ps, sizes),
            "Moment1Out": _unflat(m_new, ms, sizes),
            "Moment2Out": _unflat(v_new, vs, sizes),
            "Beta1PowOut": [(p1.reshape(()) * b1).reshape(1)
                            for p1 in b1ps],
            "Beta2PowOut": [(p2.reshape(()) * b2).reshape(1)
                            for p2 in b2ps]}


@register_op("fused_momentum", differentiable=False)
def _fused_momentum(ins, attrs, ctx):
    ps, vs = ins["Param"], ins["Velocity"]
    # a grad of another dtype is widened to its param's, as the reference's
    # _bucket_params does
    gs = [g.to(p.dtype) for g, p in zip(ins["Grad"], ps)]
    lr = _p(ins, "LearningRate")
    mu = attrs.get("mu", 0.9)
    l2 = _l2_coeff(attrs)
    nesterov = attrs.get("use_nesterov", False)
    if _flat_kernel_ok(ps[0]):
        po, vo = cuda_kernels.fused_momentum(ps, gs, vs, lr.reshape(1), mu,
                                             l2, nesterov)
        specs = _view_specs(tuple(p.shape for p in ps))
        return {"ParamOut": _views(po, specs),
                "VelocityOut": _views(vo, specs)}
    return _plain_fused_momentum(ps, gs, vs, lr, mu, l2, nesterov)


def _plain_fused_momentum(ps, gs, vs, lr, mu, l2, nesterov):
    """The kernel's plain version, what a CPU bucket runs: the bucket
    flattened, the per-param formula over the flat buffers,
    unflattened."""
    sizes = [p.numel() for p in ps]
    cdt = ps[0].dtype
    p_f, g_f, v_f = _flat(ps, cdt), _flat(gs, cdt), _flat(vs, cdt)
    p_new, v_new = _momentum_update(p_f, g_f, v_f, lr.reshape(()), mu, l2,
                                    nesterov)
    return {"ParamOut": _unflat(p_new, ps, sizes),
            "VelocityOut": _unflat(v_new, vs, sizes)}
