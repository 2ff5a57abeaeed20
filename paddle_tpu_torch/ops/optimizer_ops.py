"""Optimizer update ops (counterpart of ``paddle_tpu/ops/optimizer_ops.py``:
SGD, Momentum, Adam, AdamW, Adagrad, RMSProp, Lamb, Adadelta, LARS
momentum, FTRL, DP-SGD, decayed Adagrad, DGC momentum, ModelAverage's
``average_accumulates``, GradientMerge's ``SkipUpdate`` gate, the
bucketed forms of Adam, Momentum and LAMB, and static AMP's loss-scaling
pair, ``check_finite_and_unscale`` and ``update_loss_scaling``; Adamax
is in ``misc_ops.py``, as in the reference).

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
With fp32 masters (``MasterParam``) the bucket's update computes on
the masters, the kernel (``cuda_kernels.fused_adam_master``) reading
each gradient in its own dtype and widening it, and writes the new
masters, the moments and, in the same pass, each parameter rounded to
its bfloat16 or float16 (round to nearest even, as ``Tensor.to``
rounds): bit for bit the per-param op with ``MasterParam``.
``fused_momentum`` is the same for a run of ``momentum`` ops, on
``cuda_kernels.fused_momentum`` (``fused_momentum_master`` with
masters): on the card one multi-tensor kernel call
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
    masters = ins.get("MasterParam")
    ps, gs = masters or ins["Param"], ins["Grad"]
    ms, vs = ins["Moment1"], ins["Moment2"]
    b1ps, b2ps = ins["Beta1Pow"], ins["Beta2Pow"]
    lr = _p(ins, "LearningRate")
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    if _flat_kernel_ok(ps[0]):
        specs = _view_specs(tuple(p.shape for p in ps))
        if masters:
            po, mo, vo, plo, pows = cuda_kernels.fused_adam_master(
                masters, gs, ms, vs, lr, b1ps, b2ps, b1, b2, eps,
                ins["Param"][0].dtype)
        else:
            po, mo, vo, pows = cuda_kernels.fused_adam(
                ps, gs, ms, vs, lr, b1ps, b2ps, b1, b2, eps)
        outs = {"Moment1Out": _views(mo, specs),
                "Moment2Out": _views(vo, specs),
                "Beta1PowOut": list(pows[0].unsqueeze(1).unbind()),
                "Beta2PowOut": list(pows[1].unsqueeze(1).unbind())}
        if masters:
            outs["ParamOut"] = _views(plo, specs)
            outs["MasterParamOut"] = _views(po, specs)
        else:
            outs["ParamOut"] = _views(po, specs)
        return outs
    return _plain_fused_adam(ps, gs, ms, vs, lr, b1ps, b2ps, b1, b2, eps,
                             ins["Param"] if masters else None)


def _bucket_param_outs(outs, lo, new_ps):
    """With masters (``lo`` the low-precision params), ``ParamOut`` is
    each new master rounded to its param's dtype and ``MasterParamOut``
    the masters; else ``ParamOut`` the new params."""
    if lo is not None:
        outs["ParamOut"] = [p.to(l.dtype) for p, l in zip(new_ps, lo)]
        outs["MasterParamOut"] = list(new_ps)
    else:
        outs["ParamOut"] = list(new_ps)
    return outs


def _plain_fused_adam(ps, gs, ms, vs, lr, b1ps, b2ps, b1, b2, eps,
                      lo=None):
    """The kernel's plain version, what a CPU bucket runs: the bucket
    flattened (each grad widened to the params', or the masters', dtype),
    each param's ``lr_t`` broadcast over its segment, the per-param
    formula over the flat buffers, unflattened; with masters ``lo`` the
    new masters are rounded into ``ParamOut``."""
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
    outs = {"Moment1Out": _unflat(m_new, ms, sizes),
            "Moment2Out": _unflat(v_new, vs, sizes),
            "Beta1PowOut": [(p1.reshape(()) * b1).reshape(1)
                            for p1 in b1ps],
            "Beta2PowOut": [(p2.reshape(()) * b2).reshape(1)
                            for p2 in b2ps]}
    return _bucket_param_outs(outs, lo, _unflat(p_new, ps, sizes))


@register_op("fused_momentum", differentiable=False)
def _fused_momentum(ins, attrs, ctx):
    masters = ins.get("MasterParam")
    ps, vs = masters or ins["Param"], ins["Velocity"]
    lr = _p(ins, "LearningRate")
    mu = attrs.get("mu", 0.9)
    l2 = _l2_coeff(attrs)
    nesterov = attrs.get("use_nesterov", False)
    if _flat_kernel_ok(ps[0]):
        specs = _view_specs(tuple(p.shape for p in ps))
        if masters:
            # the kernel reads each grad in its own dtype and widens it
            po, vo, plo = cuda_kernels.fused_momentum_master(
                masters, ins["Grad"], vs, lr.reshape(1), mu, l2, nesterov,
                ins["Param"][0].dtype)
            return {"ParamOut": _views(plo, specs),
                    "MasterParamOut": _views(po, specs),
                    "VelocityOut": _views(vo, specs)}
        # a grad of another dtype is widened to its param's, as the
        # reference's _bucket_params does
        gs = [g.to(p.dtype) for g, p in zip(ins["Grad"], ps)]
        po, vo = cuda_kernels.fused_momentum(ps, gs, vs, lr.reshape(1), mu,
                                             l2, nesterov)
        return {"ParamOut": _views(po, specs),
                "VelocityOut": _views(vo, specs)}
    return _plain_fused_momentum(ps, ins["Grad"], vs, lr, mu, l2, nesterov,
                                 ins["Param"] if masters else None)


def _plain_fused_momentum(ps, gs, vs, lr, mu, l2, nesterov, lo=None):
    """The kernel's plain version, what a CPU bucket runs: the bucket
    flattened (each grad widened), the per-param formula over the flat
    buffers, unflattened; with masters ``lo`` the new masters are
    rounded into ``ParamOut``."""
    sizes = [p.numel() for p in ps]
    cdt = ps[0].dtype
    p_f, g_f, v_f = _flat(ps, cdt), _flat(gs, cdt), _flat(vs, cdt)
    p_new, v_new = _momentum_update(p_f, g_f, v_f, lr.reshape(()), mu, l2,
                                    nesterov)
    return _bucket_param_outs({"VelocityOut": _unflat(v_new, vs, sizes)},
                              lo, _unflat(p_new, ps, sizes))


@register_op("fused_lamb", differentiable=False)
def _fused_lamb(ins, attrs, ctx):
    """A bucket of LAMB updates in one op.  The trust ratio's norms are
    per parameter, so each parameter runs the per-param ``lamb`` update
    (the reference has no kernel for LAMB); the rewrite is bit-identical
    to the per-param ops."""
    slots = [s for s in ("Param", "Grad", "Moment1", "Moment2", "Beta1Pow",
                         "Beta2Pow", "MasterParam") if ins.get(s)]
    outs = {}
    for i in range(len(ins["Param"])):
        sub = {s: [ins[s][i]] for s in slots}
        sub["LearningRate"] = ins["LearningRate"]
        for k, v in _lamb(sub, attrs, ctx).items():
            outs.setdefault(k, []).append(v[0])
    return outs


# ---------------------------------------------------------------------------
# the other update ops
# ---------------------------------------------------------------------------

@register_op("lars_momentum", differentiable=False)
def _lars_momentum(ins, attrs, ctx):
    """Momentum with the layer-wise rate ``coeff·|p| / (|g| + decay·|p|
    + eps)`` (1 where either norm is 0)."""
    p, g, v = _p(ins, "Param"), _p(ins, "Grad"), _p(ins, "Velocity")
    lr = _p(ins, "LearningRate").reshape(())
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    decay = attrs.get("lars_weight_decay", 0.0005)
    eps = attrs.get("epsilon", 0.0)
    pn = torch.sqrt(torch.sum(p * p))
    gn = torch.sqrt(torch.sum(g * g))
    one = torch.ones_like(pn)
    local_lr = torch.where(pn > 0, torch.where(
        gn > 0, coeff * pn / (gn + decay * pn + eps), one), one)
    v_new = mu * v + lr * local_lr * (g + decay * p)
    return {"ParamOut": [p - v_new], "VelocityOut": [v_new]}


@register_op("ftrl", differentiable=False)
def _ftrl(ins, attrs, ctx):
    p, g = _p(ins, "Param"), _p(ins, "Grad")
    sq, lin = _p(ins, "SquaredAccumulator"), _p(ins, "LinearAccumulator")
    lr = _p(ins, "LearningRate").reshape(())
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    power = attrs.get("lr_power", -0.5)
    sq_new = sq + g * g
    sigma = (torch.pow(sq_new, -power) - torch.pow(sq, -power)) / lr
    lin_new = lin + g - sigma * p
    quad = torch.pow(sq_new, -power) / lr + 2 * l2
    pre = torch.clamp(lin_new, -l1, l1) - lin_new
    p_new = torch.where(torch.abs(lin_new) > l1, pre / quad,
                        torch.zeros_like(pre))
    return {"ParamOut": [p_new], "SquaredAccumOut": [sq_new],
            "LinearAccumOut": [lin_new]}


def _philox_normal(shape, seed: int, device, dtype):
    """Standard normal noise from the Philox stream of ``seed`` (the
    words the dropout kernels draw), by Box-Muller over two words an
    element."""
    from .nn_ops import _key_words, _reference_bits
    k0, k1 = _key_words(seed)
    bits = _reference_bits((2,) + tuple(shape), k0, k1, device)
    u1 = (bits[0].to(torch.float64) + 0.5) / 2.0 ** 32
    u2 = bits[1].to(torch.float64) / 2.0 ** 32
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return z.to(dtype)


@register_op("dpsgd", differentiable=False)
def _dpsgd(ins, attrs, ctx):
    """Differentially private SGD (dpsgd_op.cc): the gradient clipped to
    norm ``clip``, plus normal noise of scale ``sigma·clip``.  The noise
    is drawn from Philox keyed by the op's seed, as the dropout kernels
    draw their masks: held by contract (zero noise gives the plain
    update, the noise has the right scale), not bit for bit against the
    reference's generator."""
    p, g = _p(ins, "Param"), _p(ins, "Grad")
    lr = _p(ins, "LearningRate").reshape(())
    clip = attrs.get("clip", 10.0)
    sigma = attrs.get("sigma", 1.0)
    gn = torch.sqrt(torch.sum(g * g))
    g = g / torch.clamp(gn / clip, min=1.0)
    if g.device.type == "meta":
        return {"ParamOut": [p - lr * g]}
    noise = _philox_normal(g.shape, ctx.seed_for(attrs.get("op_seed", 0)),
                           g.device, g.dtype) * sigma * clip
    return {"ParamOut": [p - lr * (g + noise)]}


@register_op("decayed_adagrad", differentiable=False)
def _decayed_adagrad(ins, attrs, ctx):
    p, g, m = _p(ins, "Param"), _p(ins, "Grad"), _p(ins, "Moment")
    lr = _p(ins, "LearningRate").reshape(())
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    new_m = decay * m + (1 - decay) * g * g
    return {"ParamOut": [p - lr * g / (torch.sqrt(new_m) + eps)],
            "MomentOut": [new_m]}


# ---------------------------------------------------------------------------
# AMP dynamic loss scaling (operators/amp/*)
# ---------------------------------------------------------------------------
@register_op("check_finite_and_unscale", differentiable=False)
def _check_finite_and_unscale(ins, attrs, ctx):
    """Each X divided by Scale (in the two dtypes' common type, as the
    reference promotes), and whether any value of any X was not finite,
    a ``[1]`` bool left on the card."""
    scale = _p(ins, "Scale").reshape(())
    outs = []
    found_inf = torch.zeros((), dtype=torch.bool, device=scale.device)
    for x in ins["X"]:
        found_inf = found_inf | ~torch.isfinite(x).all()
        outs.append(x.to(torch.promote_types(x.dtype, scale.dtype))
                    / scale)
    return {"Out": outs, "FoundInfinite": [found_inf.reshape(1)]}


@register_op("update_loss_scaling", differentiable=False)
def _update_loss_scaling(ins, attrs, ctx):
    """The dynamic loss scale's step: after ``incr_every_n_steps`` good
    steps in a row the scale grows by ``incr_ratio``; after
    ``decr_every_n_nan_or_inf`` bad ones it shrinks by ``decr_ratio``
    (never under 1); a bad step zeroes every X.  All on the card, no
    host read."""
    found_inf = _p(ins, "FoundInfinite").reshape(())
    scale = _p(ins, "PrevLossScaling").reshape(())
    good = _p(ins, "InGoodSteps").reshape(())
    bad = _p(ins, "InBadSteps").reshape(())
    incr_every = attrs.get("incr_every_n_steps", 1000)
    decr_every = attrs.get("decr_every_n_nan_or_inf", 2)
    incr_ratio = attrs.get("incr_ratio", 2.0)
    decr_ratio = attrs.get("decr_ratio", 0.5)

    zero_good, zero_bad = torch.zeros_like(good), torch.zeros_like(bad)
    good_new = torch.where(found_inf, zero_good, good + 1)
    bad_new = torch.where(found_inf, bad + 1, zero_bad)
    grow = good_new >= incr_every
    scale_up = torch.where(grow, scale * incr_ratio, scale)
    good_new = torch.where(grow, zero_good, good_new)
    shrink = bad_new >= decr_every
    scale_dn = torch.where(shrink, torch.clamp_min(scale * decr_ratio, 1.0),
                           scale_up)
    bad_new = torch.where(shrink, zero_bad, bad_new)
    outs = [torch.where(found_inf, torch.zeros_like(x), x)
            for x in ins["X"]]
    return {"Out": outs, "LossScaling": [scale_dn.reshape(1)],
            "OutGoodSteps": [good_new.reshape(1)],
            "OutBadSteps": [bad_new.reshape(1)]}


@register_op("dgc_momentum", differentiable=False)
def _dgc_momentum(ins, attrs, ctx):
    """Deep Gradient Compression momentum (dgc_momentum_op.cc): before
    ``rampup_begin_step`` plain momentum; after, momentum correction, the
    top ``1 - sparsity`` share of the accumulated values kept (the
    others fed back), one process's values (no ring here)."""
    p, g = _p(ins, "Param"), _p(ins, "Grad")
    u, v = _p(ins, "U"), _p(ins, "V")
    lr = _p(ins, "LearningRate").reshape(())
    step = _p(ins, "CurrentStep").reshape(())
    mu = attrs.get("mu", 0.9)
    sparsity = attrs.get("sparsity", 0.999)
    rampup = attrs.get("rampup_begin_step", 0.0)
    nesterov = attrs.get("use_nesterov", False)
    u_corr = mu * u + g
    v_acc = v + u_corr
    mag = torch.abs(v_acc)
    thr = torch.quantile(mag.reshape(-1).to(torch.float32), sparsity)
    mask = (mag >= thr).to(v_acc.dtype)
    dgc_p = p - lr * (v_acc * mask)
    dgc_u = u_corr * (1.0 - mask)
    dgc_v = v_acc * (1.0 - mask)
    v_mom = mu * u + g
    mom_p = p - lr * ((g + mu * v_mom) if nesterov else v_mom)
    use_dgc = step >= rampup
    return {"ParamOut": [torch.where(use_dgc, dgc_p, mom_p)],
            "UOut": [torch.where(use_dgc, dgc_u, v_mom)],
            "VOut": [torch.where(use_dgc, dgc_v, torch.zeros_like(v))]}


@register_op("average_accumulates", differentiable=False)
def _average_accumulates(ins, attrs, ctx):
    """ModelAverage's window sums (average_accumulates_op.h): sum_1 adds
    the param each step; every 16384 updates it moves into sum_2; once
    the window fills, sum_3 takes the completed window and the others
    restart."""
    p = _p(ins, "param")
    s1, s2, s3 = _p(ins, "in_sum_1"), _p(ins, "in_sum_2"), _p(ins, "in_sum_3")
    f32 = torch.float32
    na = _p(ins, "in_num_accumulates").reshape(()).to(f32)
    ona = _p(ins, "in_old_num_accumulates").reshape(()).to(f32)
    nu = _p(ins, "in_num_updates").reshape(()).to(f32)
    rate = attrs.get("average_window", 0.0)
    min_w = attrs.get("min_average_window", 10000)
    max_w = attrs.get("max_average_window", 10000)
    s1 = s1 + p
    na = na + 1.0
    nu = nu + 1.0
    shuffle = torch.remainder(nu, 16384.0) == 0
    s2 = torch.where(shuffle, s2 + s1, s2)
    s1 = torch.where(shuffle, torch.zeros_like(s1), s1)
    window = torch.minimum(torch.tensor(float(max_w), dtype=f32,
                                        device=nu.device), nu * rate)
    shift = (na >= min_w) & (na >= window)
    zero = torch.zeros((), dtype=f32, device=na.device)
    return {"out_sum_1": [torch.where(shift, torch.zeros_like(s1), s1)],
            "out_sum_2": [torch.where(shift, torch.zeros_like(s2), s2)],
            "out_sum_3": [torch.where(shift, s1 + s2, s3)],
            "out_num_accumulates": [torch.where(shift, zero,
                                                na).reshape(1)],
            "out_old_num_accumulates": [torch.where(shift, na,
                                                    ona).reshape(1)],
            "out_num_updates": [nu.reshape(1)]}


def apply_skip_update(ins, outs):
    """GradientMerge's gate: where the op's ``SkipUpdate`` holds, every
    ``<X>Out`` output keeps its ``<X>`` input's old value, so an update
    op skipped on a run moves nothing (Adam's moments and powers
    included); the executor applies it to any op with that input."""
    skip_in = ins.get("SkipUpdate")
    if not skip_in:
        return outs
    skip = skip_in[0].reshape(()).to(torch.bool)
    gated = {}
    for slot, vals in outs.items():
        olds = ins.get(slot[:-3], []) if slot.endswith("Out") else []
        gated[slot] = [new if i >= len(olds) or olds[i] is None
                       else torch.where(skip, olds[i], new)
                       for i, new in enumerate(vals)]
    return gated
