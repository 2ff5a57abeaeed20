"""Optimizer update ops (counterpart of ``paddle_tpu/ops/optimizer_ops.py``,
SGD, Adam, Momentum and the bucketed forms of the last two; the other
updates come with their slices).

Each op consumes (param, grad, states...) and returns new values; the
executor writes the outputs back to the scope under the same names.  All
are non-differentiable.

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
    p, g = _p(ins, "Param"), _p(ins, "Grad")
    lr = _p(ins, "LearningRate").reshape(())
    return {"ParamOut": [p - lr * g]}


@register_op("momentum", differentiable=False)
def _momentum(ins, attrs, ctx):
    p, g, v = _p(ins, "Param"), _p(ins, "Grad"), _p(ins, "Velocity")
    lr = _p(ins, "LearningRate").reshape(())
    p_new, v_new = _momentum_update(p, g, v, lr, attrs.get("mu", 0.9),
                                    _l2_coeff(attrs),
                                    attrs.get("use_nesterov", False))
    return {"ParamOut": [p_new], "VelocityOut": [v_new]}


@register_op("adam", differentiable=False)
def _adam(ins, attrs, ctx):
    p, g = _p(ins, "Param"), _p(ins, "Grad")
    m, v = _p(ins, "Moment1"), _p(ins, "Moment2")
    b1p = _p(ins, "Beta1Pow").reshape(())
    b2p = _p(ins, "Beta2Pow").reshape(())
    lr = _p(ins, "LearningRate").reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_new, v_new = _adam_moments(m, v, g, b1, b2)
    p_new = p - _lr_t(lr, b1p, b2p) * m_new / (torch.sqrt(v_new) + eps)
    return {"ParamOut": [p_new], "Moment1Out": [m_new],
            "Moment2Out": [v_new],
            "Beta1PowOut": [(b1p * b1).reshape(1)],
            "Beta2PowOut": [(b2p * b2).reshape(1)]}


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
