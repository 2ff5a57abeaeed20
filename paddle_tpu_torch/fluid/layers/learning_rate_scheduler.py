"""In-graph learning-rate schedules (counterpart of
``paddle_tpu/fluid/layers/learning_rate_scheduler.py``): each builder
returns a Variable computed from the global step counter, so the
schedule advances with every executor run, on the device, and no step
waits on the host for its learning rate.  Each builder calls
``autoincreased_step_counter`` once, which appends one ``increment``."""
from __future__ import annotations

import math

from . import control_flow as _cf
from . import nn as _nn
from . import tensor as _t
from .extras import autoincreased_step_counter

__all__ = ["exponential_decay", "natural_exp_decay", "inverse_time_decay",
           "polynomial_decay", "piecewise_decay", "noam_decay",
           "cosine_decay", "linear_lr_warmup"]


def _global_step():
    return _nn.cast(autoincreased_step_counter(begin=1), "float32")


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    exponent = _global_step() / float(decay_steps)
    if staircase:
        exponent = _nn.floor(exponent)
    return learning_rate * (decay_rate ** exponent)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    exponent = _global_step() / float(decay_steps)
    if staircase:
        exponent = _nn.floor(exponent)
    return learning_rate * _nn.exp(-1.0 * decay_rate * exponent)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    ratio = _global_step() / float(decay_steps)
    if staircase:
        ratio = _nn.floor(ratio)
    return learning_rate / (1.0 + decay_rate * ratio)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4,
                     power=1.0, cycle=False):
    step = _global_step()
    if cycle:
        div = _nn.ceil(step / float(decay_steps))
        div = _nn.elementwise_max(
            div, _t.fill_constant([1], "float32", 1.0))
        decay_var = div * float(decay_steps)
    else:
        decay_var = _t.fill_constant([1], "float32", float(decay_steps))
        step = _nn.elementwise_min(step, decay_var)
    return (learning_rate - end_learning_rate) * \
        ((1.0 - step / decay_var) ** power) + end_learning_rate


def piecewise_decay(boundaries, values):
    """values[i] while the step is below boundaries[i], the last value
    after; a blend of 0/1 masks, as the reference builds it."""
    if len(values) - len(boundaries) != 1:
        raise ValueError("len(values) must be len(boundaries) + 1")
    step = _global_step()
    lr = _t.fill_constant([1], "float32", float(values[-1]))
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        below = _nn.cast(_cf.less_than(
            step, _t.fill_constant([1], "float32", float(b))), "float32")
        lr = below * float(v) + (1.0 - below) * lr
    return lr


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    step = _global_step()
    a = step ** -0.5
    b = step * (float(warmup_steps) ** -1.5)
    return learning_rate * (float(d_model) ** -0.5) * \
        _nn.elementwise_min(a, b)


def cosine_decay(learning_rate, step_each_epoch, epochs):
    epoch = _nn.floor(_global_step() / float(step_each_epoch))
    return learning_rate * 0.5 * (
        _nn.cos(epoch * math.pi / float(epochs)) + 1.0)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    step = _global_step()
    warm = start_lr + (end_lr - start_lr) * step / float(warmup_steps)
    in_warmup = _nn.cast(_cf.less_than(
        step, _t.fill_constant([1], "float32", float(warmup_steps))),
        "float32")
    if not hasattr(learning_rate, "shape"):       # a Python float
        learning_rate = _t.fill_constant([1], "float32",
                                         float(learning_rate))
    return in_warmup * warm + (1.0 - in_warmup) * learning_rate
