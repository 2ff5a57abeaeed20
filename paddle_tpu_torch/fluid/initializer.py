"""Parameter initializers — ops appended to the startup program.

Counterpart of ``paddle_tpu/fluid/initializer.py``: each Initializer
appends a fill/random op for the parameter into the startup Program.  The
random ops draw from a ``torch.Generator`` seeded from the op's
``op_seed`` (ops/random_ops.py), on the executor's device.
"""
from __future__ import annotations

import math

import numpy as np

from .framework import default_startup_program


class Initializer:
    def __call__(self, param, block=None):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, param, block=None):
        block = block or default_startup_program().global_block()
        block.append_op("fill_constant", outputs={"Out": [param.name]},
                        attrs={"shape": list(param.shape),
                               "dtype": param.dtype, "value": self.value})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, param, block=None):
        block = block or default_startup_program().global_block()
        block.append_op(
            "uniform_random", outputs={"Out": [param.name]},
            attrs={"shape": list(param.shape), "dtype": param.dtype,
                   "min": self.low, "max": self.high,
                   "op_seed": self.seed or block.program.next_op_seed()})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, param, block=None):
        block = block or default_startup_program().global_block()
        block.append_op(
            "gaussian_random", outputs={"Out": [param.name]},
            attrs={"shape": list(param.shape), "dtype": param.dtype,
                   "mean": self.loc, "std": self.scale,
                   "op_seed": self.seed or block.program.next_op_seed()})


def _fans(shape):
    if len(shape) == 2:
        return shape[0], shape[1]
    if len(shape) >= 3:
        rf = int(np.prod(shape[2:]))
        return shape[1] * rf, shape[0] * rf
    return shape[0], shape[0]


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = \
            uniform, fan_in, fan_out, seed

    def __call__(self, param, block=None):
        fi, fo = _fans(param.shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(param, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(param, block)


class TruncatedNormalInitializer(Initializer):
    """N(loc, scale²) cut at two standard deviations."""

    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, param, block=None):
        block = block or default_startup_program().global_block()
        block.append_op(
            "truncated_gaussian_random", outputs={"Out": [param.name]},
            attrs={"shape": list(param.shape), "dtype": param.dtype,
                   "mean": self.loc, "std": self.scale,
                   "op_seed": self.seed or block.program.next_op_seed()})


class MSRAInitializer(Initializer):
    """Kaiming (He) initialization over the fan-in (or ``fan_in``)."""

    def __init__(self, uniform=True, fan_in=None, seed=0,
                 negative_slope=0.0, nonlinearity="relu"):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, param, block=None):
        fi = self.fan_in or _fans(param.shape)[0]
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            UniformInitializer(-limit, limit, self.seed)(param, block)
        else:
            NormalInitializer(0.0, math.sqrt(2.0 / fi), self.seed)(param,
                                                                   block)


def _assign_value(param, values, block):
    block = block or default_startup_program().global_block()
    block.append_op(
        "assign_value", outputs={"Out": [param.name]},
        attrs={"shape": list(param.shape), "dtype": param.dtype,
               "fp32_values": np.asarray(values, "float64").reshape(-1)
               .tolist()})


class BilinearInitializer(Initializer):
    """The bilinear upsampling kernel of a transposed convolution."""

    @staticmethod
    def array(shape):
        f = math.ceil(shape[3] / 2)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        w = np.zeros(shape, dtype="float32")
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            w[np.unravel_index(i, shape)] = \
                (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        return w

    def __call__(self, param, block=None):
        _assign_value(param, self.array(param.shape), block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def array(self, shape=None):
        return self.value

    def __call__(self, param, block=None):
        _assign_value(param, self.value, block)


# fluid public aliases
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer


def _to_initializer(x, default=None):
    if x is None:
        return default or XavierInitializer()
    if isinstance(x, Initializer):
        return x
    if isinstance(x, (int, float)):
        return ConstantInitializer(float(x))
    raise TypeError(f"cannot convert {x!r} to an Initializer")


_global_weight_initializer = None
_global_bias_initializer = None


def set_global_initializer(weight_init, bias_init=None):
    """The initializers of parameters created without one (a parameter's
    own ``attr.initializer`` still wins); None resets."""
    global _global_weight_initializer, _global_bias_initializer
    _global_weight_initializer = weight_init
    _global_bias_initializer = bias_init


def _global_initializer(is_bias):
    return _global_bias_initializer if is_bias \
        else _global_weight_initializer
