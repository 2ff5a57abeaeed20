"""The 1.x dygraph learning-rate decays (counterpart of
``paddle_tpu/dygraph/learning_rate_scheduler.py``; reference
python/paddle/fluid/dygraph/learning_rate_scheduler.py).

Each is the 2.0 ``LRScheduler`` of ``optimizer/lr.py`` under its
fluid-era constructor; ``__call__`` gives the current rate, and the
fluid optimizers take one as their ``learning_rate`` (a callable rate is
read at every dygraph ``minimize``)."""
from __future__ import annotations

import math

from ..optimizer import lr as _lr

__all__ = ["NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
           "ExponentialDecay", "InverseTimeDecay", "PolynomialDecay",
           "CosineDecay", "LinearLrWarmup", "ReduceLROnPlateau",
           "StepDecay", "MultiStepDecay", "LambdaDecay"]


class NoamDecay(_lr.NoamDecay):
    def __init__(self, d_model, warmup_steps, begin=1, step=1, dtype=None,
                 learning_rate=1.0):
        super().__init__(d_model, warmup_steps, learning_rate=learning_rate)


class PiecewiseDecay(_lr.PiecewiseDecay):
    def __init__(self, boundaries, values, begin=0, step=1, dtype=None):
        super().__init__(boundaries, values)


class _FluidDecayMixin:
    """The fluid form's step ratio, ``step / decay_steps``, floored when
    ``staircase``."""

    def _init_fluid(self, decay_steps, decay_rate, staircase):
        self._decay_steps = float(decay_steps)
        self._decay_rate = decay_rate
        self._staircase = staircase

    def _ratio(self):
        r = self.last_epoch / self._decay_steps
        return math.floor(r) if self._staircase else r


class NaturalExpDecay(_FluidDecayMixin, _lr.LRScheduler):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1, dtype=None):
        self._init_fluid(decay_steps, decay_rate, staircase)
        super().__init__(learning_rate)

    def get_lr(self):
        return self.base_lr * math.exp(-self._decay_rate * self._ratio())


class ExponentialDecay(_FluidDecayMixin, _lr.LRScheduler):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1, dtype=None):
        self._init_fluid(decay_steps, decay_rate, staircase)
        super().__init__(learning_rate)

    def get_lr(self):
        return self.base_lr * self._decay_rate ** self._ratio()


class InverseTimeDecay(_FluidDecayMixin, _lr.LRScheduler):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1, dtype=None):
        self._init_fluid(decay_steps, decay_rate, staircase)
        super().__init__(learning_rate)

    def get_lr(self):
        return self.base_lr / (1.0 + self._decay_rate * self._ratio())


class PolynomialDecay(_lr.PolynomialDecay):
    def __init__(self, learning_rate, decay_steps, end_learning_rate=1e-4,
                 power=1.0, cycle=False, begin=0, step=1, dtype=None):
        super().__init__(learning_rate, decay_steps,
                         end_lr=end_learning_rate, power=power, cycle=cycle)


class CosineDecay(_lr.LRScheduler):
    """lr · 0.5 · (cos(floor(step / step_each_epoch) · pi / epochs) + 1):
    the epoch advances every ``step_each_epoch`` steps and the cosine's
    half period is ``epochs``."""

    def __init__(self, learning_rate, step_each_epoch, epochs, begin=0,
                 step=1, dtype=None):
        self.step_each_epoch = step_each_epoch
        self.epochs = epochs
        super().__init__(learning_rate)

    def get_lr(self):
        cur_epoch = math.floor(self.last_epoch / self.step_each_epoch)
        return self.base_lr * 0.5 * (
            math.cos(cur_epoch * math.pi / self.epochs) + 1)


class LinearLrWarmup(_lr.LinearWarmup):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 begin=1, step=1, dtype=None):
        super().__init__(learning_rate, warmup_steps, start_lr, end_lr)


class ReduceLROnPlateau(_lr.ReduceOnPlateau):
    def __init__(self, learning_rate, mode="min", decay_rate=0.1,
                 patience=10, verbose=False, threshold=1e-4,
                 threshold_mode="rel", cooldown=0, min_lr=0, eps=1e-8,
                 dtype=None):
        super().__init__(learning_rate, mode=mode, factor=decay_rate,
                         patience=patience, threshold=threshold,
                         cooldown=cooldown, min_lr=min_lr)


class StepDecay(_lr.StepDecay):
    def __init__(self, learning_rate, step_size, decay_rate=0.1):
        super().__init__(learning_rate, step_size, gamma=decay_rate)


class MultiStepDecay(_lr.MultiStepDecay):
    def __init__(self, learning_rate, milestones, decay_rate=0.1):
        super().__init__(learning_rate, milestones, gamma=decay_rate)


class LambdaDecay(_lr.LambdaDecay):
    def __init__(self, learning_rate, lr_lambda):
        super().__init__(learning_rate, lr_lambda)
