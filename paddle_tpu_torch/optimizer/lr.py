"""Learning-rate schedulers (counterpart of ``paddle_tpu/optimizer/lr.py``;
reference python/paddle/optimizer/lr.py).

Pure Python on host floats, with no tensor in them: ``scheduler()`` is
the current rate, ``step()`` advances it (``ReduceOnPlateau.step`` takes
the metric).  An eager optimizer reads the rate once a step and hands
the card a one-value tensor."""
from __future__ import annotations

import math


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = learning_rate
        self.last_epoch = last_epoch
        self.last_lr = learning_rate
        self.step()

    def __call__(self):
        return self.last_lr

    def get_lr(self):
        raise NotImplementedError

    def step(self, epoch=None):
        self.last_epoch = (self.last_epoch + 1) if epoch is None else epoch
        self.last_lr = self.get_lr()

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, state):
        self.last_epoch = state["last_epoch"]
        self.last_lr = state["last_lr"]


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0, **kw):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return (self.base_lr * self.d_model ** -0.5 *
                min(step ** -0.5, step * self.warmup_steps ** -1.5))


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, **kw):
        self.gamma = gamma
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, **kw):
        self.gamma = gamma
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, **kw):
        self.gamma = gamma
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, **kw):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        step = self.last_epoch
        if self.cycle:
            div = max(1.0, math.ceil(step / self.decay_steps))
            decay_steps = self.decay_steps * div
        else:
            decay_steps = self.decay_steps
            step = min(step, decay_steps)
        return ((self.base_lr - self.end_lr) *
                (1 - step / decay_steps) ** self.power + self.end_lr)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, **kw):
        self.boundaries = boundaries
        self.values = values
        super().__init__(values[0], **kw)

    def get_lr(self):
        for b, v in zip(self.boundaries, self.values):
            if self.last_epoch < b:
                return v
        return self.values[len(self.boundaries)]


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, **kw):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        return (self.eta_min + (self.base_lr - self.eta_min) *
                (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2)


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr, **kw):
        self.lr_sched = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        base = (learning_rate.base_lr if isinstance(learning_rate, LRScheduler)
                else learning_rate)
        super().__init__(base, **kw)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.start_lr + (self.end_lr - self.start_lr)
                    * self.last_epoch / self.warmup_steps)
        if isinstance(self.lr_sched, LRScheduler):
            self.lr_sched.last_epoch = self.last_epoch - self.warmup_steps
            return self.lr_sched.get_lr()
        return float(self.lr_sched)


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, **kw):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, **kw):
        self.milestones = milestones
        self.gamma = gamma
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma ** n


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, cooldown=0, min_lr=0, **kw):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.num_bad = 0
        self.cooldown_ctr = 0
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        return self.last_lr if hasattr(self, "last_lr") else self.base_lr

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            self.last_epoch += 1
            if not hasattr(self, "last_lr"):
                self.last_lr = self.base_lr
            return
        m = float(metrics)
        better = (self.best is None or
                  (m < self.best - self.threshold if self.mode == "min"
                   else m > self.best + self.threshold))
        if better:
            self.best = m
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_ctr > 0:
            self.cooldown_ctr -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            self.last_lr = max(self.last_lr * self.factor, self.min_lr)
            self.cooldown_ctr = self.cooldown
            self.num_bad = 0


class LambdaDecay(LRScheduler):
    """lr = base_lr * lr_lambda(epoch)."""

    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)
