"""``GradScaler`` (counterpart of ``paddle_tpu/amp/grad_scaler.py``;
reference python/paddle/fluid/dygraph/amp/loss_scaler.py AmpScaler).

bfloat16 has float32's exponent range, so a bf16 run needs no loss
scaling: the scaler is then the identity, ``scale`` returns the loss as
it is and ``step`` steps the optimizer with no finite check at all.  In
float16 (``auto_cast(dtype="float16")``, or ``dtype="float16"`` here) it
keeps the dynamic loss scale: ``unscale_`` divides the gradients by it
and finds any non-finite value, ``step`` then skips the update, and
``update`` halves the scale after ``decr_every_n_nan_or_inf`` bad steps
in a row and doubles it after ``incr_every_n_steps`` good ones.
``dtype="auto"`` follows the tracer's autocast dtype, and once it has
seen float16 it stays on float16 after the context exits: the usual
loop scales inside ``auto_cast`` and steps outside it.

The reference reads each gradient's finite flag on the host in turn; the
port folds them into one flag on the card and reads it once a step,
which changes no decision.
"""
from __future__ import annotations

import torch

from ..fluid.framework import _dygraph_tracer


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.**15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True,
                 dtype="auto"):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._dtype = dtype
        self._good = 0
        self._bad = 0
        self._found_inf = False
        self._auto_fp16_seen = False

    def _is_identity(self) -> bool:
        """True where scaling buys nothing: disabled, or a run that is
        not float16."""
        if not self._enable:
            return True
        if self._dtype == "float16":
            return False
        if self._dtype not in (None, "auto"):
            return True
        if self._auto_fp16_seen:
            return False
        tracer = _dygraph_tracer()
        if tracer is not None and tracer._amp_enabled \
                and tracer._amp_dtype == "float16":
            self._auto_fp16_seen = True     # the latch
            return False
        return True

    def scale(self, loss):
        if self._is_identity():
            return loss
        return loss * self._scale

    def unscale_(self, optimizer):
        if self._is_identity():
            self._found_inf = False
            return
        inv = 1.0 / self._scale
        flags = []
        for p in optimizer._parameters:
            if p._grad is not None:
                p._grad = p._grad * inv
                flags.append(torch.logical_not(
                    torch.all(torch.isfinite(p._grad))))
        self._found_inf = bool(torch.stack(flags).any()) if flags else False

    def step(self, optimizer):
        if self._is_identity():
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)

    def update(self):
        if self._is_identity() or not self._dynamic:
            return
        if self._found_inf:
            self._bad += 1
            self._good = 0
            if self._bad >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad = 0
        else:
            self._good += 1
            self._bad = 0
            if self._good >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good = 0

    def is_enable(self):
        return self._enable and not self._is_identity()

    def get_scale(self):
        return 1.0 if self._is_identity() else self._scale

    def state_dict(self):
        return {"scale": self._scale, "good": self._good, "bad": self._bad}

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good = state["good"]
        self._bad = state["bad"]


AmpScaler = GradScaler
