"""hapi callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``):
the progress log, checkpoints, early stopping, the two rate callbacks
and a scalar writer.  ``ProfilerCallback`` waits for the trace planes
(ROADMAP queue A item 9)."""
from __future__ import annotations

import time

import numpy as np


class Callback:
    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None): pass
    def on_train_end(self, logs=None): pass
    def on_epoch_begin(self, epoch, logs=None): pass
    def on_epoch_end(self, epoch, logs=None): pass
    def on_train_batch_begin(self, step, logs=None): pass
    def on_train_batch_end(self, step, logs=None): pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def dispatch(*a, **k):
                for c in self.callbacks:
                    getattr(c, name)(*a, **k)
            return dispatch
        raise AttributeError(name)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=10, verbose=2):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._t0 = time.time()
        self._losses = []

    def on_train_batch_end(self, step, logs=None):
        loss = logs.get("loss", [0])[0] if logs else 0
        self._losses.append(loss)
        if self.verbose and step % self.log_freq == 0:
            print(f"epoch {self._epoch} step {step}: "
                  f"loss {np.mean(self._losses[-self.log_freq:]):.5f}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            print(f"epoch {epoch} done in {dt:.1f}s: {logs}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler: every batch with ``by_step``,
    else every epoch."""

    def __init__(self, by_step=True, by_epoch=False):
        if by_step and by_epoch:
            raise ValueError("by_step and by_epoch are mutually exclusive")
        self.by_step = by_step and not by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        sched = getattr(opt, "_lr", None)
        return sched if hasattr(sched, "step") else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s is not None and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s is not None and not self.by_step:
            s.step()


class EarlyStopping(Callback):
    """Stops training when a monitored metric stops improving."""

    def __init__(self, monitor="loss", mode="auto", patience=0,
                 verbose=1, min_delta=0, baseline=None,
                 save_best_model=True, save_dir=None):
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.save_dir = save_dir
        if mode == "max" or (mode == "auto" and ("acc" in monitor
                                                 or "auc" in monitor)):
            self.greater = True
        else:
            self.greater = False
        self.best = None
        self.wait = 0
        self.stopped_epoch = 0

    def _improved(self, value):
        if self.best is None:
            return True
        return (value > self.best + self.min_delta if self.greater
                else value < self.best - self.min_delta)

    def on_train_begin(self, logs=None):
        self.best = self.baseline
        self.wait = 0
        if self.save_best_model and not self.save_dir and self.verbose:
            # Paddle raises here; this keeps running and says so once
            print("EarlyStopping: save_best_model needs save_dir — "
                  "best-model checkpointing disabled")

    def on_epoch_end(self, epoch, logs=None):
        value = (logs or {}).get(self.monitor)
        if value is None:
            return
        if self._improved(value):
            self.best = value
            self.wait = 0
            if self.save_best_model and self.save_dir:
                self.model.save(f"{self.save_dir}/best_model")
        else:
            self.wait += 1
        # the stop condition is checked after every evaluation, improved
        # or not: patience=0 stops after the first one
        if self.wait >= self.patience:
            self.stopped_epoch = epoch
            self.model.stop_training = True
            if self.verbose:
                print(f"Epoch {epoch}: early stopping "
                      f"(best {self.monitor}={self.best})")


class ReduceLROnPlateau(Callback):
    """Shrinks the rate when a metric plateaus."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0.0):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.greater = mode == "max" or (mode == "auto"
                                         and ("acc" in monitor
                                              or "auc" in monitor))
        self.best = None
        self.wait = 0
        self.cooldown_counter = 0

    def _improved(self, value):
        if self.best is None:
            return True
        return (value > self.best + self.min_delta if self.greater
                else value < self.best - self.min_delta)

    def on_epoch_end(self, epoch, logs=None):
        value = (logs or {}).get(self.monitor)
        opt = getattr(self.model, "_optimizer", None)
        if value is None or opt is None:
            return
        # the cooldown ticks down every epoch: an improving metric during
        # cooldown must not freeze the counter
        in_cooldown = self.cooldown_counter > 0
        if in_cooldown:
            self.cooldown_counter -= 1
            self.wait = 0
        if self._improved(value):
            self.best = value
            self.wait = 0
            return
        if in_cooldown:
            return                       # plateau epochs inside cooldown
        self.wait += 1                   # don't count toward patience
        if self.wait >= self.patience:   # fires at patience
            from ..optimizer import lr as lrmod
            if isinstance(getattr(opt, "_lr", None), lrmod.LRScheduler):
                if self.verbose and not getattr(self, "_sched_warned",
                                                False):
                    self._sched_warned = True
                    print("ReduceLROnPlateau: optimizer lr is scheduler-"
                          "driven; skipping reduction")
                self.wait = 0
                return
            old = float(opt.get_lr())
            new = max(old * self.factor, self.min_lr)
            if old - new > 1e-12:
                opt.set_lr(new)
                if self.verbose:
                    print(f"Epoch {epoch}: reducing lr to {new:.6g}")
            self.cooldown_counter = self.cooldown
            self.wait = 0


class VisualDL(Callback):
    """Scalar logging: one JSON record a metric a step or epoch, appended
    to ``<log_dir>/scalars.jsonl`` (the visualization service is not
    part of the package)."""

    def __init__(self, log_dir="./vdl_log"):
        self.log_dir = log_dir
        self._step = 0
        self._fh = None

    def on_train_begin(self, logs=None):
        import os
        os.makedirs(self.log_dir, exist_ok=True)
        self._fh = open(os.path.join(self.log_dir, "scalars.jsonl"), "a")

    def on_train_end(self, logs=None):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def _write(self, tag, value, step):
        import json
        import os
        if self._fh is None:                  # used outside fit(): degrade
            os.makedirs(self.log_dir, exist_ok=True)
            self._fh = open(os.path.join(self.log_dir, "scalars.jsonl"),
                            "a")
        self._fh.write(json.dumps({"tag": tag, "value": float(value),
                                   "step": int(step)}) + "\n")
        self._fh.flush()

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        for k, v in (logs or {}).items():
            try:
                self._write(f"train/{k}", np.ravel(v)[0], self._step)
            except (TypeError, ValueError):
                pass

    def on_epoch_end(self, epoch, logs=None):
        for k, v in (logs or {}).items():
            try:
                self._write(f"epoch/{k}", np.ravel(v)[0], epoch)
            except (TypeError, ValueError):
                pass
