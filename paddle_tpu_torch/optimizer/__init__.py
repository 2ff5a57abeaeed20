"""The 2.0 optimizers of dygraph training (counterpart of
``paddle_tpu/optimizer``): the schedulers of ``lr.py``, the coalesced
Adam of ``fused.py``, and the eager optimizers below.

An eager optimizer runs the same update op lowerings the static
programs run (``ops/optimizer_ops.py``), one op a parameter, on each
parameter's tensor and its gradient (``p._grad``, what
``loss.backward()`` left), and rebinds the parameter to ``ParamOut``:

    opt = SGD(learning_rate=sched, parameters=model.parameters(),
              grad_clip=ClipGradByGlobalNorm(10.0))
    loss.backward(); opt.step(); opt.clear_grad()

The gradients are clipped first (``grad_clip``, the global norm summed
parameter by parameter in the parameters' order), then ``weight_decay``
is added to each (``g + wd · p``; AdamW decays inside its op instead).
The rate is read once a step, from a float or an ``LRScheduler``, and
handed to the ops as a one-value float32 tensor on the parameters'
device, made anew only when the rate changes.  The accumulators are float32 and keyed by parameter;
``state_dict`` names them ``<param name>.<accumulator>``.
``multi_precision`` keeps a float32 master of every low-precision
parameter, made from it, on SGD, Momentum, Adam, AdamW and Lamb; the
other classes refuse it.  ``set_state_dict`` restores nothing, as in the
reference: a resumed optimizer rebuilds its accumulators from zero.
"""
from __future__ import annotations

import torch

from ..fluid.clip import clip_eager
from ..ops.registry import get_op, LoweringContext
from . import lr
from .fused import FlatSpec, make_fused_adam  # noqa: F401
from .lr import (LRScheduler, NoamDecay, ExponentialDecay,  # noqa: F401
                 NaturalExpDecay, InverseTimeDecay, PolynomialDecay,
                 PiecewiseDecay, CosineAnnealingDecay, LinearWarmup,
                 StepDecay, MultiStepDecay, ReduceOnPlateau, LambdaDecay)


class _EagerOptimizer:
    """Runs ``op_type``'s lowering on each parameter (``_apply_one``)."""
    op_type = "sgd"
    # subclasses whose _apply_one passes a MasterParam; the rest refuse
    # multi_precision=True
    _supports_master = False

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, **kw):
        if (multi_precision or kw.get("multi_precision")) \
                and not self._supports_master:
            raise NotImplementedError(
                f"{type(self).__name__} has no fp32 master-weight path; "
                f"multi_precision=True is only supported on "
                f"SGD/Momentum/Adam/AdamW/Lamb")
        self._lr = learning_rate
        self._parameters = list(parameters or [])
        self._accum = {}
        self._grad_clip = grad_clip
        self._weight_decay = weight_decay
        self._multi_precision = bool(multi_precision)
        self._ctx = LoweringContext()
        self._lr_cache = None

    # -- the rate -----------------------------------------------------------
    def get_lr(self):
        if isinstance(self._lr, lr.LRScheduler):
            return self._lr()
        return float(self._lr)

    def set_lr(self, v):
        if isinstance(self._lr, lr.LRScheduler):
            # a float in its place would freeze the schedule
            raise RuntimeError(
                "cannot set_lr on a scheduler-driven optimizer; adjust the "
                "LRScheduler instead")
        self._lr = v

    # -- accumulators -------------------------------------------------------
    def _accs(self, p, names_and_init):
        """``p``'s accumulators, each made at first use: float32, of the
        given shape (one value for ``()``), filled with its initial
        value."""
        d = self._accum.setdefault(id(p), {})
        for n, (shape, iv) in names_and_init.items():
            if n not in d:
                d[n] = torch.full(tuple(shape) or (1,), iv,
                                  dtype=torch.float32,
                                  device=p._value.device)
        return d

    def _master_of(self, p):
        """The float32 master of a low-precision parameter (made from
        it), or None without multi_precision or for a float32 one."""
        if not self._multi_precision or p._value.dtype == torch.float32:
            return None
        d = self._accum.setdefault(id(p), {})
        if "master" not in d:
            d["master"] = p._value.float()
        return d["master"]

    def _mp_io(self, p, ins):
        master = self._master_of(p)
        if master is not None:
            ins["MasterParam"] = [master]
        return master

    def _mp_write(self, p, outs, master):
        if master is not None and "MasterParamOut" in outs:
            self._accum[id(p)]["master"] = outs["MasterParamOut"][0]

    # -- the step -----------------------------------------------------------
    def step(self):
        params_grads = [(p, p._grad) for p in self._parameters
                        if p._grad is not None and p.trainable]
        if self._grad_clip is not None:
            params_grads = self._clip_eager(params_grads)
        if not params_grads:
            return
        lr_arr = self._lr_tensor(params_grads[0][0]._value.device)
        for p, g in params_grads:
            if self._weight_decay and not isinstance(self, AdamW):
                g = g + float(self._weight_decay) * p._value
            self._apply_one(p, g, lr_arr)

    minimize = step

    def _lr_tensor(self, device):
        """The rate as a [1] float32 tensor on ``device``, made again only
        when the rate changes: a copy from host memory each step would
        make the host wait for the card."""
        lr = self.get_lr()
        if self._lr_cache is None or self._lr_cache[0] != lr \
                or self._lr_cache[1].device != device:
            self._lr_cache = (lr, torch.tensor([lr], dtype=torch.float32,
                                               device=device))
        return self._lr_cache[1]

    def _clip_eager(self, params_grads):
        gs = clip_eager(self._grad_clip, [g for _, g in params_grads])
        if gs is None:
            return params_grads
        return [(p, g) for (p, _), g in zip(params_grads, gs)]

    def _apply_one(self, p, g, lr_arr):
        raise NotImplementedError

    def clear_grad(self):
        for p in self._parameters:
            p.clear_gradient()

    clear_gradients = clear_grad

    def state_dict(self):
        out = {"lr": self.get_lr()}
        for p in self._parameters:
            for n, v in self._accum.get(id(p), {}).items():
                out[f"{p.name}.{n}"] = v.detach().cpu().numpy()
        return out

    def set_state_dict(self, state):
        pass    # the reference's: accumulators rebuild from zero


class SGD(_EagerOptimizer):
    _supports_master = True

    def _apply_one(self, p, g, lr_arr):
        ins = {"Param": [p._value], "Grad": [g], "LearningRate": [lr_arr]}
        master = self._mp_io(p, ins)
        out = get_op("sgd").fn(ins, {}, self._ctx)
        p._value = out["ParamOut"][0]
        self._mp_write(p, out, master)


class Momentum(_EagerOptimizer):
    _supports_master = True

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision=multi_precision)
        self._mu = momentum
        self._nesterov = use_nesterov

    def _apply_one(self, p, g, lr_arr):
        accs = self._accs(p, {"velocity": (p.shape, 0.0)})
        ins = {"Param": [p._value], "Grad": [g],
               "Velocity": [accs["velocity"]], "LearningRate": [lr_arr]}
        master = self._mp_io(p, ins)
        out = get_op("momentum").fn(
            ins, {"mu": self._mu, "use_nesterov": self._nesterov},
            self._ctx)
        p._value = out["ParamOut"][0]
        accs["velocity"] = out["VelocityOut"][0]
        self._mp_write(p, out, master)


class Adam(_EagerOptimizer):
    _supports_master = True
    op_type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision=multi_precision)
        self._b1, self._b2, self._eps = beta1, beta2, epsilon

    def _attrs(self):
        return {"beta1": self._b1, "beta2": self._b2, "epsilon": self._eps}

    def _apply_one(self, p, g, lr_arr, attrs=None):
        accs = self._accs(p, {"m1": (p.shape, 0.0), "m2": (p.shape, 0.0),
                              "b1p": ((1,), self._b1),
                              "b2p": ((1,), self._b2)})
        ins = {"Param": [p._value], "Grad": [g], "Moment1": [accs["m1"]],
               "Moment2": [accs["m2"]], "Beta1Pow": [accs["b1p"]],
               "Beta2Pow": [accs["b2p"]], "LearningRate": [lr_arr]}
        master = self._mp_io(p, ins)
        out = get_op(self.op_type).fn(ins, attrs or self._attrs(),
                                      self._ctx)
        p._value = out["ParamOut"][0]
        accs["m1"], accs["m2"] = out["Moment1Out"][0], out["Moment2Out"][0]
        accs["b1p"], accs["b2p"] = out["Beta1PowOut"][0], \
            out["Beta2PowOut"][0]
        self._mp_write(p, out, master)


class AdamW(Adam):
    op_type = "adamw"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, apply_decay_param_fun=None,
                 multi_precision=False, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip,
                         multi_precision=multi_precision)
        self._decay_fun = apply_decay_param_fun

    def _attrs(self):
        return {**super()._attrs(),
                "coeff": float(self._weight_decay or 0.0)}

    def _apply_one(self, p, g, lr_arr, attrs=None):
        if self._decay_fun is not None and not self._decay_fun(p.name):
            # a parameter that opts out of decay: the same op, coeff 0
            attrs = {**super()._attrs(), "coeff": 0.0}
        super()._apply_one(p, g, lr_arr, attrs=attrs)


class Adagrad(_EagerOptimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None, **kw):
        super().__init__(learning_rate, parameters,
                         multi_precision=kw.get("multi_precision", False))
        self._eps = epsilon

    def _apply_one(self, p, g, lr_arr):
        accs = self._accs(p, {"moment": (p.shape, 0.0)})
        out = get_op("adagrad").fn(
            {"Param": [p._value], "Grad": [g], "Moment": [accs["moment"]],
             "LearningRate": [lr_arr]}, {"epsilon": self._eps}, self._ctx)
        p._value = out["ParamOut"][0]
        accs["moment"] = out["MomentOut"][0]


class RMSProp(_EagerOptimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, **kw):
        super().__init__(learning_rate, parameters,
                         multi_precision=kw.get("multi_precision", False))
        self._rho, self._eps = rho, epsilon
        self._mu, self._centered = momentum, centered

    def _apply_one(self, p, g, lr_arr):
        accs = self._accs(p, {"ms": (p.shape, 0.0), "mom": (p.shape, 0.0),
                              "mg": (p.shape, 0.0)})
        ins = {"Param": [p._value], "Grad": [g], "MeanSquare": [accs["ms"]],
               "Moment": [accs["mom"]], "LearningRate": [lr_arr]}
        if self._centered:
            ins["MeanGrad"] = [accs["mg"]]
        out = get_op("rmsprop").fn(
            ins, {"decay": self._rho, "epsilon": self._eps,
                  "momentum": self._mu, "centered": self._centered},
            self._ctx)
        p._value = out["ParamOut"][0]
        accs["ms"], accs["mom"] = out["MeanSquareOut"][0], out["MomentOut"][0]
        if self._centered:
            accs["mg"] = out["MeanGradOut"][0]


class Lamb(Adam):
    op_type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         multi_precision=kw.get("multi_precision", False))
        self._wd = lamb_weight_decay

    def _attrs(self):
        return {**super()._attrs(), "weight_decay": self._wd}


Optimizer = _EagerOptimizer


class Adadelta(_EagerOptimizer):
    """The adadelta op with its two running averages, the squared
    gradient and the squared update."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip,
                         multi_precision=kw.get("multi_precision", False))
        self._epsilon, self._rho = epsilon, rho

    def _apply_one(self, p, g, lr_arr=None):
        accs = self._accs(p, {"avg_sq": (p.shape, 0.0),
                              "avg_upd": (p.shape, 0.0)})
        outs = get_op("adadelta").fn(
            {"Param": [p._value], "Grad": [g],
             "AvgSquaredGrad": [accs["avg_sq"]],
             "AvgSquaredUpdate": [accs["avg_upd"]]},
            {"epsilon": self._epsilon, "rho": self._rho}, self._ctx)
        p._value = outs["ParamOut"][0]
        accs["avg_sq"] = outs["AvgSquaredGradOut"][0]
        accs["avg_upd"] = outs["AvgSquaredUpdateOut"][0]


class Adamax(_EagerOptimizer):
    """The adamax op; its ``Beta1Pow`` is a per-parameter accumulator
    advanced after each update."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip,
                         multi_precision=kw.get("multi_precision", False))
        self._b1, self._b2, self._eps = beta1, beta2, epsilon

    def _apply_one(self, p, g, lr_arr):
        accs = self._accs(p, {"moment": (p.shape, 0.0),
                              "inf_norm": (p.shape, 0.0),
                              "b1p": ((1,), self._b1)})
        outs = get_op("adamax").fn(
            {"Param": [p._value], "Grad": [g],
             "Moment": [accs["moment"]], "InfNorm": [accs["inf_norm"]],
             "LearningRate": [lr_arr], "Beta1Pow": [accs["b1p"]]},
            {"beta1": self._b1, "beta2": self._b2,
             "epsilon": self._eps}, self._ctx)
        p._value = outs["ParamOut"][0]
        accs["moment"] = outs["MomentOut"][0]
        accs["inf_norm"] = outs["InfNormOut"][0]
        accs["b1p"] = accs["b1p"] * self._b1
