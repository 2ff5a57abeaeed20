"""Optimizers: minimize = append_backward + per-param update ops
(counterpart of ``paddle_tpu/fluid/optimizer.py``, static mode, SGD,
Momentum and Adam, with ``grad_clip``; the other optimizers,
``regularization`` and ``multi_precision`` come with their slices).

The accumulator and learning-rate var names are the reference's
(``<Optimizer>_<acc>_<param>``, ``learning_rate_<n>``), so
``interop.scope_from_numpy`` carries the whole optimizer state across
packages by name.
"""
from __future__ import annotations

from typing import Dict, Optional

from .backward import append_backward
from .framework import Variable, program_guard, unique_name
from .layer_helper import LayerHelper
from . import layers


class Optimizer:
    def __init__(self, learning_rate=0.001, parameter_list=None,
                 regularization=None, grad_clip=None, name=None):
        if regularization is not None:
            raise NotImplementedError(
                "Optimizer(regularization=) is not ported yet")
        self._learning_rate = learning_rate
        self._parameter_list = parameter_list
        self._grad_clip = grad_clip     # a fluid.clip.GradientClip*
        self._name = name or type(self).__name__
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self._lr_var: Optional[Variable] = None
        self.helper = LayerHelper(self._name)

    # -- learning rate ------------------------------------------------------
    def _create_global_learning_rate(self):
        if self._lr_var is None:
            self._lr_var = layers.create_global_var(
                [1], float(self._learning_rate), "float32", persistable=True,
                name=unique_name("learning_rate"))

    # -- accumulators -------------------------------------------------------
    def _add_accumulator(self, name, param, fill_value=0.0, shape=None,
                         dtype=None):
        key = f"{self._name}_{name}_{param.name}"
        acc = layers.create_global_var(
            shape or list(param.shape), fill_value, dtype or param.dtype,
            persistable=True, name=key)
        self._accumulators.setdefault(name, {})[param.name] = acc
        return acc

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _create_accumulators(self, params):
        pass

    def _append_optimize_op(self, param, grad):
        raise NotImplementedError

    # -- main entry points --------------------------------------------------
    def backward(self, loss, parameter_list=None, no_grad_set=None):
        return append_backward(loss, parameter_list or self._parameter_list,
                               no_grad_set)

    def apply_gradients(self, params_grads):
        params_grads = sorted(params_grads, key=lambda pg: pg[0].name)
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._create_global_learning_rate()
        self._create_accumulators([p for p, g in params_grads])
        return [self._append_optimize_op(p, g) for p, g in params_grads
                if g is not None]

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        # ops append to the loss's program even outside its program_guard
        with program_guard(loss.block.program, startup_program):
            params_grads = self.backward(loss, parameter_list, no_grad_set)
            ops = self.apply_gradients(params_grads)
        return ops, params_grads


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, param, grad):
        return self.helper.append_op(
            "sgd",
            inputs={"Param": [param], "Grad": [grad],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [param]},
            attrs={"multi_precision": False})


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False,
                 **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, params):
        for p in params:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, param, grad):
        v = self._get_accumulator("velocity", param)
        return self.helper.append_op(
            "momentum",
            inputs={"Param": [param], "Grad": [grad], "Velocity": [v],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [param], "VelocityOut": [v]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov,
                   "multi_precision": False})


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, params):
        for p in params:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow", p, self._beta1, [1],
                                  dtype="float32")
            self._add_accumulator("beta2_pow", p, self._beta2, [1],
                                  dtype="float32")

    def _append_optimize_op(self, param, grad):
        m1 = self._get_accumulator("moment1", param)
        m2 = self._get_accumulator("moment2", param)
        b1p = self._get_accumulator("beta1_pow", param)
        b2p = self._get_accumulator("beta2_pow", param)
        return self.helper.append_op(
            "adam",
            inputs={"Param": [param], "Grad": [grad], "Moment1": [m1],
                    "Moment2": [m2], "Beta1Pow": [b1p], "Beta2Pow": [b2p],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [param], "Moment1Out": [m1],
                     "Moment2Out": [m2], "Beta1PowOut": [b1p],
                     "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "multi_precision": False})

