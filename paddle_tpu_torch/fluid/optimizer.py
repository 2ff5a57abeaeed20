"""Optimizers: minimize = append_backward + per-param update ops
(counterpart of ``paddle_tpu/fluid/optimizer.py``: SGD, Momentum and
Adam, with ``grad_clip``, in static and in dygraph mode, where the
learning rate may be a 1.x decay, and the ``BoxPSOptimizer`` facade; the
other optimizers, ``regularization`` and ``multi_precision`` come with
their slices).

In static mode the accumulator and learning-rate var names are the
reference's (``<Optimizer>_<acc>_<param>``, ``learning_rate_<n>``), so
``interop.scope_from_numpy`` carries the whole optimizer state across
packages by name.  In dygraph mode ``minimize`` takes the tape's
gradients of ``parameter_list`` and runs each parameter's update op
eagerly, one op a parameter, as the reference does.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .backward import append_backward
from .framework import (Variable, in_dygraph_mode, program_guard,
                        unique_name, _dygraph_tracer)
from .layer_helper import LayerHelper
from . import layers


class _EagerOptHelper:
    """LayerHelper stand-in for dygraph ``minimize``: runs an optimizer
    op's lowering eagerly and writes each output into the VarBase passed
    in that output slot (the in-place update), in that VarBase's dtype."""

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        from ..ops.registry import get_op
        ins = {s: [v._value for v in vs]
               for s, vs in (inputs or {}).items() if vs}
        outs = get_op(type).fn(ins, attrs or {}, _dygraph_tracer()._ctx())
        for slot, vbs in (outputs or {}).items():
            for vb, t in zip(vbs, outs.get(slot) or []):
                vb._value = t.to(vb._value.dtype)
        return outs


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
        if in_dygraph_mode():
            from ..dygraph.base import VarBase
            from .framework import torch_dtype
            accs = self._accumulators.setdefault(name, {})
            if param.name not in accs:
                accs[param.name] = VarBase(torch.full(
                    tuple(shape or param.shape), fill_value,
                    dtype=torch_dtype(dtype) if dtype is not None
                    else param._value.dtype,
                    device=param._value.device), stop_gradient=True)
            return accs[param.name]
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
        if in_dygraph_mode():
            return self._minimize_dygraph(loss, parameter_list)
        # ops append to the loss's program even outside its program_guard
        with program_guard(loss.block.program, startup_program):
            params_grads = self.backward(loss, parameter_list, no_grad_set)
            ops = self.apply_gradients(params_grads)
        return ops, params_grads

    def _minimize_dygraph(self, loss, parameter_list=None):
        """The tape's gradients of the parameter list (``loss.backward()``
        first only when no parameter has one), clipped, then each
        subclass's ``_append_optimize_op`` run eagerly through
        ``_EagerOptHelper``, which writes ParamOut and the accumulators'
        outputs back into their VarBases.  Returns ``(None,
        params_grads)``."""
        from ..dygraph.base import VarBase

        params = list(parameter_list or self._parameter_list or [])
        if not params:
            raise ValueError(
                "fluid Optimizer.minimize in dygraph mode needs parameters: "
                "construct the optimizer with parameter_list=layer"
                ".parameters()")
        if all(p.gradient_var is None for p in params):
            loss.backward()
        params_grads = [(p, VarBase(p.gradient_var, stop_gradient=True))
                        for p in params
                        if p.gradient_var is not None
                        and getattr(p, "trainable", True)]
        regularized = [p.name for p, _ in params_grads
                       if getattr(p, "regularizer", None) is not None]
        if regularized:
            raise NotImplementedError(
                f"ParamAttr(regularizer=) is not ported yet (parameters "
                f"{regularized[:3]})")
        # the raw gradients are clipped, as in apply_gradients
        if self._grad_clip is not None:
            params_grads = self._clip_eager(params_grads)
        lr = self._learning_rate
        # a 1.x decay (dygraph/learning_rate_scheduler.py) is a callable
        # read at every step, as in the reference
        lr = lr() if callable(lr) else lr
        lr = float(getattr(lr, "_value", lr))
        saved_helper, saved_lr = self.helper, self._lr_var
        self.helper = _EagerOptHelper()
        self._lr_var = VarBase(torch.tensor([lr], dtype=torch.float32,
                                            device=params[0]._value.device),
                               stop_gradient=True)
        try:
            self._create_accumulators([p for p, _ in params_grads])
            for p, g in params_grads:
                self._append_optimize_op(p, g)
        finally:
            self.helper, self._lr_var = saved_helper, saved_lr
        return None, params_grads

    def _clip_eager(self, params_grads):
        """``grad_clip`` on the tape's gradients, by the reference's
        eager formulas."""
        from ..dygraph.base import VarBase
        from .clip import clip_eager
        gs = clip_eager(self._grad_clip, [g._value for _, g in params_grads])
        if gs is None:
            return params_grads
        return [(p, VarBase(g, stop_gradient=True))
                for (p, _), g in zip(params_grads, gs)]

    def clear_gradients(self):
        for p in (self._parameter_list or []):
            p.clear_gradient()


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



class BoxPSOptimizer:
    """The BoxPS pipeline optimizer facade (reference optimizer.py:5194).
    The reference splits the program at ``cut_list`` into host and device
    sections with per-section thread pools; here the device section is
    the executor's step and the host sections are the BoxPS pass
    machinery (``Executor.train_passes``' double-buffered begin and end
    pass, the trainer's feed prefetcher).  ``cut_list`` is recorded as
    the ``boxps_pipeline`` hint, as the reference records it; the
    section knobs have nothing to set here and raise
    ``NotImplementedError`` unless left at their defaults.  ``minimize``
    delegates to the inner optimizer."""

    def __init__(self, optimizer, cut_list=None, place_list=None,
                 concurrency_list=None, queue_size=30, sync_steps=1,
                 start_cpu_core_id=0):
        given = {"place_list": (place_list, None),
                 "concurrency_list": (concurrency_list, None),
                 "queue_size": (queue_size, 30),
                 "sync_steps": (sync_steps, 1),
                 "start_cpu_core_id": (start_cpu_core_id, 0)}
        unported = [k for k, (v, d) in given.items() if v != d]
        if unported:
            raise NotImplementedError(
                f"BoxPSOptimizer({', '.join(unported)}=...): the port runs "
                f"no per-section thread pools, so these knobs have nothing "
                f"to set; leave them at their defaults")
        self._optimizer = optimizer
        self._cut_list = cut_list or []

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        prog = loss.block.program
        prog._hints["boxps_pipeline"] = {"cuts": len(self._cut_list)}
        return self._optimizer.minimize(loss, startup_program,
                                        parameter_list, no_grad_set)
