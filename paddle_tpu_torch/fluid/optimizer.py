"""Optimizers: minimize = append_backward + per-param update ops
(counterpart of ``paddle_tpu/fluid/optimizer.py``: the ``Optimizer``
base with ``regularization``, ``grad_clip``, ``multi_precision`` and a
learning rate that is a float, a Variable (an in-graph schedule) or a
callable, in static and in dygraph mode; the 20 optimizer classes and
their short aliases; and the ``BoxPSOptimizer`` facade).

In static mode the accumulator and learning-rate var names are the
reference's (``<Optimizer>_<acc>_<param>``, ``learning_rate_<n>``, the
fp32 masters ``<Optimizer>_master_weight_<param>``), so
``interop.scope_from_numpy`` carries the whole optimizer state across
packages by name.  In dygraph mode ``minimize`` takes the tape's
gradients of ``parameter_list`` and runs each parameter's update op
eagerly, one op a parameter, as the reference does.

``RecomputeOptimizer`` and ``PipelineOptimizer`` record the reference's
program hints (``recompute_checkpoints``, ``pipeline_microbatches``);
the port's executor computes the same values and does not act on them
yet (it neither rematerialises nor pipelines).
"""
from __future__ import annotations

from typing import Dict, List, Optional  # noqa: F401

import numpy as np
import torch

from . import framework
from .backward import append_backward
from .framework import (Program, Variable, Parameter,  # noqa: F401
                        in_dygraph_mode, unique_name, _dygraph_tracer,
                        default_main_program, default_startup_program)
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
    # subclasses whose update op takes MasterParam/MasterParamOut turn
    # this on; the rest refuse multi_precision=True
    _supports_multi_precision = False

    def __init__(self, learning_rate=0.001, parameter_list=None,
                 regularization=None, grad_clip=None, name=None,
                 multi_precision=False):
        if multi_precision and not self._supports_multi_precision:
            raise NotImplementedError(
                f"{type(self).__name__} has no fp32 master-weight path; "
                f"multi_precision=True is only supported on "
                f"SGD/Momentum/Adam/AdamW/Lamb")
        self._learning_rate = learning_rate
        self._parameter_list = parameter_list
        self.regularization = regularization
        self._grad_clip = grad_clip     # a fluid.clip.GradientClip*
        self._name = name or type(self).__name__
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self._lr_var: Optional[Variable] = None
        # fp32 master weights: a bf16 or fp16 parameter keeps a float32
        # copy that its update computes on (MasterParam), and the
        # parameter is that copy rounded
        self._multi_precision = bool(multi_precision)
        self.helper = LayerHelper(self._name)

    # -- learning rate ------------------------------------------------------
    def _create_global_learning_rate(self):
        """The learning-rate var: the Variable given (an in-graph
        schedule), what a callable builds, or a persistable var filled
        with the float."""
        if isinstance(self._learning_rate, Variable):
            self._lr_var = self._learning_rate
            return
        if callable(self._learning_rate):
            self._lr_var = self._learning_rate()
            return
        if self._lr_var is None:
            self._lr_var = layers.create_global_var(
                [1], float(self._learning_rate), "float32", persistable=True,
                name=unique_name("learning_rate"))

    @property
    def current_lr(self):
        return self._lr_var

    def set_lr(self, value):
        self._learning_rate = value

    # -- accumulators -------------------------------------------------------
    def _add_accumulator(self, name, param, fill_value=0.0, shape=None,
                         dtype=None):
        if in_dygraph_mode():
            from ..dygraph.base import VarBase
            accs = self._accumulators.setdefault(name, {})
            if param.name not in accs:
                accs[param.name] = VarBase(torch.full(
                    tuple(shape or param.shape), fill_value,
                    dtype=framework.torch_dtype(dtype) if dtype is not None
                    else param._value.dtype,
                    device=param._value.device), stop_gradient=True)
            return accs[param.name]
        key = f"{self._name}_{name}_{param.name}"
        if shape is None and any(int(d) < 0 for d in param.shape):
            # a parameter sized at run time (the BoxPS pass cache, shape
            # [-1, dim]): no startup fill; the executor fills the
            # accumulator at its parameter's runtime shape
            prog = framework.default_main_program()
            acc = prog.global_block().create_var(
                name=key, shape=tuple(param.shape),
                dtype=dtype or param.dtype, persistable=True)
            acc.stop_gradient = True
            prog._hints.setdefault("runtime_shaped_state", {})[key] = (
                param.name, float(fill_value))
        else:
            acc = layers.create_global_var(
                shape or list(param.shape), fill_value,
                dtype or param.dtype, persistable=True, name=key)
        self._accumulators.setdefault(name, {})[param.name] = acc
        return acc

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def state_var_names(self):
        """Every persistable var this optimizer owns in static mode: the
        accumulators, the beta powers, the fp32 masters and the
        learning-rate var."""
        names = {v.name for accs in self._accumulators.values()
                 for v in accs.values()
                 if isinstance(getattr(v, "name", None), str)}
        if isinstance(getattr(self._lr_var, "name", None), str):
            names.add(self._lr_var.name)
        return sorted(names)

    def state_dict(self):
        """``{name: numpy array}`` of every accumulator: a dygraph one
        from its VarBase, a static one from the global scope."""
        from .core import global_scope
        state = {}
        for acc_name, accs in self._accumulators.items():
            for param_name, var in accs.items():
                if hasattr(var, "_value"):
                    value = var._value
                    key = f"{self._name}_{acc_name}_{param_name}"
                else:
                    value, key = global_scope().find_var(var.name), var.name
                if torch.is_tensor(value):
                    value = value.detach().cpu().numpy()
                state[key] = np.asarray(value)
        return state

    # -- fp32 master weights ------------------------------------------------
    def _mp_active(self, param) -> bool:
        dtype = (str(param._value.dtype).removeprefix("torch.")
                 if hasattr(param, "_value") else param.dtype)
        return self._multi_precision and dtype in ("float16", "bfloat16")

    def _master_weight(self, param):
        """The fp32 master of a low-precision parameter, made from the
        parameter's value (a ``cast`` in the startup program, or at once
        in dygraph), not filled with zeros as accumulators are."""
        accs = self._accumulators.setdefault("master_weight", {})
        if param.name in accs:
            return accs[param.name]
        if in_dygraph_mode():
            from ..dygraph.base import VarBase
            accs[param.name] = VarBase(param._value.float(),
                                       stop_gradient=True)
            return accs[param.name]
        key = f"{self._name}_master_weight_{param.name}"
        var = default_main_program().global_block().create_var(
            name=key, shape=list(param.shape or []), dtype="float32",
            persistable=True, stop_gradient=True)
        sb = default_startup_program().global_block()
        sb.create_var(name=key, shape=list(param.shape or []),
                      dtype="float32", persistable=True)
        sb.append_op("cast", inputs={"X": [param.name]},
                     outputs={"Out": [key]},
                     attrs={"out_dtype": "float32"})
        accs[param.name] = var
        return var

    def _mp_io(self, param, inputs, outputs):
        """Wire MasterParam/MasterParamOut into an update op's slots when
        multi_precision applies to this param."""
        if self._mp_active(param):
            master = self._master_weight(param)
            inputs["MasterParam"] = [master]
            outputs["MasterParamOut"] = [master]
        return inputs, outputs

    def _acc_dtype(self, param):
        """Moments follow the compute dtype: float32 under
        multi_precision, the parameter's otherwise."""
        return "float32" if self._mp_active(param) else None

    # -- main entry points --------------------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list or self._parameter_list,
                               no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        """Clip, then regularize (so the decay is not in the clipped
        norm, as in the reference), then one update op a parameter."""
        params_grads = sorted(params_grads, key=lambda pg: pg[0].name)
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        params_grads = self._append_regularization(params_grads)
        self._create_global_learning_rate()
        self._create_accumulators([p for p, g in params_grads])
        return [self._append_optimize_op(p, g) for p, g in params_grads
                if g is not None]

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        if in_dygraph_mode():
            return self._minimize_dygraph(loss, parameter_list)
        # ops append to the loss's program even outside its program_guard
        with framework.program_guard(loss.block.program, startup_program):
            params_grads = self.backward(loss, startup_program,
                                         parameter_list, no_grad_set)
            ops = self.apply_gradients(params_grads)
        return ops, params_grads

    def _append_regularization(self, params_grads):
        out = []
        for p, g in params_grads:
            reg = getattr(p, "regularizer", None) or self.regularization
            out.append((p, g) if reg is None or g is None
                       else (p, reg._append(p, g)))
        return out

    def _minimize_dygraph(self, loss, parameter_list=None):
        """The tape's gradients of the parameter list (``loss.backward()``
        first only when no parameter has one), clipped, regularized, then
        each subclass's ``_append_optimize_op`` run eagerly through
        ``_EagerOptHelper``, which writes ParamOut and the accumulators'
        outputs back into their VarBases.  Returns ``(None,
        params_grads)``."""
        from ..dygraph.base import VarBase
        from .regularizer import L1DecayRegularizer

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
        # the raw gradients are clipped, then the decay added, as in
        # apply_gradients
        if self._grad_clip is not None:
            params_grads = self._clip_eager(params_grads)
        regged = []
        for p, g in params_grads:
            reg = getattr(p, "regularizer", None) or self.regularization
            if reg is not None:
                term = torch.sign(p._value) \
                    if isinstance(reg, L1DecayRegularizer) else p._value
                g = VarBase(g._value + reg._coeff * term, stop_gradient=True)
            regged.append((p, g))
        params_grads = regged
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

    # -- hooks for subclasses ----------------------------------------------
    def _create_accumulators(self, params):
        pass

    def _append_optimize_op(self, param, grad):
        raise NotImplementedError

    def clear_gradients(self):
        for p in (self._parameter_list or []):
            p.clear_gradient()


class SGDOptimizer(Optimizer):
    _supports_multi_precision = True

    def _append_optimize_op(self, param, grad):
        ins, outs = self._mp_io(
            param, {"Param": [param], "Grad": [grad],
                    "LearningRate": [self._lr_var]},
            {"ParamOut": [param]})
        return self.helper.append_op(
            "sgd", inputs=ins, outputs=outs,
            attrs={"multi_precision": self._mp_active(param)})


class MomentumOptimizer(Optimizer):
    _supports_multi_precision = True

    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False,
                 **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, params):
        for p in params:
            self._add_accumulator("velocity", p, dtype=self._acc_dtype(p))

    def _append_optimize_op(self, param, grad):
        v = self._get_accumulator("velocity", param)
        ins, outs = self._mp_io(
            param, {"Param": [param], "Grad": [grad], "Velocity": [v],
                    "LearningRate": [self._lr_var]},
            {"ParamOut": [param], "VelocityOut": [v]})
        return self.helper.append_op(
            "momentum", inputs=ins, outputs=outs,
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov,
                   "multi_precision": self._mp_active(param)})


class LarsMomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, params):
        for p in params:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, param, grad):
        v = self._get_accumulator("velocity", param)
        return self.helper.append_op(
            "lars_momentum",
            inputs={"Param": [param], "Grad": [grad], "Velocity": [v],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [param], "VelocityOut": [v]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay})


class AdamOptimizer(Optimizer):
    """Adam; ``lazy_mode`` is accepted, as in the reference, where the
    dense gradients of this port leave nothing for it to skip."""

    _supports_multi_precision = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lazy_mode = lazy_mode

    def _create_accumulators(self, params):
        for p in params:
            self._add_accumulator("moment1", p, dtype=self._acc_dtype(p))
            self._add_accumulator("moment2", p, dtype=self._acc_dtype(p))
            self._add_accumulator("beta1_pow", p, self._beta1, [1],
                                  dtype="float32")
            self._add_accumulator("beta2_pow", p, self._beta2, [1],
                                  dtype="float32")

    def _append_optimize_op(self, param, grad):
        m1 = self._get_accumulator("moment1", param)
        m2 = self._get_accumulator("moment2", param)
        b1p = self._get_accumulator("beta1_pow", param)
        b2p = self._get_accumulator("beta2_pow", param)
        ins, outs = self._mp_io(
            param,
            {"Param": [param], "Grad": [grad], "Moment1": [m1],
             "Moment2": [m2], "Beta1Pow": [b1p], "Beta2Pow": [b2p],
             "LearningRate": [self._lr_var]},
            {"ParamOut": [param], "Moment1Out": [m1], "Moment2Out": [m2],
             "Beta1PowOut": [b1p], "Beta2PowOut": [b2p]})
        attrs = dict(self._op_attrs(),
                     multi_precision=self._mp_active(param))
        return self.helper.append_op(self._op_type(), inputs=ins,
                                     outputs=outs, attrs=attrs)

    def _op_type(self):
        return "adam"

    def _op_attrs(self):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon}


class AdamWOptimizer(AdamOptimizer):
    def __init__(self, learning_rate=0.001, weight_decay=0.01, **kw):
        super().__init__(learning_rate, **kw)
        self._coeff = weight_decay

    def _op_type(self):
        return "adamw"

    def _op_attrs(self):
        return {**super()._op_attrs(), "coeff": self._coeff}


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon

    def _create_accumulators(self, params):
        for p in params:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, param, grad):
        m = self._get_accumulator("moment", param)
        return self.helper.append_op(
            "adagrad",
            inputs={"Param": [param], "Grad": [grad], "Moment": [m],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [param], "MomentOut": [m]},
            attrs={"epsilon": self._epsilon})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, params):
        for p in params:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("moment", p)
            if self._centered:
                self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, param, grad):
        ins = {"Param": [param], "Grad": [grad],
               "MeanSquare": [self._get_accumulator("mean_square", param)],
               "Moment": [self._get_accumulator("moment", param)],
               "LearningRate": [self._lr_var]}
        outs = {"ParamOut": [param], "MeanSquareOut": ins["MeanSquare"],
                "MomentOut": ins["Moment"]}
        if self._centered:
            ins["MeanGrad"] = [self._get_accumulator("mean_grad", param)]
            outs["MeanGradOut"] = ins["MeanGrad"]
        return self.helper.append_op(
            "rmsprop", inputs=ins, outputs=outs,
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered})


class LambOptimizer(AdamOptimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, **kw):
        super().__init__(learning_rate, beta1=beta1, beta2=beta2,
                         epsilon=epsilon, **kw)
        self._weight_decay = lamb_weight_decay

    def _op_type(self):
        return "lamb"

    def _op_attrs(self):
        return {**super()._op_attrs(), "weight_decay": self._weight_decay}


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, params):
        for p in params:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, param, grad):
        sq = self._get_accumulator("squared", param)
        lin = self._get_accumulator("linear", param)
        return self.helper.append_op(
            "ftrl",
            inputs={"Param": [param], "Grad": [grad],
                    "SquaredAccumulator": [sq], "LinearAccumulator": [lin],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [param], "SquaredAccumOut": [sq],
                     "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


class DpsgdOptimizer(Optimizer):
    def __init__(self, learning_rate, clip=10.0, batch_size=16.0,
                 sigma=1.0, **kw):
        super().__init__(learning_rate, **kw)
        self._clip, self._sigma = clip, sigma

    def _append_optimize_op(self, param, grad):
        return self.helper.append_op(
            "dpsgd",
            inputs={"Param": [param], "Grad": [grad],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [param]},
            attrs={"clip": self._clip, "sigma": self._sigma,
                   "op_seed": default_main_program().next_op_seed()})


class ExponentialMovingAverage:
    """The EMA of the parameters in the global scope: ``update()`` after
    a step, ``apply()`` swaps the averages in, ``restore()`` swaps the
    parameters back."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._shadow = {}
        self._backup = {}

    def update(self):
        from .core import global_scope
        scope = global_scope()
        for p in default_main_program().all_parameters():
            val = scope.find_var(p.name)
            if val is None:
                continue
            prev = self._shadow.get(p.name, val)
            self._shadow[p.name] = (self._decay * prev
                                    + (1 - self._decay) * val)

    def apply(self, executor=None, need_restore=True):
        from .core import global_scope
        scope = global_scope()
        for name, val in self._shadow.items():
            self._backup[name] = scope.find_var(name)
            scope.set_var(name, val)
        return _EmaGuard(self)

    def restore(self, executor=None):
        from .core import global_scope
        scope = global_scope()
        for name, val in self._backup.items():
            scope.set_var(name, val)
        self._backup = {}


class _EmaGuard:
    def __init__(self, ema):
        self.ema = ema

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.ema.restore()
        return False


class ModelAverage(Optimizer):
    """Sliding-window parameter averaging (average_accumulates_op.h).
    Made after the training optimizer's ``minimize``, it appends one
    ``average_accumulates`` op a parameter; ``apply()`` swaps each
    parameter for (sum_1 + sum_2 + sum_3) / (num_accumulates +
    old_num_accumulates), ``restore()`` swaps it back."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, **kw):
        super().__init__(0.0, **kw)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self._backup = {}
        self._params = [p for p in default_main_program().all_parameters()
                        if getattr(p, "do_model_average", None) is not False]
        for p in self._params:
            self._append_average_accumulate_op(p)

    def _append_average_accumulate_op(self, param):
        s1 = self._add_accumulator("sum_1", param)
        s2 = self._add_accumulator("sum_2", param)
        s3 = self._add_accumulator("sum_3", param)
        na = self._add_accumulator("num_accumulates", param, 0.0, [1])
        ona = self._add_accumulator("old_num_accumulates", param, 0.0, [1])
        nu = self._add_accumulator("num_updates", param, 0.0, [1])
        return self.helper.append_op(
            "average_accumulates",
            inputs={"param": [param], "in_sum_1": [s1], "in_sum_2": [s2],
                    "in_sum_3": [s3], "in_num_accumulates": [na],
                    "in_old_num_accumulates": [ona], "in_num_updates": [nu]},
            outputs={"out_sum_1": [s1], "out_sum_2": [s2], "out_sum_3": [s3],
                     "out_num_accumulates": [na],
                     "out_old_num_accumulates": [ona],
                     "out_num_updates": [nu]},
            attrs={"average_window": self.average_window,
                   "min_average_window": self.min_average_window,
                   "max_average_window": self.max_average_window})

    def _append_optimize_op(self, param, grad):
        return None

    def _acc(self, kind, param, scope):
        return scope.find_var(self._accumulators[kind][param.name].name)

    def apply(self, executor=None, need_restore=True):
        from .core import global_scope
        scope = global_scope()
        for p in self._params:
            cur = scope.find_var(p.name)
            if cur is None:
                continue
            s = (self._acc("sum_1", p, scope) + self._acc("sum_2", p, scope)
                 + self._acc("sum_3", p, scope))
            n = (self._acc("num_accumulates", p, scope).reshape(-1)[0]
                 + self._acc("old_num_accumulates", p,
                             scope).reshape(-1)[0])
            if float(n) > 0:
                if need_restore:
                    self._backup[p.name] = cur.clone()
                scope.set_var(p.name, (s / n).to(cur.dtype))
        return _EmaGuard(self)

    def restore(self, executor=None):
        from .core import global_scope
        scope = global_scope()
        for name, val in self._backup.items():
            scope.set_var(name, val)
        self._backup = {}


class RecomputeOptimizer(Optimizer):
    """An optimizer with recompute checkpoints.  The checkpoints are
    recorded as the program's ``recompute_checkpoints`` hint, as in the
    reference; the port's executor does not rematerialise yet, so the
    values are those of the plain program."""

    def __init__(self, optimizer):
        self._optimizer = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = checkpoints

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        loss.block.program._hints["recompute_checkpoints"] = [
            v.name if isinstance(v, Variable) else v
            for v in (self._checkpoints or [])]
        return self._optimizer.backward(loss, startup_program,
                                        parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        pg = self.backward(loss, startup_program, parameter_list,
                           no_grad_set)
        return self._optimizer.apply_gradients(pg), pg


class GradientMergeOptimizer(Optimizer):
    """Accumulate the gradients over ``k_steps`` runs, then apply them
    (averaged with ``avg``).  The inner update ops carry a ``SkipUpdate``
    input that holds every output at its old value on the other runs,
    so Adam's moments and powers advance only on applying runs."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        self._inner = inner_optimizer
        self._k = k_steps
        self._avg = avg

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        if self._k <= 1:
            return self._inner.minimize(loss, startup_program,
                                        parameter_list, no_grad_set)
        pg = self._inner.backward(loss, startup_program, parameter_list,
                                  no_grad_set)
        step = layers.create_global_var([1], 0.0, "float32",
                                        persistable=True,
                                        name=unique_name("gm_step"))
        LayerHelper("gradient_merge").append_op(
            "increment", inputs={"X": [step]}, outputs={"Out": [step]},
            attrs={"step": 1.0})
        merged = []
        for p, g in pg:
            acc = layers.create_global_var(list(p.shape), 0.0, p.dtype,
                                           persistable=True,
                                           name=unique_name("gm_acc"))
            layers.assign(layers.sums([acc, g]), acc)
            merged.append((p, acc))
        k_const = layers.fill_constant([1], "float32", float(self._k))
        skip_v = layers.less_than(step, k_const)
        gate = 1.0 - layers.cast(skip_v, "float32")
        scale = 1.0 / self._k if self._avg else 1.0
        applied_pg = [(p, layers.scale(a, scale=scale)) for p, a in merged]
        ops = self._inner.apply_gradients(applied_pg)
        for op in ops:
            if op is not None and hasattr(op, "inputs"):
                op.inputs["SkipUpdate"] = [skip_v.name]
        # reset: acc *= (1 - gate); step *= (1 - gate)
        for p, a in merged:
            layers.assign(a * (1.0 - gate), a)
        layers.assign(step * (1.0 - gate), step)
        return ops, applied_pg


class LookaheadOptimizer:
    """Lookahead: the fast weights step every run; every ``k`` runs the
    slow weights move ``alpha`` of the way to the fast ones and the fast
    weights reset to them.  The gate is a 0/1 blend on both copies."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        assert inner_optimizer is not None
        assert 0.0 <= alpha <= 1.0
        assert k >= 1
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k

    def minimize(self, loss, startup_program=None):
        ops, pg = self.inner_optimizer.minimize(loss, startup_program)
        step = layers.create_global_var([1], 0.0, "float32",
                                        persistable=True,
                                        name=unique_name("la_step"))
        LayerHelper("lookahead").append_op(
            "increment", inputs={"X": [step]}, outputs={"Out": [step]},
            attrs={"step": 1.0})
        k_const = layers.fill_constant([1], "float32", float(self.k))
        from .layers.control_flow import greater_equal
        gate = layers.cast(greater_equal(step, k_const), "float32")
        sb = default_startup_program().global_block()
        for p, g in pg:
            slow = layers.create_global_var(
                list(p.shape), 0.0, p.dtype, persistable=True,
                name=unique_name(p.name + "_la_slow"))
            # the slow weights start at the initial parameters
            sb.append_op("assign", inputs={"X": [p.name]},
                         outputs={"Out": [slow.name]})
            delta = layers.scale(p - slow, scale=self.alpha)
            new_slow = slow + delta * gate
            layers.assign(new_slow, slow)
            layers.assign(p + (new_slow - p) * gate, p)
        layers.assign(step * (1.0 - gate), step)
        return ops, pg


class PipelineOptimizer:
    """The pipeline optimizer's facade: ``num_microbatches`` is recorded
    as the program's ``pipeline_microbatches`` hint, as in the reference,
    and ``minimize`` delegates.  The port's executor runs the program
    whole (it does not pipeline yet), which gives the same values."""

    def __init__(self, optimizer, num_microbatches=1, start_cpu_core_id=0):
        self._optimizer = optimizer
        self._num_microbatches = num_microbatches

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        loss.block.program._hints["pipeline_microbatches"] = \
            self._num_microbatches
        return self._optimizer.minimize(loss, startup_program,
                                        parameter_list, no_grad_set)


class DGCMomentumOptimizer(Optimizer):
    """Deep Gradient Compression momentum (dgc_momentum_op.cc): plain
    momentum before ``rampup_begin_step``, then momentum correction and
    top-k masking with error feedback."""

    def __init__(self, learning_rate, momentum=0.9, rampup_begin_step=0,
                 rampup_step=1, sparsity=None, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._rampup_begin_step = rampup_begin_step
        self._sparsity = (sparsity or [0.999])[-1]
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, params):
        for p in params:
            self._add_accumulator("dgc_u", p)
            self._add_accumulator("dgc_v", p)
        self._step_var = layers.create_global_var(
            [1], 0.0, "float32", persistable=True,
            name=unique_name("dgc_step"))

    def _append_optimize_op(self, param, grad):
        u = self._get_accumulator("dgc_u", param)
        v = self._get_accumulator("dgc_v", param)
        return self.helper.append_op(
            "dgc_momentum",
            inputs={"Param": [param], "Grad": [grad], "U": [u], "V": [v],
                    "LearningRate": [self._lr_var],
                    "CurrentStep": [self._step_var]},
            outputs={"ParamOut": [param], "UOut": [u], "VOut": [v]},
            attrs={"mu": self._momentum, "sparsity": self._sparsity,
                   "rampup_begin_step": float(self._rampup_begin_step),
                   "use_nesterov": self._use_nesterov, "ring_id": 0})

    def apply_gradients(self, params_grads):
        ops = super().apply_gradients(params_grads)
        self.helper.append_op("increment", inputs={"X": [self._step_var]},
                              outputs={"Out": [self._step_var]},
                              attrs={"step": 1.0})
        return ops


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, params):
        for p in params:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow", p, self._beta1, [1])

    def _append_optimize_op(self, param, grad):
        m = self._get_accumulator("moment", param)
        u = self._get_accumulator("inf_norm", param)
        b1p = self._get_accumulator("beta1_pow", param)
        op = self.helper.append_op(
            "adamax",
            inputs={"Param": [param], "Grad": [grad], "Moment": [m],
                    "InfNorm": [u], "Beta1Pow": [b1p],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [param], "MomentOut": [m],
                     "InfNormOut": [u]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})
        # the power advances in its own scale op, as in the reference
        self.helper.append_op("scale", inputs={"X": [b1p]},
                              outputs={"Out": [b1p]},
                              attrs={"scale": self._beta1})
        return op


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, params):
        for p in params:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, param, grad):
        g2 = self._get_accumulator("avg_squared_grad", param)
        u2 = self._get_accumulator("avg_squared_update", param)
        return self.helper.append_op(
            "adadelta",
            inputs={"Param": [param], "Grad": [grad],
                    "AvgSquaredGrad": [g2], "AvgSquaredUpdate": [u2]},
            outputs={"ParamOut": [param], "AvgSquaredGradOut": [g2],
                     "AvgSquaredUpdateOut": [u2]},
            attrs={"rho": self._rho, "epsilon": self._epsilon})


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, params):
        for p in params:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, param, grad):
        m = self._get_accumulator("moment", param)
        return self.helper.append_op(
            "decayed_adagrad",
            inputs={"Param": [param], "Grad": [grad], "Moment": [m],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [param], "MomentOut": [m]},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


# the short aliases the reference exports
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Adamax = AdamaxOptimizer
Dpsgd = DpsgdOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
LarsMomentum = LarsMomentumOptimizer
Lamb = LambOptimizer


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
