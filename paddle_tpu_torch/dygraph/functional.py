"""Functionalize a dygraph Layer: a pure ``(params, *inputs) -> outputs``
function (counterpart of ``paddle_tpu/dygraph/functional.py``).

With parameter values passed as arguments, a model's eager op stream is
a function ``torch.func.grad`` and ``torch.func.grad_and_value`` can
differentiate, as ``jax.value_and_grad`` differentiates it in the
reference: the flagship training step is
``torch.func.grad_and_value(fn)(params, ids, mlm_labels, nsp_labels)``.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from .base import VarBase, to_variable, no_grad_ctx


def _unwrap(x):
    if isinstance(x, VarBase):
        return x.value()
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(v) for v in x)
    return x


def functionalize(model, method: Callable = None
                  ) -> Tuple[List[torch.Tensor], Callable]:
    """(param_values, fn): ``fn(param_values, *tensors)`` binds the
    values to the model's parameters, runs ``method`` (default: the
    model) with the tape off, and restores the parameters' own values.
    Inputs are tensors; outputs are tensors or tuples of them."""
    params = model.parameters()
    call = method if method is not None else model

    def fn(param_values, *tensors):
        if len(param_values) != len(params):
            raise ValueError(
                f"expected {len(params)} parameter values, got "
                f"{len(param_values)}")
        saved = [p._value for p in params]
        try:
            for p, v in zip(params, param_values):
                p._value = v
            with no_grad_ctx():
                out = call(*[to_variable(t) for t in tensors])
            return _unwrap(out)
        finally:
            # the transform's wrapped tensors must not stay bound to the
            # live model
            for p, v in zip(params, saved):
                p._value = v

    return [p._value for p in params], fn


def functional_loss(model, loss_fn) -> Tuple[List[torch.Tensor], Callable]:
    """``functionalize`` with ``loss_fn(*inputs) -> scalar loss`` (which
    closes over the model) as the method: the target of
    ``torch.func.grad_and_value`` for a whole-model training step."""
    return functionalize(model, method=loss_fn)
