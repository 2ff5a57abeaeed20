"""Functionalize a dygraph Layer: a pure ``(params, *inputs) -> outputs``
function (counterpart of ``paddle_tpu/dygraph/functional.py``).

With parameter values passed as arguments, a model's eager op stream is
a function ``torch.func.grad`` and ``torch.func.grad_and_value`` can
differentiate, as ``jax.value_and_grad`` differentiates it in the
reference: the flagship training step is
``torch.func.grad_and_value(fn)(params, ids, mlm_labels, nsp_labels)``.

Buffers are not arguments: ``fn`` saves each buffer's tensor before the
call and puts it back after, as it does the parameters.  A batch norm's
``set_value`` of its moving statistics inside the transform would
otherwise leave a transform's wrapped tensor bound to the live model,
and the next call or an eval forward would read a dead wrapper.  So a
functional step leaves the moving statistics where they were; the
reference's loss and gradients are the same, and its statistics do not
advance either (its jit leaves tracers in them).  The eager loop,
``loss.backward()`` and ``Optimizer.minimize``, advances them.
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
    model) with the tape off, and restores the parameters' and buffers'
    own values.  Inputs are tensors; outputs are tensors or tuples of
    them."""
    params = model.parameters()
    buffers = [b for b in model.buffers() if b is not None]
    call = method if method is not None else model

    def fn(param_values, *tensors):
        if len(param_values) != len(params):
            raise ValueError(
                f"expected {len(params)} parameter values, got "
                f"{len(param_values)}")
        saved = [p._value for p in params]
        saved_buffers = [b._value for b in buffers]
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
            for b, v in zip(buffers, saved_buffers):
                b._value = v

    return [p._value for p in params], fn


def functional_loss(model, loss_fn) -> Tuple[List[torch.Tensor], Callable]:
    """``functionalize`` with ``loss_fn(*inputs) -> scalar loss`` (which
    closes over the model) as the method: the target of
    ``torch.func.grad_and_value`` for a whole-model training step."""
    return functionalize(model, method=loss_fn)
