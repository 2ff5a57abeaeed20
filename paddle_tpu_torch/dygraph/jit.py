"""dygraph-to-static bridge (counterpart of ``paddle_tpu/dygraph/jit.py``).

Reference: python/paddle/fluid/dygraph/jit.py ``@declarative:160`` +
ProgramTranslator (dygraph_to_static/program_translator.py:729), which
AST-rewrites Python into a Program executed by RunProgramOp
(operators/run_program_op.cc).  ``declarative`` (jit_static.py) runs a
function as one ``run_program`` op: one tape entry whose backward is the
forward's own ``torch.func.vjp``.

``TracedLayer`` is the inference path of a layer: its functionalized
forward (dygraph/functional.py) over the parameter values it captured,
bound by name.  There is no capture: each call runs the layer's ops.
"""
from __future__ import annotations

from .base import VarBase


from .jit_static import StaticFunction, declarative, to_static  # noqa: F401


class TracedLayer:
    """A layer's forward over the parameter values taken at ``trace``
    (fluid/dygraph/jit.py TracedLayer)."""

    def __init__(self, layer, fn, example_inputs):
        self._layer = layer
        self._fn = fn
        self._example_inputs = example_inputs

    @staticmethod
    def trace(layer, inputs):
        """(outputs, TracedLayer) of ``layer`` on ``inputs``.  The values
        are bound to the parameters by name (the reference zips
        ``named_parameters()`` with a name-sorted dict, which binds them
        out of order)."""
        from .functional import functionalize

        by_name = {name: p._value for name, p in layer.named_parameters()}
        order = {id(p): name for name, p in layer.named_parameters()}
        _, fn = functionalize(layer)
        bound = [by_name[order[id(p)]] for p in layer.parameters()]

        def call(*xs):
            return fn(bound, *xs)

        example = [x._value if isinstance(x, VarBase) else x for x in inputs]
        traced = TracedLayer(layer, call, example)
        out = traced(*inputs)
        outs = out if isinstance(out, list) else [out]
        return outs if len(outs) > 1 else outs[0], traced

    def __call__(self, *inputs):
        from .base import _as_tensor
        out = self._fn(*[x._value if isinstance(x, VarBase)
                         else _as_tensor(x) for x in inputs])
        if isinstance(out, (list, tuple)):
            return [VarBase(o) for o in out]
        return VarBase(out)

    def save_inference_model(self, dirname, feed=None, fetch=None):
        """The layer's state, numpy arrays by name, in the reference's
        ``traced_layer.pkl``."""
        import os
        import pickle
        os.makedirs(dirname, exist_ok=True)
        with open(f"{dirname}/traced_layer.pkl", "wb") as f:
            pickle.dump({"state": self._layer.state_dict()}, f)


def dygraph_to_static_func(function):
    """reference dygraph/jit.py dygraph_to_static_func: convert for use
    inside a STATIC program build (declarative's static-mode sibling)."""
    from .dygraph_to_static.program_translator import convert_to_static
    return convert_to_static(function)


from .dygraph_to_static.logging_utils import (set_code_level,  # noqa: E402
                                              set_verbosity)


def not_to_static(func=None):
    from ..jit import not_to_static as _n
    return _n(func)
