"""Comparison and logical layers (counterpart of that half of
``paddle_tpu/fluid/layers/control_flow.py``).  ``cond``, ``while_loop``
and the tensor arrays are not ported yet."""
from __future__ import annotations

from ..framework import in_dygraph_mode
from ..layer_helper import LayerHelper


def less_than(x, y, force_cpu=None, cond=None):
    return _cmp("less_than", x, y, cond)


def _cmp(op_type, x, y, out=None):
    helper = LayerHelper(op_type)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype="bool",
                                                        stop_gradient=True)
    op = helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                          outputs={"Out": [out]})
    return op["Out"][0] if in_dygraph_mode() else out


def equal(x, y, cond=None):
    return _cmp("equal", x, y, cond)


def is_empty(x, name=None):
    helper = LayerHelper("is_empty")
    out = helper.create_variable_for_type_inference(dtype="bool")
    op = helper.append_op("is_empty", inputs={"X": [x]},
                          outputs={"Out": [out]}, attrs={})
    return op["Out"][0] if in_dygraph_mode() else out
