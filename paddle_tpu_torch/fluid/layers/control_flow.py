"""Comparison layers (counterpart of the comparison half of
``paddle_tpu/fluid/layers/control_flow.py``; only ``less_than``, which
the decode programs build).  ``cond``, ``while_loop`` and the tensor
arrays are not ported yet."""
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
