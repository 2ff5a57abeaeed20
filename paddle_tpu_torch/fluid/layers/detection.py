"""Detection layers (counterpart of ``paddle_tpu/fluid/layers/detection.py``,
the one the image layers reach: ``sigmoid_focal_loss``); the rest of the
module is ROADMAP queue A item 8's."""
from __future__ import annotations

from ..framework import in_dygraph_mode
from ..layer_helper import LayerHelper


def _det_op(op_type, ins, out_slots, **attrs):
    helper = LayerHelper(op_type)
    outs = {s: [helper.create_variable_for_type_inference()]
            for s in out_slots}
    op = helper.append_op(op_type, inputs=ins, outputs=outs, attrs=attrs)
    got = op if in_dygraph_mode() else outs
    vals = tuple(got[s][0] for s in out_slots)
    return vals if len(vals) > 1 else vals[0]


def sigmoid_focal_loss(x, label, fg_num, gamma=2.0, alpha=0.25):
    return _det_op("sigmoid_focal_loss",
                   {"X": [x], "Label": [label], "FgNum": [fg_num]},
                   ("Out",), gamma=gamma, alpha=alpha)
