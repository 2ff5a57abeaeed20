"""Loss layers (counterpart of ``paddle_tpu/fluid/layers/loss.py``, the
subset the ported slices build)."""
from __future__ import annotations

from ..framework import in_dygraph_mode
from ..layer_helper import LayerHelper


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax = helper.create_variable_for_type_inference(dtype=logits.dtype,
                                                        stop_gradient=True)
    loss = helper.create_variable_for_type_inference(dtype=logits.dtype)
    op = helper.append_op("softmax_with_cross_entropy",
                          inputs={"Logits": [logits], "Label": [label]},
                          outputs={"Softmax": [softmax], "Loss": [loss]},
                          attrs={"soft_label": soft_label,
                                 "ignore_index": ignore_index, "axis": axis})
    if in_dygraph_mode():
        softmax, loss = op["Softmax"][0], op["Loss"][0]
    if return_softmax:
        return loss, softmax
    return loss


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      name=None, normalize=False):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    op = helper.append_op("sigmoid_cross_entropy_with_logits",
                          inputs={"X": [x], "Label": [label]},
                          outputs={"Out": [out]},
                          attrs={"ignore_index": ignore_index,
                                 "normalize": normalize})
    return op["Out"][0] if in_dygraph_mode() else out


def square_error_cost(input, label):
    """(input - label)² elementwise, as one ``mse_loss`` op."""
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    op = helper.append_op("mse_loss",
                          inputs={"Input": [input], "Label": [label]},
                          outputs={"Out": [out]})
    return op["Out"][0] if in_dygraph_mode() else out
