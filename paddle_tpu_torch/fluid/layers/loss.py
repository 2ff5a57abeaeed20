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


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper("log_loss", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    op = helper.append_op("log_loss",
                          inputs={"Predicted": [input], "Labels": [label]},
                          outputs={"Loss": [out]},
                          attrs={"epsilon": epsilon})
    return op["Loss"][0] if in_dygraph_mode() else out


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    res = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                    stop_gradient=True)
    op = helper.append_op("huber_loss",
                          inputs={"X": [input], "Y": [label]},
                          outputs={"Out": [out], "Residual": [res]},
                          attrs={"delta": float(delta)})
    return op["Out"][0] if in_dygraph_mode() else out


def kldiv_loss(x, target, reduction="mean", name=None):
    helper = LayerHelper("kldiv_loss", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    op = helper.append_op("kldiv_loss",
                          inputs={"X": [x], "Target": [target]},
                          outputs={"Loss": [out]},
                          attrs={"reduction": reduction})
    return op["Loss"][0] if in_dygraph_mode() else out


def mse_loss(input, label):
    from . import nn
    return nn.reduce_mean(square_error_cost(input, label))


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    """Cross entropy of probabilities (a softmax's output)."""
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    op = helper.append_op("cross_entropy",
                          inputs={"X": [input], "Label": [label]},
                          outputs={"Y": [out]},
                          attrs={"soft_label": soft_label,
                                 "ignore_index": ignore_index})
    return op["Y"][0] if in_dygraph_mode() else out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1_loss")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    diff = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                     stop_gradient=True)
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    op = helper.append_op("smooth_l1_loss", inputs=inputs,
                          outputs={"Out": [out], "Diff": [diff]},
                          attrs={"sigma": sigma or 1.0})
    return op["Out"][0] if in_dygraph_mode() else out
