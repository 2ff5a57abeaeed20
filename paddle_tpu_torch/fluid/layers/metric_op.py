"""Metric layers (counterpart of ``paddle_tpu/fluid/layers/metric_op.py``,
``accuracy``)."""
from __future__ import annotations

from ..framework import in_dygraph_mode
from ..layer_helper import LayerHelper
from . import nn


def accuracy(input, label, k=1, correct=None, total=None):
    """The share of rows whose label is among the ``k`` largest of
    ``input``, through a ``top_k`` op and an ``accuracy`` op."""
    helper = LayerHelper("accuracy")
    topk_out, topk_ids = nn.topk(input, k=k)
    acc = helper.create_variable_for_type_inference(dtype="float32",
                                                    stop_gradient=True)
    correct = correct or helper.create_variable_for_type_inference(
        dtype="int32", stop_gradient=True)
    total = total or helper.create_variable_for_type_inference(
        dtype="int32", stop_gradient=True)
    op = helper.append_op("accuracy",
                          inputs={"Out": [topk_out], "Indices": [topk_ids],
                                  "Label": [label]},
                          outputs={"Accuracy": [acc], "Correct": [correct],
                                   "Total": [total]})
    return op["Accuracy"][0] if in_dygraph_mode() else acc
