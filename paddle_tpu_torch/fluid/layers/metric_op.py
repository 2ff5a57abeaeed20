"""Metric layers (counterpart of ``paddle_tpu/fluid/layers/metric_op.py``,
``accuracy`` and ``auc``)."""
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


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """Streaming AUC over persistable bucket histograms
    (metrics/auc_op.cc); ``curve`` and ``slide_steps`` are not read."""
    from .tensor import create_global_var
    helper = LayerHelper("auc")
    stat_pos = create_global_var([1, num_thresholds + 1], 0.0, "float32",
                                 persistable=True)
    stat_neg = create_global_var([1, num_thresholds + 1], 0.0, "float32",
                                 persistable=True)
    auc_out = helper.create_variable_for_type_inference(dtype="float32",
                                                        stop_gradient=True)
    op = helper.append_op(
        "auc",
        inputs={"Predict": [input], "Label": [label],
                "StatPos": [stat_pos], "StatNeg": [stat_neg]},
        outputs={"AUC": [auc_out], "StatPosOut": [stat_pos],
                 "StatNegOut": [stat_neg]},
        attrs={"num_thresholds": num_thresholds, "curve": curve})
    if in_dygraph_mode():
        return op["AUC"][0], None, [stat_pos, stat_neg]
    return auc_out, None, [stat_pos, stat_neg]
