"""paddle.metric (counterpart of ``paddle_tpu/metric``)."""
from .metrics import Metric, Accuracy, Precision, Recall, Auc
from ..fluid.metrics import CompositeMetric
from ..fluid.layers.metric_op import accuracy, auc
