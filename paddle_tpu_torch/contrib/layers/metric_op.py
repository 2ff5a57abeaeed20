"""fluid.contrib.layers.metric_op (counterpart of
``paddle_tpu/contrib/layers/metric_op.py``, ``ctr_metric_bundle``): the
local CTR metric sums, squared error, absolute error, predicted CTR and
the q value, which the caller normalises by the instance count."""
from __future__ import annotations

from ...fluid import layers as L

__all__ = ["ctr_metric_bundle"]


def ctr_metric_bundle(input, label):
    lab = L.cast(label, "float32")
    err = input - lab
    local_sqrerr = L.reduce_sum(L.square(err))
    local_abserr = L.reduce_sum(L.abs(err))
    local_prob = L.reduce_sum(input)
    local_q = L.reduce_sum(input * lab)     # the predictions on positives
    return local_sqrerr, local_abserr, local_prob, local_q
