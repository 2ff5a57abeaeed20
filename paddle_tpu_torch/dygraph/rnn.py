"""The 1.x dygraph cells (counterpart of ``paddle_tpu/dygraph/rnn.py``;
reference python/paddle/fluid/dygraph/rnn.py): ``LSTMCell`` and
``GRUCell`` with the fluid-era ``(hidden_size, input_size)`` argument
order and step signatures, over the 2.0 cells of ``nn/layer.py``."""
from __future__ import annotations

from ..nn.layer import LSTMCell as _LSTM20, GRUCell as _GRU20

__all__ = ["LSTMCell", "GRUCell"]


class LSTMCell(_LSTM20):
    def __init__(self, hidden_size, input_size, param_attr=None,
                 bias_attr=None, gate_activation=None, activation=None,
                 forget_bias=1.0, use_cudnn_impl=True, dtype="float32"):
        super().__init__(input_size, hidden_size,
                         weight_ih_attr=param_attr,
                         weight_hh_attr=param_attr,
                         bias_ih_attr=bias_attr, bias_hh_attr=bias_attr)

    def forward(self, input, pre_hidden, pre_cell):
        _, (h, c) = super().forward(input, (pre_hidden, pre_cell))
        return h, c


class GRUCell(_GRU20):
    def __init__(self, hidden_size, input_size, param_attr=None,
                 bias_attr=None, gate_activation=None, activation=None,
                 use_cudnn_impl=True, dtype="float32"):
        super().__init__(input_size, hidden_size,
                         weight_ih_attr=param_attr,
                         weight_hh_attr=param_attr,
                         bias_ih_attr=bias_attr, bias_hh_attr=bias_attr)

    def forward(self, input, pre_hidden):
        h, _ = super().forward(input, pre_hidden)
        return h
