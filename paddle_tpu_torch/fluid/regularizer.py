"""Weight-decay regularizers (counterpart of
``paddle_tpu/fluid/regularizer.py``): each appends its decay term to a
gradient as ops of the program, after the gradient clip, as the
reference's ``append_regularization_ops`` does."""
from __future__ import annotations

from . import layers


class WeightDecayRegularizer:
    def _append(self, param, grad):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    """grad + coeff · param."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def _append(self, param, grad):
        return layers.elementwise_add(
            grad, layers.scale(param, scale=self._coeff))


class L1DecayRegularizer(WeightDecayRegularizer):
    """grad + coeff · sign(param)."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def _append(self, param, grad):
        return layers.elementwise_add(
            grad, layers.scale(layers.nn.sign(param), scale=self._coeff))


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
