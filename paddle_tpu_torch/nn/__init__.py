"""paddle.nn 2.0 layers (counterpart of ``paddle_tpu/nn``, the transformer
encoder stack and the activations BERT uses)."""
from ..dygraph.layers import Layer, Sequential, LayerList, ParameterList
from ..dygraph.nn import Linear, Embedding, LayerNorm, Dropout
from .layer import (ReLU, GELU, Tanh, MultiHeadAttention,
                    TransformerEncoderLayer, TransformerEncoder)
