"""paddle.nn 2.0 layers (counterpart of ``paddle_tpu/nn``: the transformer
encoder stack and activations BERT uses, the convolution, pooling,
batch-norm and flatten layers ResNet uses)."""
from ..dygraph.layers import Layer, Sequential, LayerList, ParameterList
from ..dygraph.nn import (Linear, Conv2D, Pool2D, BatchNorm, Embedding,
                          LayerNorm, Dropout)
from .layer import (ReLU, ReLU6, GELU, Tanh, Flatten, MaxPool2D, AvgPool2D,
                    AdaptiveAvgPool2D, BatchNorm2D, MultiHeadAttention,
                    TransformerEncoderLayer, TransformerEncoder,
                    TransformerDecoderLayer, TransformerDecoder, Transformer)

Conv2d = Conv2D  # historical alias
