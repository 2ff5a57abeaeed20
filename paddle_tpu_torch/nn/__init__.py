"""paddle.nn 2.0 layers (counterpart of ``paddle_tpu/nn``: the transformer
stacks and activations BERT and NMT use, the convolution, pooling,
batch-norm and flatten layers of the vision models, the recurrent layers
and cells, and the gradient clips under their 2.0 names)."""
from ..dygraph.layers import Layer, Sequential, LayerList, ParameterList
from ..dygraph.nn import (Linear, Conv2D, Pool2D, BatchNorm, Embedding,
                          LayerNorm, Dropout)
from ..fluid.clip import ClipGradByValue, ClipGradByNorm, ClipGradByGlobalNorm
from .layer import (ReLU, ReLU6, GELU, Tanh, Flatten, MaxPool2D, AvgPool2D,
                    AdaptiveAvgPool2D, BatchNorm2D, MultiHeadAttention,
                    TransformerEncoderLayer, TransformerEncoder,
                    TransformerDecoderLayer, TransformerDecoder, Transformer,
                    LSTM, GRU, SimpleRNN, SimpleRNNCell, LSTMCell, GRUCell,
                    RNN, BiRNN)

Conv2d = Conv2D  # historical alias
