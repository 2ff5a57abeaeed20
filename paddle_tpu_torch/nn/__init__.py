"""paddle.nn 2.0 namespace (counterpart of ``paddle_tpu/nn``): the layer
classes ported so far, ``functional``, ``initializer``, the gradient
clips under their 2.0 names, and ``utils``.  The classes still to port
are listed, each with its ROADMAP queue A item, in
``tests/test_torch_namespace.py``."""
from ..dygraph.layers import Layer, Sequential, LayerList, ParameterList
from ..dygraph.nn import (Linear, Conv2D, Pool2D, BatchNorm, Embedding,
                          LayerNorm, Dropout)
from . import functional
from .layer import (ReLU, GELU, Sigmoid, Tanh, Softmax, LeakyReLU, SiLU,
                    ELU, SELU, Softplus, Softsign, Softshrink, Hardshrink,
                    Tanhshrink, Hardsigmoid, Swish, ReLU6, LogSigmoid,
                    Hardtanh, PReLU, GLU, Mish, Hardswish,
                    MaxPool2D, AvgPool2D, AdaptiveAvgPool2D, BatchNorm2D,
                    CrossEntropyLoss, MSELoss, L1Loss, BCELoss, NLLLoss,
                    KLDivLoss, SmoothL1Loss, MultiHeadAttention,
                    TransformerEncoderLayer, TransformerEncoder,
                    TransformerDecoderLayer, TransformerDecoder, Transformer,
                    LSTM, GRU, SimpleRNN, RNN, BiRNN, SimpleRNNCell,
                    LSTMCell, GRUCell, Flatten, RowConv)

Conv2d = Conv2D  # historical alias

from . import initializer   # noqa: E402,F401
from . import clip          # noqa: E402,F401
from .clip import (ClipGradByValue, ClipGradByNorm,  # noqa: E402,F401
                   ClipGradByGlobalNorm)
from . import decode        # noqa: E402,F401
from . import utils         # noqa: E402,F401
