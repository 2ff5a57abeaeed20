"""paddle.nn 2.0 namespace (counterpart of ``paddle_tpu/nn``): the layer
classes ported so far, ``functional``, ``initializer``, the gradient
clips under their 2.0 names, and ``utils``.  The classes still to port
are listed, each with its ROADMAP queue A item, in
``tests/test_torch_namespace.py``."""
from ..dygraph.layers import Layer, Sequential, LayerList, ParameterList
from ..dygraph.nn import (Linear, Conv2D, Pool2D, BatchNorm, Embedding,
                          LayerNorm, Dropout, PRelu)
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
                    LSTMCell, GRUCell, Flatten, RowConv, RNNCellBase,
                    Conv1D, Conv3D, Conv1DTranspose, Conv2DTranspose,
                    Conv3DTranspose, MaxPool1D, AvgPool1D, MaxPool3D,
                    AvgPool3D, AdaptiveAvgPool1D, AdaptiveMaxPool1D,
                    AdaptiveMaxPool2D, AdaptiveAvgPool3D, AdaptiveMaxPool3D,
                    BatchNorm1D, BatchNorm3D, GroupNorm, InstanceNorm1D,
                    InstanceNorm2D, InstanceNorm3D, LocalResponseNorm,
                    SpectralNorm, SyncBatchNorm, Pad1D, Pad2D, Pad3D,
                    Upsample, UpsamplingBilinear2D, UpsamplingNearest2D,
                    PixelShuffle, Dropout2D, Dropout3D, AlphaDropout,
                    LogSoftmax, ThresholdedReLU, Maxout, Bilinear,
                    BilinearTensorProduct, BCEWithLogitsLoss,
                    MarginRankingLoss, CosineSimilarity, PairwiseDistance,
                    CTCLoss, HSigmoidLoss)

Conv2d = Conv2D  # historical alias

from . import initializer   # noqa: E402,F401
from . import clip          # noqa: E402,F401
from .clip import (ClipGradByValue, ClipGradByNorm,  # noqa: E402,F401
                   ClipGradByGlobalNorm)
from . import decode        # noqa: E402,F401
from . import utils         # noqa: E402,F401
