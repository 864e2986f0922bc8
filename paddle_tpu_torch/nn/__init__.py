"""Layers and functionals of the port.

``Layer`` (``layers.py``) is the reference's base class over
``torch.nn.Module``, with ``Parameter``, ``ParamAttr``, the initializers
(``initializer``) and ``LazyGuard`` (``lazy.py``); ``decode.py`` holds
``BeamSearchDecoder`` and ``dynamic_decode``.  Every port layer with
parameters is built on ``meta`` and materialized on its device (the card
unless ``device="cpu"``; the host under ``LazyGuard``); inside a
parent's ``torch.device("meta")`` scope it stays there for the parent to
materialize (``nn.common.materialize``)."""

from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .lazy import LazyGuard, in_lazy_mode  # noqa: F401
from .layers import Layer, ParamAttr, Parameter  # noqa: F401
from .activation import (CELU, ELU, GELU, GLU, SELU, Hardshrink,  # noqa: F401
                         Hardsigmoid, Hardswish, Hardtanh, LeakyReLU,
                         LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU,
                         ReLU6, RReLU, Sigmoid, Silu, Softmax, Softplus,
                         Softshrink, Softsign, Swish, Tanh, Tanhshrink,
                         ThresholdedReLU)
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_, clip_grad_value_)
from .common import (AlphaDropout, Bilinear, ChannelShuffle,  # noqa: F401
                     CosineSimilarity, Dropout, Dropout2D, Dropout3D,
                     Embedding, Flatten, Fold, Identity, Linear,
                     LinearCompute, Pad1D,
                     Pad2D, Pad3D, PixelShuffle, PixelUnshuffle, Unfold,
                     Upsample, UpsamplingBilinear2D, UpsamplingNearest2D,
                     ZeroPad2D)
from .container import (LayerDict, LayerList, ParameterList,  # noqa: F401
                        Sequential)
from .conv import (Conv1D, Conv1DTranspose, Conv2D,  # noqa: F401
                   Conv2DTranspose, Conv3D, Conv3DTranspose)
from .loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,  # noqa
                   CrossEntropyLoss, CTCLoss, HingeEmbeddingLoss, KLDivLoss,
                   L1Loss, MarginRankingLoss, MSELoss,
                   MultiLabelSoftMarginLoss, NLLLoss, PoissonNLLLoss,
                   RNNTLoss, SigmoidFocalLoss, SmoothL1Loss, SoftMarginLoss,
                   TripletMarginLoss)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                   BatchNorm3D, GroupNorm, InstanceNorm1D, InstanceNorm2D,
                   InstanceNorm3D, LayerNorm, LocalResponseNorm, RMSNorm,
                   SpectralNorm, SyncBatchNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,  # noqa: F401
                      AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                      AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                      AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D)
from .rnn import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell,  # noqa: F401
                  SimpleRNN, SimpleRNNCell)
from .transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
from . import quant  # noqa: F401,E402
from .decode import BeamSearchDecoder, Decoder, dynamic_decode  # noqa: F401,E402
