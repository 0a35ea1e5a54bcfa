"""Layers and helpers of the port (counterpart of paddle_tpu/nn): the
Paddle-signature layers of ``nn/layer/{common,container,conv,pooling,norm,
activation,loss,rnn,transformer}.py``, the initializers and ``ParamAttr``, the
functional ops, gradient clipping, and the Mixture-of-Experts layer in
``nn.moe``."""
from . import functional, initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .initializer import ParamAttr
from .layer import activation as _activation
from .layer import common as _common
from .layer import container as _container
from .layer import conv as _conv
from .layer import loss as _loss
from .layer import norm as _norm
from .layer import pooling as _pooling
from .layer import rnn as _rnn
from .layer.activation import *  # noqa: F401,F403
from .layer.common import *  # noqa: F401,F403
from .layer.container import *  # noqa: F401,F403
from .layer.conv import *  # noqa: F401,F403
from .layer.loss import *  # noqa: F401,F403
from .layer.norm import *  # noqa: F401,F403
from .layer.pooling import *  # noqa: F401,F403
from .layer.rnn import *  # noqa: F401,F403
from .layer.transformer import (MultiHeadAttention, Transformer,
                                TransformerDecoder, TransformerDecoderLayer,
                                TransformerEncoder, TransformerEncoderLayer)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "clip_grad_norm_", "clip_grad_value_", "ParamAttr",
           *_common.__all__, *_container.__all__, *_conv.__all__,
           *_pooling.__all__, *_norm.__all__, *_activation.__all__,
           *_loss.__all__, *_rnn.__all__, "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]
