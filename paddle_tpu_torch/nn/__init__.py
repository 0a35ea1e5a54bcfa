"""Layers and helpers of the port (counterpart of paddle_tpu/nn): the
Paddle-signature layers of the encoder path (``Linear``, ``Embedding``,
``Dropout``, ``LayerNorm``, ``LayerList`` and the transformer layers), the
initializers and ``ParamAttr``, the functional ops they use, gradient
clipping, and the Mixture-of-Experts layer in ``nn.moe``."""
from . import functional, initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .initializer import ParamAttr
from .layer.common import Dropout, Embedding, Linear
from .layer.container import LayerList
from .layer.norm import LayerNorm
from .layer.transformer import (MultiHeadAttention, Transformer,
                                TransformerDecoder, TransformerDecoderLayer,
                                TransformerEncoder, TransformerEncoderLayer)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "clip_grad_norm_", "clip_grad_value_", "ParamAttr", "Linear",
           "Embedding", "Dropout", "LayerNorm", "LayerList",
           "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]
