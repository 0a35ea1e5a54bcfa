"""Functional ops of the port (counterpart of paddle_tpu/nn/functional,
which re-exports ``ops/activation.py`` and ``ops/nn_ops.py``): activations,
``linear`` and ``embedding``, convolutions, pools (with indices) and
unpools, normalisations, dropouts, resizing, sampling grids, shuffles,
patches, padding, losses (RNN-T, margin and hierarchical softmax
included) and the functional routes to the attention kernels, with the
reference's signatures and defaults, as functions on torch tensors."""
from .activation import *  # noqa: F401,F403
from .activation import __all__ as _act
from .attention import *  # noqa: F401,F403
from .attention import __all__ as _attn
from .common import *  # noqa: F401,F403
from .common import __all__ as _common
from .conv import (conv1d, conv1d_transpose, conv2d,  # noqa: F401
                   conv2d_transpose, conv3d, conv3d_transpose)
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss
from .norm import *  # noqa: F401,F403
from .norm import __all__ as _norm
from .pooling import *  # noqa: F401,F403
from .pooling import __all__ as _pool
from .vision import *  # noqa: F401,F403
from .vision import __all__ as _vision

__all__ = [*_act, *_attn, *_common, "conv1d", "conv2d", "conv3d",
           "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
           *_loss, *_norm, *_pool, *_vision]
