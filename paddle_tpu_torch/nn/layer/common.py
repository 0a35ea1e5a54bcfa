"""The common layers with the reference's signatures (counterpart of
paddle_tpu/nn/layer/common.py): Linear, Embedding, Bilinear, the dropouts,
Identity, Flatten, the pads, the upsampling layers, the shuffles,
Unfold / Fold and CosineSimilarity.

``Linear`` and ``Embedding`` subclass torch's, so code that asks
``isinstance(mod, nn.Linear)`` (``convert``, ``TrainStep``) treats them as
it treats torch's. A Linear stores its weight ``[out, in]`` (torch's
layout; the reference stores ``[in, out]``, and ``convert`` transposes).
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.counter_rng import new_key
from .. import functional as PF
from ..initializer import XavierUniform
from .layers import ParamLayer

__all__ = ["Identity", "Linear", "Embedding", "Dropout", "Dropout2D",
           "Dropout3D", "AlphaDropout", "DropoutKeys", "Flatten", "Pad1D",
           "Pad2D", "Pad3D", "Upsample", "UpsamplingBilinear2D",
           "UpsamplingNearest2D", "CosineSimilarity", "PixelShuffle",
           "PixelUnshuffle", "ChannelShuffle", "Bilinear", "Unfold", "Fold"]


class Identity(nn.Module):
    """Its input, as it is; takes and ignores any arguments."""

    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Linear(ParamLayer, nn.Linear):
    """``y = x W^T + b``. Default initializers: XavierUniform over the
    reference's ``[in, out]`` fans, zero bias; ``bias_attr=False`` makes
    no bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        nn.Module.__init__(self)
        self.in_features, self.out_features = in_features, out_features
        self.create_parameter("weight", [out_features, in_features],
                              weight_attr,
                              default_initializer=XavierUniform(),
                              transposed=True)
        self.create_parameter("bias", [out_features], bias_attr,
                              is_bias=True)


class Embedding(ParamLayer, nn.Embedding):
    """A lookup table, XavierUniform by default. With ``padding_idx`` the
    row is zeroed at initialisation and, as in the reference, every lookup
    of that id gives zeros (so the row takes no gradient) whatever the row
    holds."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        nn.Module.__init__(self)
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.padding_idx = padding_idx
        self.max_norm, self.norm_type = None, 2.0
        self.scale_grad_by_freq, self.sparse = False, sparse
        self.create_parameter("weight", [num_embeddings, embedding_dim],
                              weight_attr,
                              default_initializer=XavierUniform())
        self._zero_padding_row()

    def _zero_padding_row(self):
        if self.padding_idx is not None and not self.weight.is_meta:
            with torch.no_grad():
                self.weight[self.padding_idx].zero_()

    def reset_parameters(self, generator=None):
        super().reset_parameters(generator)
        self._zero_padding_row()

    def forward(self, x):
        return PF.embedding(x, self.weight, self.padding_idx, self.sparse)


class Dropout(nn.Module):
    """The reference's Dropout (``p``, ``axis``, ``mode``; see
    :func:`~paddle_tpu_torch.nn.functional.dropout`). Its masks are
    counter-based: a layer attached to a model's :class:`DropoutKeys`
    hashes that forward's key with its own ``site``; a layer on its own
    draws a key from torch's default generator at each call."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode
        self.keys, self.site = None, 0

    def forward(self, x):
        key = self.keys.key if self.keys is not None else None
        return PF.dropout(x, self.p, self.axis, self.training, self.mode,
                          key=key, site=self.site)

    def extra_repr(self):
        return f"p={self.p}, axis={self.axis}, mode={self.mode}"


class Dropout2D(Dropout):
    """Drops whole channels (``nn.functional.dropout2d``); its masks are
    counter-based, keyed as :class:`Dropout`'s."""

    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__(p)
        self.data_format = data_format

    def forward(self, x):
        key = self.keys.key if self.keys is not None else None
        return PF.dropout2d(x, self.p, self.training, self.data_format,
                            key=key, site=self.site)

    def extra_repr(self):
        return f"p={self.p}, data_format={self.data_format}"


class Dropout3D(Dropout2D):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__(p, data_format)

    def forward(self, x):
        key = self.keys.key if self.keys is not None else None
        return PF.dropout3d(x, self.p, self.training, self.data_format,
                            key=key, site=self.site)


class AlphaDropout(Dropout):
    """SELU's dropout (``nn.functional.alpha_dropout``)."""

    def __init__(self, p=0.5, name=None):
        super().__init__(p)

    def forward(self, x):
        key = self.keys.key if self.keys is not None else None
        return PF.alpha_dropout(x, self.p, self.training, key=key,
                                site=self.site)

    def extra_repr(self):
        return f"p={self.p}"


class DropoutKeys:
    """A model's dropout stream: one key per training forward, drawn from
    ``generator`` (None: torch's default generator of the model's device),
    which every attached :class:`Dropout` hashes with its own site. The
    masks are then a function of the key alone: the same eagerly and
    under ``TrainStep``'s CUDA graph (which registers the model's
    ``generator`` so each replay draws a new key), and made again by a
    recomputation, as the GPT's are (``models/gpt.py``)."""

    def __init__(self, generator=None):
        self.generator = generator
        self.key = None
        self.layers = []

    def attach(self, module):
        """Give every Dropout of ``module`` not yet attached the next site."""
        for mod in module.modules():
            if isinstance(mod, Dropout) and mod.keys is None:
                mod.keys, mod.site = self, len(self.layers)
                self.layers.append(mod)

    def draw(self, device):
        """This forward's key; None when no attached layer drops
        anything, so a model without dropout leaves the generator
        alone."""
        self.key = (new_key(device, self.generator)
                    if any(m.p > 0 for m in self.layers) else None)
        return self.key


class Flatten(nn.Module):
    """Dimensions ``start_axis`` to ``stop_axis`` merged into one."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class _PadNd(nn.Module):
    """``nn.functional.pad`` of the spatial dimensions; an int pads every
    side of each by that much."""
    _n = 2

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__()
        if isinstance(padding, int):
            padding = [padding] * (2 * self._n)
        self.padding, self.mode, self.value = list(padding), mode, value
        self.data_format = data_format

    def forward(self, x):
        return PF.pad(x, self.padding, self.mode, self.value,
                      self.data_format)


class Pad1D(_PadNd):
    _n = 1

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadNd):
    _n = 2


class Pad3D(_PadNd):
    _n = 3

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Upsample(nn.Module):
    """``nn.functional.interpolate`` with the arguments it was built with."""

    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor, self.mode = size, scale_factor, mode
        self.align_corners, self.align_mode = align_corners, align_mode
        self.data_format = data_format

    def forward(self, x):
        return PF.interpolate(x, self.size, self.scale_factor, self.mode,
                              self.align_corners, self.align_mode,
                              self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class UpsamplingBilinear2D(Upsample):
    """Bilinear, corner to corner (``align_corners=True``)."""

    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format)


class CosineSimilarity(nn.Module):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return PF.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class PixelShuffle(nn.Module):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return PF.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(nn.Module):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor, self.data_format = (downscale_factor,
                                                   data_format)

    def forward(self, x):
        return PF.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(nn.Module):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return PF.channel_shuffle(x, self.groups, self.data_format)


class Bilinear(ParamLayer, nn.Module):
    """``out[b, o] = x1[b] . weight[o] . x2[b] + bias[o]``; ``weight``
    ``[out, in1, in2]`` (XavierUniform over the reference's fans),
    ``bias`` ``[1, out]``."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        nn.Module.__init__(self)
        self.create_parameter("weight",
                              [out_features, in1_features, in2_features],
                              weight_attr)
        self.create_parameter("bias", [1, out_features], bias_attr,
                              is_bias=True)

    def forward(self, x1, x2):
        out = torch.einsum("bi,oij,bj->bo", x1, self.weight, x2)
        return out + self.bias if self.bias is not None else out


class Unfold(nn.Module):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return PF.unfold(x, *self.args)


class Fold(nn.Module):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.args = (output_sizes, kernel_sizes, strides, paddings,
                     dilations)

    def forward(self, x):
        return PF.fold(x, *self.args)
