"""Linear, Embedding and Dropout with the reference's signatures
(counterpart of paddle_tpu/nn/layer/common.py).

``Linear`` and ``Embedding`` subclass torch's, so code that asks
``isinstance(mod, nn.Linear)`` (``convert``, ``TrainStep``) treats them as
it treats torch's. A Linear stores its weight ``[out, in]`` (torch's
layout; the reference stores ``[in, out]``, and ``convert`` transposes).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.counter_rng import new_key
from .. import functional as PF
from ..initializer import XavierUniform
from .layers import ParamLayer

__all__ = ["Linear", "Embedding", "Dropout", "DropoutKeys"]


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
        out = F.embedding(x, self.weight, sparse=self.sparse)
        if self.padding_idx is not None:
            out = out.masked_fill((x == self.padding_idx).unsqueeze(-1), 0.0)
        return out


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
