"""Fused transformer layers and ``memory_efficient_attention`` (counterpart
of paddle_tpu/incubate/nn).

The reference keeps Paddle's fused-layer API (pre/post LayerNorm, the
packed QKV projection, the residual adds) over its flash-attention core,
and leaves the epilogues to the compiler. The port does the same over
``ops.flash_attention.flash_attention``: a mask-free self-attention the
kernels take runs K1 forward and K2 + K3 backward, anything else the plain
route. ``FusedMultiHeadAttention``'s packed ``qkv_proj`` output is read as
``[B, T, 3, heads, head_dim]``, the reference's column order, so its
weight carries across with the one transpose of every Linear.
"""
from __future__ import annotations

import torch
from torch import nn

from ...nn import functional as F
from ...nn.layer.common import Dropout, Linear
from ...nn.layer.container import LayerList
from ...nn.layer.norm import LayerNorm
from ...ops.flash_attention import flash_attention

__all__ = ["memory_efficient_attention", "identity_loss",
           "AttentionBias", "LowerTriangularMask",
           "LowerTriangularMaskWithTensorBias",
           "FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedMultiTransformer",
           "FusedLinear"]


class FusedLinear(Linear):
    """The reference's FusedLinear: a Linear (matmul and bias in one
    call)."""


class FusedMultiHeadAttention(nn.Module):
    """Self-attention with a packed ``qkv_proj`` (``embed_dim`` -> 3 x
    ``embed_dim``), ``pre_ln`` before it when ``normalize_before``, ``ln``
    after the residual add otherwise (both always present, as in the
    reference's state). ``attn_mask`` goes to the attention as it is (bool
    keeps, float adds). ``kdim``, ``vdim``, ``need_weights``, ``nranks``
    and ``ring_id`` are accepted and unused, as in the reference."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.qkv_proj = Linear(embed_dim, 3 * embed_dim,
                               weight_attr=qkv_weight_attr,
                               bias_attr=qkv_bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim,
                               weight_attr=linear_weight_attr,
                               bias_attr=linear_bias_attr)
        self.pre_ln = LayerNorm(embed_dim, epsilon=epsilon,
                                weight_attr=pre_ln_scale_attr,
                                bias_attr=pre_ln_bias_attr)
        self.ln = LayerNorm(embed_dim, epsilon=epsilon,
                            weight_attr=ln_scale_attr, bias_attr=ln_bias_attr)
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.attn_dropout = Dropout(attn_dropout_rate)
        self.dropout = Dropout(dropout_rate)
        self.kernel = None

    def forward(self, x, attn_mask=None, cache=None):
        residual = x
        if self.normalize_before:
            x = self.pre_ln(x)
        B, T = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).reshape(B, T, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv.unbind(2)
        out = self.attn_dropout(flash_attention(q, k, v, mask=attn_mask,
                                                kernel=self.kernel))
        out = self.dropout(self.out_proj(out.reshape(B, T, self.embed_dim)))
        out = residual + out
        if not self.normalize_before:
            out = self.ln(out)
        return out


class FusedFeedForward(nn.Module):
    """``linear2(act(linear1(x)))`` with dropout after each, the residual
    add, and ``ln1`` before (``normalize_before``) or ``ln2`` after."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        self.linear1 = Linear(d_model, dim_feedforward,
                              weight_attr=linear1_weight_attr,
                              bias_attr=linear1_bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model,
                              weight_attr=linear2_weight_attr,
                              bias_attr=linear2_bias_attr)
        self.ln1 = LayerNorm(d_model, epsilon=epsilon,
                             weight_attr=ln1_scale_attr,
                             bias_attr=ln1_bias_attr)
        self.ln2 = LayerNorm(d_model, epsilon=epsilon,
                             weight_attr=ln2_scale_attr,
                             bias_attr=ln2_bias_attr)
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = (act_dropout_rate if act_dropout_rate
                                 is not None else dropout_rate)
        self.act_dropout = Dropout(self.act_dropout_rate)
        self.dropout = Dropout(dropout_rate)
        self.activation = activation
        self.normalize_before = normalize_before

    def forward(self, src, cache=None):
        residual = src
        if self.normalize_before:
            src = self.ln1(src)
        act = getattr(F, self.activation)
        src = self.act_dropout(act(self.linear1(src)))
        src = residual + self.dropout(self.linear2(src))
        if not self.normalize_before:
            src = self.ln2(src)
        return src


class FusedTransformerEncoderLayer(nn.Module):
    """``FusedFeedForward(FusedMultiHeadAttention(src))``. ``weight_attr``
    and ``bias_attr`` are accepted and unused, as in the reference."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout_rate = (dropout_rate if attn_dropout_rate is None
                             else attn_dropout_rate)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate,
            normalize_before=normalize_before)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, src_mask))


class FusedMultiTransformer(nn.Module):
    """A stack of ``num_layers`` FusedTransformerEncoderLayers (pre-norm
    and GELU by default). ``caches`` is accepted and ignored, as the
    reference ignores it."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 num_layers=-1, nranks=1, ring_id=-1, **kw):
        super().__init__()
        if num_layers <= 0:
            raise ValueError(f"num_layers must be positive, got "
                             f"{num_layers}")
        self.layers = LayerList([
            FusedTransformerEncoderLayer(
                embed_dim, num_heads, dim_feedforward, dropout_rate,
                activation, normalize_before=normalize_before)
            for _ in range(num_layers)])

    def forward(self, src, attn_mask=None, caches=None):
        out = src
        for layer in self.layers:
            out = layer(out, attn_mask)
        return out


class AttentionBias:
    """Base marker of ``memory_efficient_attention``'s biases."""


class LowerTriangularMask(AttentionBias):
    """Causal: the kernels' own causal flag, no ``[T, S]`` mask made."""


class LowerTriangularMaskWithTensorBias(LowerTriangularMask):
    """Causal plus an additive tensor bias."""

    def __init__(self, bias):
        self._bias = bias


def memory_efficient_attention(query, key, value, attn_bias=None, p=0.0,
                               scale=None, training=True):
    """``[B, T, heads, head_dim]`` attention, the reference's dispatcher:
    no bias or a ``LowerTriangularMask`` takes the kernels (their causal
    flag for the marker) when they take the shapes; a tensor bias is added
    to the scores on the plain route, and with the causal marker the
    triangle is folded into it as -inf. Dropout with rate ``p`` on the
    output when ``training``."""
    causal = isinstance(attn_bias, LowerTriangularMask)
    bias = None
    if isinstance(attn_bias, LowerTriangularMaskWithTensorBias):
        bias = attn_bias._bias
    elif attn_bias is not None and not isinstance(attn_bias, AttentionBias):
        bias = attn_bias
    if causal and bias is not None:
        keep = torch.ones(query.shape[1], key.shape[1], dtype=torch.bool,
                          device=query.device).tril()
        bias = torch.where(keep, bias, torch.full_like(bias, float("-inf")))
        causal = False
    out = flash_attention(query, key, value, mask=bias, causal=causal,
                          scale=scale)
    if p > 0.0 and training:
        out = F.dropout(out, p=p, training=True)
    return out


def identity_loss(x, reduction="none"):
    """The reference's IPU loss marker: ``x`` reduced by ``reduction``
    (``"sum"``/0, ``"mean"``/1, ``"none"``/2)."""
    if reduction in (0, "sum"):
        return x.sum()
    if reduction in (1, "mean"):
        return x.mean()
    if reduction in (2, "none"):
        return x
    raise ValueError(f"reduction must be sum/mean/none, got {reduction!r}")
