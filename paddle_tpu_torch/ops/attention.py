"""Attention entry points (counterparts of ``pallas_ops._attention_xla`` and
``nn_ops.scaled_dot_product_attention``).

:func:`attention` is plain masked attention, which the reference runs
outside any Pallas kernel: serving prefill computes it over the paged view,
and every call the flash kernels cannot take falls back to it.
:func:`scaled_dot_product_attention` is what the model's cache-less
forward calls: the flash dispatcher, then dropout on the output. Layout
``[batch, seq, heads, head_dim]`` as in the reference.
"""
from __future__ import annotations

import torch


def attention(q, k, v, mask=None, causal=False, scale=None):
    """``softmax(q k^T * scale [+ mask]) v`` over ``[B, T, N, H]`` inputs.

    Logits and softmax are float32; the probabilities are cast back to the
    input dtype before the PV product, as the reference does. ``mask`` is a
    bool keep-mask or an additive float mask broadcastable to
    ``[B, N, T, S]``."""
    logits = attention_logits(q, k, mask, causal, scale)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bknh->bqnh", probs, v)


def attention_logits(q, k, mask=None, causal=False, scale=None):
    """:func:`attention`'s float32 scores ``[B, N, T, S]``: the product in
    the inputs' dtype, then scaled, masked (-inf) and offset in float32."""
    H = q.shape[-1]
    scale = scale if scale is not None else H ** -0.5
    logits = torch.einsum("bqnh,bknh->bnqk", q, k).float() * scale
    if causal:
        T, S = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(T, S, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, float("-inf"))
        else:
            logits = logits + mask.float()
    return logits


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None, kernel=None):
    """Attention through ``flash_attention.flash_attention`` (``kernel``
    picks its route), then, when training with ``dropout_p > 0``, dropout
    on the attention OUTPUT as in the reference, so the kernels carry no
    dropout. The keep-mask is drawn from ``generator`` (a
    ``torch.Generator`` on the output's device; None draws from torch's
    default generator) and kept values are scaled by ``1 / (1 -
    dropout_p)``."""
    # imported here: flash_attention imports this module's attention()
    from .flash_attention import flash_attention

    out = flash_attention(query, key, value, mask=attn_mask,
                          causal=is_causal, kernel=kernel)
    return output_dropout(out, dropout_p, training, generator)


def output_dropout(out, dropout_p, training, generator=None):
    """Dropout on an attention output, as the reference applies it: when
    training with ``dropout_p > 0``, a keep-mask drawn from ``generator``
    and kept values scaled by ``1 / (1 - dropout_p)``; else ``out``."""
    if dropout_p > 0.0 and training:
        keep = torch.rand(out.shape, generator=generator,
                          device=out.device) >= dropout_p
        out = torch.where(keep, out / (1.0 - dropout_p),
                          torch.zeros((), dtype=out.dtype,
                                      device=out.device))
    return out
