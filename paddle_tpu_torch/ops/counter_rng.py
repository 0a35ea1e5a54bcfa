"""Counter-based random bits in torch integer ops: a value is a hash of its
key and its index, so the same key gives the same bits on any device, in
any order, in a replayed CUDA graph, and in a recomputation, without
reading or advancing a generator's state.

:func:`hashed_dropout` draws a dropout keep-mask this way from a key of
:func:`new_key`; the GPT's training forwards (``models/gpt.py``) and the
Paddle-API ``Dropout`` layers (``nn/layer/common.py``: BERT, ERNIE) use
it, and ``serving/sampling.py`` draws its Gumbel noise from the same
mixer.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def _mul32(a, c):
    """``a * c mod 2**32`` for int64 tensors ``a`` in [0, 2**32) and a
    32-bit constant ``c``, split in 16-bit halves so no product overflows."""
    c_lo, c_hi = c & 0xFFFF, c >> 16
    a_lo, a_hi = a & 0xFFFF, a >> 16
    return (a_lo * c_lo + (((a_hi * c_lo + a_lo * c_hi) & 0xFFFF) << 16)) \
        & MASK32


def mix32(x):
    """A 32-bit avalanche mixer (the murmur3 finalizer) on int64 tensors
    (or Python ints) holding values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def mix_pair(a, b):
    """Hash two 32-bit words into one."""
    return mix32(a ^ mix32((b + 0x9E3779B9) & MASK32))


def new_key(device, generator=None):
    """A dropout key: two 32-bit words as int64 on ``device``, drawn from
    ``generator`` (None: torch's default generator of ``device``)."""
    gdev = generator.device if generator is not None else device
    return torch.randint(0, 1 << 32, (2,), dtype=torch.int64,
                         generator=generator, device=gdev).to(device)


def hashed_dropout(x, p, key, site, row_shard=0, col_shard=(0, 1)):
    """Dropout with rate ``p`` whose keep-mask is a function of ``key`` (an
    int64 tensor of two words, on ``x``'s device), ``site`` (an int naming
    the call site) and each element's index: element ``i`` is kept when 24
    bits of ``hash(key, site, i)``, read as a fraction in [0, 1), are at
    least ``p``; kept values are scaled by ``1 / (1 - p)``.

    ``x`` may be one shard of a larger array, whose mask it then draws: its
    rows (every dimension but the last, flattened) are block ``row_shard``
    of the array's rows, and its last dimension is block ``col_shard[0]``
    of ``col_shard[1]`` equal blocks of the array's. The index hashed is
    the element's flat index in that array (in ``x`` itself by default)."""
    if p <= 0.0:
        return x
    k = key.to(torch.int64) & MASK32
    stream = mix_pair(mix_pair(k[0], k[1]), site & MASK32)
    w = x.shape[-1] if x.dim() else 1
    rows = x.numel() // max(w, 1)
    col, ncol = col_shard
    r = torch.arange(rows, device=x.device, dtype=torch.int64) \
        + row_shard * rows
    c = torch.arange(w, device=x.device, dtype=torch.int64) + col * w
    idx = (r[:, None] * (w * ncol) + c[None, :]).reshape(-1)
    bits = mix_pair(stream ^ 0x27D4EB2F, idx & MASK32)
    bits = mix32(bits ^ (idx >> 32))
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    keep = (u >= p).view(x.shape)
    return torch.where(keep, x / (1.0 - p),
                       torch.zeros((), dtype=x.dtype, device=x.device))
