"""Batched token sampling (counterpart of paddle_tpu/serving/sampling.py).

Greedy / temperature / top-k / top-p over a ``[B, V]`` logits block, with
the per-request knobs as ``[B]`` tensors (``temperature == 0`` -> greedy,
``top_k <= 0`` and ``top_p >= 1`` -> filter off), so one call serves any
mix of requests. Sampling is Gumbel-max: ``argmax(logits + gumbel)``.

Randomness enters only through the request key and the request's own
token index: :func:`gumbel_rows` is counter-based, written in torch integer
ops (``ops/counter_rng.py``), so row b depends on ``(key[b], token_idx[b])`` alone — not on the slot,
the batch, or the device (the integer stream is the same on the CPU and
the GPU, and the float transform runs in float64 before rounding). The
reference draws its noise from JAX's threefry; the two streams differ, so
sampled tokens are compared across frameworks only when both are handed
the same noise.
"""
from __future__ import annotations

import torch

from ..ops.counter_rng import MASK32 as _MASK32
from ..ops.counter_rng import mix32 as _mix32
from ..ops.counter_rng import mix_pair as _mix_pair


def request_key(base_key, seed):
    """Two 32-bit words for one request: the engine's base key (two words)
    folded with the request seed. Host-side, once per admission."""
    base = torch.as_tensor(base_key, dtype=torch.int64) & _MASK32
    s = int(seed)
    s_lo = torch.tensor(s & _MASK32, dtype=torch.int64)
    s_hi = torch.tensor((s >> 32) & _MASK32, dtype=torch.int64)
    k0 = _mix_pair(_mix_pair(base[0], s_lo), s_hi)
    k1 = _mix_pair(_mix_pair(base[1], s_hi ^ 0x5BD1E995), s_lo)
    return torch.stack([k0, k1])


def gumbel_rows(key, token_idx, vocab):
    """``[B, vocab]`` float32 Gumbel noise; row b is a function of
    ``(key[b], token_idx[b])`` only. ``key`` is ``[B, 2]`` integer words in
    [0, 2**32), ``token_idx`` ``[B]``."""
    key = key.to(torch.int64) & _MASK32
    idx = token_idx.to(torch.int64) & _MASK32
    row = _mix_pair(_mix_pair(key[:, 0], idx), key[:, 1])  # [B]
    col = torch.arange(vocab, device=key.device, dtype=torch.int64)
    bits = _mix_pair(row.unsqueeze(1) ^ 0x27D4EB2F, col.unsqueeze(0))
    bits = _mix32(bits ^ key[:, 1:2])
    # 24 high bits -> uniform in (0, 1), exactly representable in float32
    u = ((bits >> 8).to(torch.float64) + 0.5) * (1.0 / (1 << 24))
    return (-torch.log(-torch.log(u))).to(torch.float32)


def filter_top_k(logits, top_k):
    """Keep each row's ``top_k`` highest logits (ties at the threshold all
    survive); ``top_k <= 0`` disables the filter for that row."""
    V = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    kth = sorted_desc.gather(
        -1, (top_k.long() - 1).clamp(0, V - 1).unsqueeze(-1))
    keep = (top_k.unsqueeze(-1) <= 0) | (logits >= kth)
    return logits.masked_fill(~keep, float("-inf"))


def filter_top_p(logits, top_p):
    """Nucleus filter: keep each row's shortest descending prefix whose
    preceding cumulative probability is < top_p (the top token always
    survives); ``top_p >= 1`` disables the filter for that row."""
    p = top_p.clamp(1e-6, 1.0).unsqueeze(-1)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    kept = torch.where(before < p, sorted_desc,
                       torch.full_like(sorted_desc, float("inf")))
    threshold = kept.min(dim=-1, keepdim=True).values
    keep = (top_p.unsqueeze(-1) >= 1.0) | (logits >= threshold)
    return logits.masked_fill(~keep, float("-inf"))


def sample_tokens(logits, temperature, top_k, top_p, gumbel):
    """One int32 token per row: greedy argmax where ``temperature == 0``,
    else Gumbel-max over the temperature-scaled, top-k then top-p filtered
    logits. ``logits`` ``[B, V]``; knobs ``[B]``; ``gumbel`` ``[B, V]``."""
    logits = logits.float()
    greedy = logits.argmax(dim=-1)
    safe_t = torch.where(temperature > 0, temperature,
                         torch.ones_like(temperature))
    scaled = logits / safe_t.unsqueeze(-1)
    filtered = filter_top_p(filter_top_k(scaled, top_k), top_p)
    sampled = (filtered + gumbel).argmax(dim=-1)
    return torch.where(temperature > 0, sampled, greedy).to(torch.int32)
