"""GPT model family (counterpart of paddle_tpu/models/gpt.py): the dense
trunk, its cache-less causal forward (the pretraining path, through the
flash-attention kernels), its paged-KV-cache forward, and the pretraining
criterion.

Submodule names match the reference one to one (``embeddings.
word_embeddings``, ``blocks.<i>.attn.qkv_proj``, ``blocks.<i>.mlp.fc1``,
``ln_f``, ...), so ``paddle_tpu_torch.convert`` maps its weights by name;
only Linear weights differ in layout (``[out, in]`` here, ``[in, out]``
there).

The paged forward follows the reference's paged branch: the span's new K/V
rows are written into the per-layer block pools at rows derived from the
block table, rows outside ``[0, seq_len)`` (bucket padding, inactive decode
lanes) go to the reserved garbage block 0, and attention reads each slot's
logical view. Unlike the reference, which returns new pools, the pools are
updated in place (``index_copy_``): on a GPU a copy of every pool per step
would cost more than the step.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.attention import attention, scaled_dot_product_attention
from ..ops.flash_attention import select_flash_kernel
from ..ops.paged_attention import (paged_attention_route, paged_view,
                                   position_mask)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class GPTConfig:
    PRESETS = {
        "gpt2-tiny": dict(n_layer=2, n_head=4, d_model=128, seq_len=128),
        "gpt2-tiny-moe": dict(n_layer=2, n_head=4, d_model=128,
                              seq_len=128, moe_num_experts=4),
        "gpt2-small": dict(n_layer=12, n_head=12, d_model=768, seq_len=1024),
        "gpt2-medium": dict(n_layer=24, n_head=16, d_model=1024, seq_len=1024),
        "gpt2-large": dict(n_layer=36, n_head=20, d_model=1280, seq_len=1024),
        "gpt3-1.3B": dict(n_layer=24, n_head=32, d_model=2048, seq_len=2048),
        "gpt3-2.7B": dict(n_layer=32, n_head=32, d_model=2560, seq_len=2048),
        "gpt3-6.7B": dict(n_layer=32, n_head=32, d_model=4096, seq_len=2048),
    }

    def __init__(self, vocab_size=50304, n_layer=12, n_head=12, d_model=768,
                 seq_len=1024, d_ff=None, dropout=0.0, attn_dropout=0.0,
                 dtype="float32", use_recompute=False, recompute_policy=None,
                 initializer_range=0.02, moe_num_experts=0):
        self.vocab_size = vocab_size
        self.n_layer = n_layer
        self.n_head = n_head
        self.d_model = d_model
        self.seq_len = seq_len
        self.d_ff = d_ff or 4 * d_model
        self.dropout = dropout
        self.attn_dropout = attn_dropout
        self.dtype = dtype
        # use_recompute recomputes each block's forward in the backward
        # when training; only recompute_policy=None (save nothing, the
        # reference's full remat) is ported, a named policy is refused
        # when a model is built from this config
        self.use_recompute = use_recompute
        self.recompute_policy = recompute_policy
        self.initializer_range = initializer_range
        # the port has the dense trunk only so far; an MoE preset is
        # refused when a model is built from it
        self.moe_num_experts = int(moe_num_experts)

    @classmethod
    def preset(cls, name, **overrides):
        cfg = dict(cls.PRESETS[name])
        cfg.update(overrides)
        return cls(**cfg)

    @property
    def torch_dtype(self):
        return _DTYPES[self.dtype]

    def num_params(self):
        d, L, V = self.d_model, self.n_layer, self.vocab_size
        return V * d + self.seq_len * d + L * (12 * d * d + 13 * d) + 2 * d

    def flops_per_token(self):
        """Training (fwd+bwd) model FLOPs per token: 6 per parameter in the
        blocks and final LN, 6*V*d for the tied LM head, 12*L*d*T for
        attention scores and values (the reference's accounting)."""
        d, L, V = self.d_model, self.n_layer, self.vocab_size
        block_params = L * (12 * d * d + 13 * d) + 2 * d
        return 6 * (block_params + V * d) + 12 * L * d * self.seq_len


def paged_write_rows(cache_offsets, seq_lens, block_tables, block_size, T):
    """Flat pool rows ``[B * T]`` the span's K/V land in: row ``t`` of slot
    ``b`` sits at logical position ``cache_offsets[b] + t``; positions at or
    past ``seq_lens[b]``, or past the table's ``M * block_size`` rows, are
    redirected to the garbage block 0.

    The second bound is the port's: the reference clamps the logical block
    to ``M - 1`` alone (``paddle_tpu/models/gpt.py:175-181``), so a
    speculative verify span of a slot within ``K`` rows of the ceiling
    writes its rows past ``M * block_size`` over live rows of the slot's
    own last block, before the same layer's attention reads them."""
    M = block_tables.shape[1]
    rows = cache_offsets.long().unsqueeze(1) + torch.arange(
        T, device=cache_offsets.device)
    blk = (rows // block_size).clamp(max=M - 1)
    phys = block_tables.long().gather(1, blk)
    writable = ((rows < seq_lens.long().unsqueeze(-1))
                & (rows < M * block_size))
    flat = torch.where(writable, phys * block_size + rows % block_size,
                       torch.zeros_like(rows))
    return flat.reshape(-1)


class GPTAttention(nn.Module):
    """Causal self-attention with a fused QKV projection. ``kernel`` is the
    cache-less forward's attention route ("cuda" | "torch") and
    ``generator`` the source of its dropout masks; :class:`GPTModel` sets
    both."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        d, h = cfg.d_model, cfg.n_head
        self.n_head = h
        self.head_dim = d // h
        self.qkv_proj = nn.Linear(d, 3 * d)
        self.out_proj = nn.Linear(d, d)
        self.dropout_p = cfg.attn_dropout
        self.kernel = "torch"
        self.generator = None

    def forward(self, x, cache=None, paged=None):
        """Cache-less causal attention, or (with ``cache=(k_pool, v_pool)``
        and ``paged`` from :meth:`GPTModel.forward`) the paged branch."""
        B, T, D = x.shape
        qkv = self.qkv_proj(x).view(B, T, 3, self.n_head, self.head_dim)
        q, k, v = qkv.unbind(2)
        if cache is None:
            out = scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=self.dropout_p,
                training=self.training, generator=self.generator,
                kernel=self.kernel)
            return self.out_proj(out.reshape(B, T, D))
        block_tables, seq_lens, offsets, write_rows, kernel = paged
        k_pool, v_pool = cache
        Nb, bs = k_pool.shape[0], k_pool.shape[1]
        shape = (Nb * bs, self.n_head, self.head_dim)
        k_pool.view(shape).index_copy_(
            0, write_rows, k.reshape(B * T, self.n_head, self.head_dim))
        v_pool.view(shape).index_copy_(
            0, write_rows, v.reshape(B * T, self.n_head, self.head_dim))
        if kernel is not None:
            out = paged_attention_route(kernel, q, k_pool, v_pool,
                                        block_tables, seq_lens, offsets)
        else:
            # prefill: the gather path with an explicit mask, as in the
            # reference (its prefill never reaches the paged kernel)
            k_view = paged_view(k_pool, block_tables)
            v_view = paged_view(v_pool, block_tables)
            out = attention(q, k_view, v_view,
                            mask=position_mask(offsets, seq_lens, T,
                                               k_view.shape[1]))
        return self.out_proj(out.reshape(B, T, D))


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.d_model, cfg.d_ff)
        self.fc2 = nn.Linear(cfg.d_ff, cfg.d_model)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, x):
        return self.dropout(self.fc2(F.gelu(self.fc1(x), approximate="tanh")))


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.ln1 = nn.LayerNorm(cfg.d_model, eps=1e-5)
        self.attn = GPTAttention(cfg)
        self.ln2 = nn.LayerNorm(cfg.d_model, eps=1e-5)
        self.mlp = GPTMLP(cfg)
        self.dropout = nn.Dropout(cfg.dropout)
        self.recompute = cfg.use_recompute

    def _forward(self, x, cache=None, paged=None):
        x = x + self.dropout(self.attn(self.ln1(x), cache=cache, paged=paged))
        return x + self.mlp(self.ln2(x))

    def forward(self, x, cache=None, paged=None):
        if cache is None and self.recompute and self.training:
            return self._recomputed(x)
        return self._forward(x, cache=cache, paged=paged)

    def _recomputed(self, x):
        """The block under ``torch.utils.checkpoint``: its activations are
        dropped after the forward and recomputed in the backward. The
        checkpoint replays torch's default generators itself; the
        attention's own generator is rewound here, so the recomputation
        draws the same dropout masks, and then put back where the forward
        left it."""
        gen = self.attn.generator
        if gen is None or self.attn.dropout_p == 0.0:
            return checkpoint(self._forward, x, use_reentrant=False)
        start = gen.get_state()
        ran = []

        def run(h):
            if not ran:
                ran.append(True)
                return self._forward(h)
            resume = gen.get_state()
            gen.set_state(start)
            try:
                return self._forward(h)
            finally:
                gen.set_state(resume)

        return checkpoint(run, x, use_reentrant=False)


class GPTEmbeddings(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.position_embeddings = nn.Embedding(cfg.seq_len, cfg.d_model)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(
                input_ids.shape[1], device=input_ids.device).unsqueeze(0)
        return self.dropout(self.word_embeddings(input_ids)
                            + self.position_embeddings(position_ids))


class GPTModel(nn.Module):
    """The decoder trunk. ``device=None`` builds on the current CUDA device
    and raises without one; pass ``device="cpu"`` to build on the CPU.
    Weights are drawn from ``generator`` (a ``torch.Generator`` on the
    model's device) or, when it is None, from torch's default generator:
    Normal(0, initializer_range) for embeddings and Linear weights, scaled
    by 1/sqrt(2*n_layer) for the two residual-output projections, zero
    biases, unit LayerNorm scales — the reference's initializers. The
    attention dropout draws from the same generator.

    ``attn_kernel`` picks the cache-less forward's attention route once
    (:func:`~paddle_tpu_torch.ops.flash_attention.select_flash_kernel`):
    None resolves to "cuda" (the flash kernels) on a CUDA device and
    "torch" (plain attention) on the CPU; the choice is ``self.attn_kernel``.
    """

    def __init__(self, cfg: GPTConfig, device=None, generator=None,
                 attn_kernel=None):
        super().__init__()
        if cfg.moe_num_experts:
            raise NotImplementedError(
                "paddle_tpu_torch has the dense GPT trunk only; MoE blocks "
                f"(moe_num_experts={cfg.moe_num_experts}) are not ported yet")
        if cfg.recompute_policy is not None:
            raise NotImplementedError(
                f"recompute_policy={cfg.recompute_policy!r}: only full "
                "recompute (recompute_policy=None) is ported; the named "
                "policies are not ported yet")
        dev = resolve_device(device)
        self.cfg = cfg
        self.attn_kernel = select_flash_kernel(
            attn_kernel, device=dev, head_dim=cfg.d_model // cfg.n_head,
            dtype=cfg.torch_dtype)
        with torch.device("meta"):
            self.embeddings = GPTEmbeddings(cfg)
            self.blocks = nn.ModuleList([GPTBlock(cfg)
                                         for _ in range(cfg.n_layer)])
            self.ln_f = nn.LayerNorm(cfg.d_model, eps=1e-5)
        self.to_empty(device=dev)
        self._init_weights(generator)
        self.to(cfg.torch_dtype)
        for blk in self.blocks:
            blk.attn.kernel = self.attn_kernel
            blk.attn.generator = generator

    @torch.no_grad()
    def _init_weights(self, generator):
        std = self.cfg.initializer_range
        out_std = std / math.sqrt(2 * self.cfg.n_layer)
        residual_out = set()
        for blk in self.blocks:
            residual_out.update((blk.attn.out_proj, blk.mlp.fc2))
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, out_std if mod in residual_out
                                   else std, generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, std, generator=generator)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    @property
    def device(self):
        return self.ln_f.weight.device

    def forward(self, input_ids, position_ids=None, caches=None,
                cache_offsets=None, seq_lens=None, block_tables=None,
                paged_kernel=None):
        """Cache-less: returns the final hidden states ``[B, T, D]``.

        Paged (``caches`` = per-layer ``(k_pool, v_pool)``, with
        ``cache_offsets`` / ``seq_lens`` ``[B]`` and ``block_tables``
        ``[B, M]``, all int32): writes the span's K/V into the pools in
        place and returns ``(hidden, caches)``. ``paged_kernel`` picks the
        attention read: "cuda" (the kernel), "torch" (its plain version) or
        None (the masked gather path prefill uses)."""
        x = self.embeddings(input_ids, position_ids)
        if caches is None:
            for blk in self.blocks:
                x = blk(x)
            return self.ln_f(x)
        if block_tables is None or cache_offsets is None or seq_lens is None:
            raise NotImplementedError(
                "only the paged KV cache is ported: pass cache_offsets, "
                "seq_lens and block_tables with caches")
        rows = paged_write_rows(cache_offsets, seq_lens, block_tables,
                                caches[0][0].shape[1], input_ids.shape[1])
        paged = (block_tables, seq_lens, cache_offsets, rows, paged_kernel)
        for blk, c in zip(self.blocks, caches):
            x = blk(x, cache=c, paged=paged)
        return self.ln_f(x), caches


class GPTForPretraining(nn.Module):
    """LM head tied to the word embeddings."""

    def __init__(self, model: GPTModel):
        super().__init__()
        self.gpt = model

    def lm_logits(self, hidden):
        return hidden @ self.gpt.embeddings.word_embeddings.weight.t()

    def forward(self, input_ids, position_ids=None):
        return self.lm_logits(self.gpt(input_ids, position_ids))


class GPTPretrainingCriterion(nn.Module):
    """Mean next-token cross-entropy: ``-log_softmax(logits)[label]`` in the
    logits' dtype, averaged over every position, or over the positions
    ``loss_mask`` keeps (its sum clipped at 1), as in the reference."""

    def forward(self, logits, labels, loss_mask=None):
        logp = torch.log_softmax(logits.reshape(-1, logits.shape[-1]), dim=-1)
        loss = -logp.gather(1, labels.reshape(-1, 1).long()).squeeze(1)
        if loss_mask is not None:
            m = loss_mask.reshape(-1).to(loss.dtype)
            return (loss * m).sum() / m.sum().clamp(min=1.0)
        return loss.mean()
