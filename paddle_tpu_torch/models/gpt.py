"""GPT model family (counterpart of paddle_tpu/models/gpt.py): the trunk,
dense or with Mixture-of-Experts blocks (``moe_num_experts > 0``: every
``moe_every``-th block's MLP is an ``nn.moe.MoEMLP``), its cache-less
causal forward (the pretraining path, through the flash-attention
kernels), its paged-KV-cache forward, the reference's two older cache
forms (a per-slot cache buffer, a growing concatenated cache), and the
pretraining criterion.

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

Tensor parallelism: ``fleet.distributed_model`` (``distributed.spmd.
shard_model``) slices the parameters the model annotates with a
``sharding_spec`` (``qkv_proj`` and ``fc1`` by output features, the q, k
and v blocks of ``qkv_proj`` each by whole heads; ``out_proj`` and ``fc2``
by input features; ``word_embeddings`` by vocabulary rows: the reference's
``(None, "mp")``, ``("mp", None)`` and ``("mp", None)`` in torch's layout)
and sets ``mp_group`` on the attention, the MLP and the embeddings, whose
forwards then run each rank's ``n_head / mp`` heads and ``d_ff / mp``
columns with the Megatron collectives of ``meta_parallel.mp_ops``. A row
bias is added once, after the all-reduce. The tied LM head then gives
vocab-sharded logits, marked with their group, which
``GPTPretrainingCriterion`` takes through ``_c_softmax_with_cross_entropy``
without gathering them.
"""
from __future__ import annotations

import math
import warnings

import torch
import torch.nn.functional as F
from torch import nn
from ..device import resolve_device
from ..distributed.fleet.utils import recompute, recompute_policy_fn
from ..distributed.meta_parallel.mp_ops import (_c_identity, _c_lookup_table,
                                                _c_softmax_with_cross_entropy,
                                                _mp_allreduce)
from ..nn.moe import MoEMLP, validate_moe_config
from ..ops.attention import attention, output_dropout
from ..ops.counter_rng import hashed_dropout, new_key
from ..ops.flash_attention import flash_attention, select_flash_kernel
from ..ops.paged_attention import (paged_attention_route, paged_view,
                                   position_mask)

# the embeddings' dropout site; a block's are 4 * layer + 0, 1, 2
EMBEDDING_SITE = 3

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

# one-time nudge off the growing-concat cache form (below): its shapes grow
# every generated token, so the step can never be one captured CUDA graph
_legacy_cache_warned = False


def _warn_legacy_cache():
    global _legacy_cache_warned
    if _legacy_cache_warned:
        return
    _legacy_cache_warned = True
    warnings.warn(
        "GPTModel's growing-concat KV-cache path (caches= without "
        "cache_offsets=) concatenates onto the cache, so every generated "
        "token changes tensor shapes and copies the whole cache: the step "
        "cannot be captured as a CUDA graph. For real generation use "
        "paddle_tpu_torch.serving.GenerationEngine, which preallocates a "
        "paged KV cache and captures the decode step once.",
        UserWarning, stacklevel=4)


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
                 initializer_range=0.02, moe_num_experts=0, moe_top_k=2,
                 moe_capacity_factor=1.25, moe_every=1,
                 moe_aux_weight=0.01):
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
        # when training, keeping what recompute_policy names (None: full
        # recompute; "dots", "attn", "dots_attn" or a callable: see
        # distributed.fleet.utils.recompute)
        self.use_recompute = use_recompute
        self.recompute_policy = recompute_policy
        self.initializer_range = initializer_range
        # MoE trunk: moe_num_experts=0 keeps the dense MLP; > 0 makes
        # every moe_every-th block's MLP an MoEMLP, validated here as in
        # the reference (MoEConfigError and a moe_config_refused event)
        self.moe_num_experts = int(moe_num_experts)
        self.moe_top_k = int(moe_top_k)
        self.moe_capacity_factor = float(moe_capacity_factor)
        self.moe_every = int(moe_every)
        self.moe_aux_weight = float(moe_aux_weight)
        if self.moe_num_experts > 0:
            validate_moe_config(self.moe_num_experts, self.moe_top_k,
                                self.moe_capacity_factor, op="GPTConfig")

    @classmethod
    def preset(cls, name, **overrides):
        cfg = dict(cls.PRESETS[name])
        cfg.update(overrides)
        return cls(**cfg)

    @property
    def torch_dtype(self):
        return _DTYPES[self.dtype]

    def num_params(self):
        """The dense trunk's parameter count (the reference's formula; it
        does not count expert banks)."""
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
        self.mp_group = None

    def annotate(self):
        """The parameters' ``sharding_spec`` (see the module's docstring)."""
        unit = self.head_dim
        for p, spec, layout in (
                (self.qkv_proj.weight, ("mp", None), (3, unit)),
                (self.qkv_proj.bias, ("mp",), (3, unit)),
                (self.out_proj.weight, (None, "mp"), (1, unit))):
            p.sharding_spec, p.shard_layout = spec, layout

    def _project(self, a):
        """``out_proj``: on the mp form, this rank's heads' partial product,
        all-reduced, then the bias."""
        if self.mp_group is None:
            return self.out_proj(a)
        return _mp_allreduce(F.linear(a, self.out_proj.weight),
                             self.mp_group) + self.out_proj.bias

    def forward(self, x, cache=None, paged=None, slot=None, dropout=None):
        """Cache-less causal attention; or, with ``cache=(k_pool, v_pool)``
        and ``paged`` from :meth:`GPTModel.forward`, the paged branch (the
        pools updated in place); or one of the reference's older forms,
        returning ``(out, new cache)``: ``slot=(cache_offsets, seq_lens)``
        with ``cache=(k_buf, v_buf)`` (:meth:`_slot_cache`), or ``cache``
        alone (:meth:`_concat_cache`). ``dropout``: a function ``(out, p)
        -> out`` drawing the cache-less output's dropout mask in place of
        ``generator`` (:class:`GPTModel`'s counter-based masks)."""
        B, T, _ = x.shape
        if self.mp_group is not None:
            x = _c_identity(x, self.mp_group)
        qkv = self.qkv_proj(x)
        h = qkv.shape[-1] // (3 * self.head_dim)  # this rank's heads
        q, k, v = qkv.view(B, T, 3, h, self.head_dim).unbind(2)
        if cache is None:
            out = flash_attention(q, k, v, causal=True, kernel=self.kernel)
            out = output_dropout(out, 0.0 if dropout else self.dropout_p,
                                 self.training, self.generator)
            out = out.reshape(B, T, h * self.head_dim)
            if dropout is not None and self.training:
                out = dropout(out, self.dropout_p)
            return self._project(out)
        if paged is None:
            legacy = self._slot_cache if slot is not None \
                else self._concat_cache
            out, cache = legacy(q, k, v, cache, slot)
            return self._project(out.reshape(B, T, h * self.head_dim)), cache
        block_tables, seq_lens, offsets, write_rows, kernel = paged
        k_pool, v_pool = cache
        Nb, bs = k_pool.shape[0], k_pool.shape[1]
        shape = (Nb * bs, h, self.head_dim)
        k_pool.view(shape).index_copy_(
            0, write_rows, k.reshape(B * T, h, self.head_dim))
        v_pool.view(shape).index_copy_(
            0, write_rows, v.reshape(B * T, h, self.head_dim))
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
        return self._project(out.reshape(B, T, h * self.head_dim))

    def _masked(self, q, k, v, mask):
        """The older cache forms' attention: the plain masked attention
        (the reference's XLA path there), then output dropout."""
        return output_dropout(attention(q, k, v, mask=mask), self.dropout_p,
                              self.training, self.generator)

    def _slot_cache(self, q, k, v, cache, slot):
        """The reference's slot-cache branch: preallocated ``[B, S, H,
        Dh]`` buffers, the span's rows written at ``cache_offsets[b] + t``,
        attention over the whole buffer under a mask by absolute position
        and valid length. Returns new buffers, as the reference does. A
        row at or past ``S`` is dropped, as the reference's scatter drops
        it (a torch scatter would raise): it goes to a spare row past the
        end, which is cut off."""
        offsets, seq_lens = slot
        k_buf, v_buf = cache
        B, T = q.shape[0], q.shape[1]
        S = k_buf.shape[1]
        rows = offsets.long().unsqueeze(1) + torch.arange(T, device=q.device)
        idx = rows.clamp(max=S).view(B, T, 1, 1).expand(-1, -1, *k.shape[2:])
        new = []
        for buf, val in ((k_buf, k), (v_buf, v)):
            ext = torch.cat([buf, buf.new_zeros(B, 1, *buf.shape[2:])], 1)
            new.append(ext.scatter(1, idx, val.to(buf.dtype))[:, :S])
        out = self._masked(q, new[0], new[1],
                           position_mask(offsets, seq_lens, T, S))
        return out, tuple(new)

    def _concat_cache(self, q, k, v, cache, slot):
        """The reference's growing-concat branch: the span's K/V appended
        to the cache along the sequence. The reference attends without a
        mask there (``is_causal=False``), so each row of a span of more
        than one row also sees the span's later rows (ROADMAP queue 3);
        the port masks by absolute position, which equals the reference
        for one-row spans."""
        k = torch.cat([cache[0], k], dim=1)
        v = torch.cat([cache[1], v], dim=1)
        B, T, S = q.shape[0], q.shape[1], k.shape[1]
        past = torch.full((B,), S - T, dtype=torch.int32, device=q.device)
        out = self._masked(q, k, v, position_mask(past, past + T, T, S))
        return out, (k, v)


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.d_model, cfg.d_ff)
        self.fc2 = nn.Linear(cfg.d_ff, cfg.d_model)
        self.dropout = nn.Dropout(cfg.dropout)
        self.mp_group = None

    def annotate(self):
        for p, spec in ((self.fc1.weight, ("mp", None)),
                        (self.fc1.bias, ("mp",)),
                        (self.fc2.weight, (None, "mp"))):
            p.sharding_spec = spec

    def forward(self, x, dropout=None):
        """``dropout``: as :meth:`GPTAttention.forward`'s."""
        g = self.mp_group
        if g is not None:
            x = _c_identity(x, g)
        h = F.gelu(self.fc1(x), approximate="tanh")
        if g is None:
            y = self.fc2(h)
        else:
            y = _mp_allreduce(F.linear(h, self.fc2.weight), g) + self.fc2.bias
        if dropout is None or not self.training:
            return self.dropout(y)
        return dropout(y, self.dropout.p)


class GPTBlock(nn.Module):
    """Pre-LN block. Its MLP is an ``MoEMLP`` where ``layer_idx %
    moe_every == 0`` in an MoE config, as in the reference."""

    def __init__(self, cfg: GPTConfig, layer_idx=0):
        super().__init__()
        self.ln1 = nn.LayerNorm(cfg.d_model, eps=1e-5)
        self.attn = GPTAttention(cfg)
        self.ln2 = nn.LayerNorm(cfg.d_model, eps=1e-5)
        if cfg.moe_num_experts > 0 and layer_idx % cfg.moe_every == 0:
            std = cfg.initializer_range
            self.mlp = MoEMLP(
                cfg.d_model, cfg.d_ff, cfg.moe_num_experts,
                top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor,
                dropout=cfg.dropout, init_std=std,
                out_init_std=std / math.sqrt(2 * cfg.n_layer))
        else:
            self.mlp = GPTMLP(cfg)
        self.dropout = nn.Dropout(cfg.dropout)
        self.recompute = cfg.use_recompute
        self.recompute_policy = cfg.recompute_policy
        self.layer_idx = layer_idx
        recompute_policy_fn(cfg.recompute_policy)  # refuses unknown names

    def _dropouts(self, mask_key):
        """The block's three dropout sites (attention output, residual,
        MLP output) as ``(y, p) -> y`` functions drawing counter-based
        masks from ``mask_key`` (``(key, batch shard)``, see
        :class:`GPTModel`), the layer and the site; Nones without a key. On
        the mp form the attention output is this rank's heads, a block of
        the columns of all."""
        if mask_key is None:
            return None, None, None
        key, rows = mask_key
        g = self.attn.mp_group
        heads = (0, 1) if g is None else (g.rank, g.nranks)

        def site(i, cols=(0, 1)):
            return lambda y, p: hashed_dropout(
                y, p, key, 4 * self.layer_idx + i, rows, cols)

        return site(0, heads), site(1), site(2)

    def _forward(self, x, cache=None, paged=None, slot=None, moe_rows=False,
                 mask_key=None):
        """The block's output; with an older cache form (``cache`` and no
        ``paged``), ``(output, new cache)``. ``mask_key``: draw the
        dropout masks from :func:`~paddle_tpu_torch.ops.counter_rng.
        hashed_dropout` instead of the generators."""
        attn_drop, res_drop, mlp_drop = self._dropouts(
            mask_key if self.training else None)
        a = self.attn(self.ln1(x), cache=cache, paged=paged, slot=slot,
                      dropout=attn_drop)
        legacy = cache is not None and paged is None
        if legacy:
            a, cache = a
        x = x + (self.dropout(a) if res_drop is None
                 else res_drop(a, self.dropout.p))
        h = self.ln2(x)
        if moe_rows and isinstance(self.mlp, MoEMLP):
            # every row its own routing group, as a decode step routes
            # each slot's one row
            y = self.mlp(h.reshape(-1, 1, h.shape[-1])).view(h.shape)
        else:
            y = self.mlp(h, dropout=mlp_drop)
        return (x + y, cache) if legacy else x + y

    def forward(self, x, cache=None, paged=None, slot=None, moe_rows=False,
                mask_key=None):
        if cache is None and self.recompute and self.training:
            return self._recomputed(x, mask_key)
        return self._forward(x, cache=cache, paged=paged, slot=slot,
                             moe_rows=moe_rows, mask_key=mask_key)

    def _recomputed(self, x, mask_key):
        """The block under :func:`~paddle_tpu_torch.distributed.fleet.utils.
        recompute` with ``recompute_policy``: its activations, less what the
        policy keeps, are dropped after the forward and recomputed in the
        backward. Its dropout masks (``mask_key``, given by
        :class:`GPTModel` when the model has dropout) are a hash of the
        key, the layer, the site and the element, so the recomputation
        makes the forward's masks again without reading any generator's
        state: eagerly and under a CUDA graph's capture alike. An MoE
        MLP's ``aux_loss`` and ``last_stats`` stay the first forward's: the
        recomputation's are put back."""
        moe = self.mlp if isinstance(self.mlp, MoEMLP) else None
        ran = []

        def run(h, key):
            if not ran:
                ran.append(True)
                return self._forward(h, mask_key=key)
            kept = (moe.aux_loss, moe.last_stats) if moe else None
            try:
                return self._forward(h, mask_key=key)
            finally:
                if moe:
                    moe.aux_loss, moe.last_stats = kept

        return recompute(run, x, mask_key, policy=self.recompute_policy)


class GPTEmbeddings(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.position_embeddings = nn.Embedding(cfg.seq_len, cfg.d_model)
        self.dropout = nn.Dropout(cfg.dropout)
        self.mp_group = None

    def annotate(self):
        self.word_embeddings.weight.sharding_spec = ("mp", None)

    def forward(self, input_ids, position_ids=None, mask_key=None):
        """``mask_key``: as :meth:`GPTBlock._dropouts`'."""
        if position_ids is None:
            position_ids = torch.arange(
                input_ids.shape[1], device=input_ids.device).unsqueeze(0)
        if self.mp_group is None:
            tok = self.word_embeddings(input_ids)
        else:
            tok = _c_lookup_table(self.word_embeddings.weight, input_ids,
                                  group=self.mp_group)
        x = tok + self.position_embeddings(position_ids)
        if mask_key is None or not self.training:
            return self.dropout(x)
        key, rows = mask_key
        return hashed_dropout(x, self.dropout.p, key, EMBEDDING_SITE, rows)


class GPTModel(nn.Module):
    """The decoder trunk. ``device=None`` builds on the current CUDA device
    and raises without one; pass ``device="cpu"`` to build on the CPU.
    Weights are drawn from ``generator`` (a ``torch.Generator`` on the
    model's device) or, when it is None, from torch's default generator:
    Normal(0, initializer_range) for embeddings, Linear weights, expert
    banks ``w1`` and gate weights, scaled by 1/sqrt(2*n_layer) for the
    residual-output projections (``out_proj``, ``fc2``, ``w2``), zero
    biases, unit LayerNorm scales — the reference's initializers. The dtype
    cast of a bf16 config covers every weight, the gate's too, as the
    reference's model cast does.

    Dropout: each training forward (the cache-less one) with a dropout
    rate above 0 draws one key of two 32-bit words from ``generator``
    (else torch's default generator on the model's device), and every
    dropout site of the embeddings and the blocks draws its mask from
    :func:`~paddle_tpu_torch.ops.counter_rng.hashed_dropout`: a hash of the
    key, the site and the element's index. A recomputed block thus makes
    its forward's masks again without reading any generator's state, and
    a recomputing model trains as the same model without recompute, under
    ``TrainStep``'s CUDA graph too (a graph draws the key on the card from
    the registered generator). On the mp form every rank draws the same
    key (``fleet.distributed_model`` makes the ranks' ``generator`` one)
    and hashes the index in the whole array: its ``batch_shard``-th block
    of the batch's rows (``spmd.shard_batch``'s rows), and, for the
    attention output inside the column-parallel region, its own heads'
    columns. So the replicated activations get the same mask on every
    rank, each rank's heads their own, and the masks are those of the one
    process that holds the whole batch and every head.

    ``attn_kernel`` picks the cache-less forward's attention route once
    (:func:`~paddle_tpu_torch.ops.flash_attention.select_flash_kernel`):
    None resolves to "cuda" (the flash kernels) on a CUDA device and
    "torch" (plain attention) on the CPU; the choice is ``self.attn_kernel``.
    """

    def __init__(self, cfg: GPTConfig, device=None, generator=None,
                 attn_kernel=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.attn_kernel = select_flash_kernel(
            attn_kernel, device=dev, head_dim=cfg.d_model // cfg.n_head,
            dtype=cfg.torch_dtype)
        with torch.device("meta"):
            self.embeddings = GPTEmbeddings(cfg)
            self.blocks = nn.ModuleList([GPTBlock(cfg, layer_idx=i)
                                         for i in range(cfg.n_layer)])
            self.ln_f = nn.LayerNorm(cfg.d_model, eps=1e-5)
        self.to_empty(device=dev)
        self._init_weights(generator)
        self.to(cfg.torch_dtype)
        for blk in self.blocks:
            blk.attn.kernel = self.attn_kernel
        self.set_generator(generator)
        self.batch_shard = 0  # this rank's block of the batch's rows
        for mod in self.modules():
            if isinstance(mod, (GPTAttention, GPTMLP, GPTEmbeddings,
                                MoEMLP)):
                mod.annotate()

    def set_generator(self, generator):
        """The source of the dropout keys (and of a standalone attention
        call's masks); None: torch's default generator."""
        self.generator = generator
        for blk in self.blocks:
            blk.attn.generator = generator

    def _mask_key(self):
        """This training forward's dropout key, or None without dropout."""
        if not self.training or (self.cfg.dropout <= 0.0
                                 and self.cfg.attn_dropout <= 0.0):
            return None
        return new_key(self.device, self.generator), self.batch_shard

    @torch.no_grad()
    def _init_weights(self, generator):
        std = self.cfg.initializer_range
        out_std = std / math.sqrt(2 * self.cfg.n_layer)
        residual_out = {blk.attn.out_proj for blk in self.blocks}
        residual_out.update(blk.mlp.fc2 for blk in self.blocks
                            if isinstance(blk.mlp, GPTMLP))
        for mod in self.modules():
            if isinstance(mod, MoEMLP):
                mod.reset_parameters(generator)
            elif isinstance(mod, nn.Linear):
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
                paged_kernel=None, moe_rows=False):
        """Cache-less: returns the final hidden states ``[B, T, D]``.

        Paged (``caches`` = per-layer ``(k_pool, v_pool)``, with
        ``cache_offsets`` / ``seq_lens`` ``[B]`` and ``block_tables``
        ``[B, M]``, all int32): writes the span's K/V into the pools in
        place and returns ``(hidden, caches)``. ``paged_kernel`` picks the
        attention read: "cuda" (the kernel), "torch" (its plain version) or
        None (the masked gather path prefill uses).

        The reference's older forms, each returning ``(hidden, new
        caches)``: ``caches`` of per-layer ``[B, S, H, Dh]`` buffers with
        ``cache_offsets`` and ``seq_lens`` and no ``block_tables`` (the
        slot cache), or ``caches`` alone (the growing concat, which warns
        once).

        ``moe_rows`` routes every row of the span through the MoE blocks
        as its own group (``[B*T, 1, H]``), as a decode step routes each
        slot's one row; by default each batch row is one group."""
        if caches is not None and cache_offsets is None:
            _warn_legacy_cache()
        if caches is None:
            mask_key = self._mask_key()
            x = self.embeddings(input_ids, position_ids, mask_key=mask_key)
            for blk in self.blocks:
                x = blk(x, mask_key=mask_key)
            return self.ln_f(x)
        x = self.embeddings(input_ids, position_ids)
        if block_tables is None:
            if cache_offsets is not None and seq_lens is None:
                raise ValueError("the slot cache (cache_offsets without "
                                 "block_tables) needs seq_lens")
            slot = None if cache_offsets is None else (cache_offsets,
                                                       seq_lens)
            new = []
            for blk, c in zip(self.blocks, caches):
                x, c = blk(x, cache=c, slot=slot, moe_rows=moe_rows)
                new.append(c)
            return self.ln_f(x), new
        if cache_offsets is None or seq_lens is None:
            raise ValueError("the paged cache needs cache_offsets and "
                             "seq_lens with block_tables")
        rows = paged_write_rows(cache_offsets, seq_lens, block_tables,
                                caches[0][0].shape[1], input_ids.shape[1])
        paged = (block_tables, seq_lens, cache_offsets, rows, paged_kernel)
        for blk, c in zip(self.blocks, caches):
            x = blk(x, cache=c, paged=paged, moe_rows=moe_rows)
        return self.ln_f(x), caches

    def moe_aux_loss(self):
        """``moe_aux_weight`` times the sum of every MoE block's
        load-balancing loss from the latest forward (read it in the same
        training step), or None for a dense trunk."""
        total = None
        for blk in self.blocks:
            aux = getattr(blk.mlp, "aux_loss", None)
            if aux is not None:
                total = aux if total is None else total + aux
        return None if total is None else total * self.cfg.moe_aux_weight


class GPTForPretraining(nn.Module):
    """LM head tied to the word embeddings."""

    def __init__(self, model: GPTModel):
        super().__init__()
        self.gpt = model

    def lm_logits(self, hidden):
        """``hidden @ word_embeddings.weight.T``; on the mp form, this rank's
        vocabulary columns, marked ``vocab_parallel_group``."""
        emb = self.gpt.embeddings
        w = emb.word_embeddings.weight
        if emb.mp_group is None:
            return hidden @ w.t()
        logits = _c_identity(hidden, emb.mp_group) @ w.t()
        logits.vocab_parallel_group = emb.mp_group
        return logits

    def forward(self, input_ids, position_ids=None):
        return self.lm_logits(self.gpt(input_ids, position_ids))

    def moe_aux_loss(self):
        return self.gpt.moe_aux_loss()

    def pipeline_parts(self, pp):
        """The stage slicing of a pipeline (``distributed.pp_spmd``,
        ``fleet.HybridParallelEngine``): ``(embed, blocks, head)``, the
        embeddings for the first stage, the block trunk to split into
        ``pp`` equal slices, and ``ln_f`` plus the tied LM head for the
        last. Refuses an MoE trunk (``moe_trunk``) and a layer count
        ``pp`` does not divide (``stage_indivisible``), as the reference
        does."""
        from ..distributed.meta_parallel.pp_layers import refuse

        L = len(self.gpt.blocks)
        if self.gpt.cfg.moe_num_experts > 0:
            raise refuse(
                "gpt.pipeline_parts", "moe_trunk",
                "MoE-bearing GPT configs do not support pipeline "
                "parallelism (pp>1): use dp/ep/mp degrees instead",
                n_layers=L, pp=pp,
                moe_num_experts=self.gpt.cfg.moe_num_experts)
        if pp < 1 or L % pp != 0:
            raise refuse(
                "gpt.pipeline_parts", "stage_indivisible",
                f"GPT n_layer={L} is not divisible by pp={pp}: each "
                f"pipeline stage must own an equal slice of the block "
                f"trunk (choose n_layer a multiple of pp_degree)",
                n_layers=L, pp=pp)

        def head(x):
            return self.lm_logits(self.gpt.ln_f(x))

        return self.gpt.embeddings, list(self.gpt.blocks), head


class GPTPretrainingCriterion(nn.Module):
    """Mean next-token cross-entropy: ``-log_softmax(logits)[label]`` in the
    logits' dtype, averaged over every position, or over the positions
    ``loss_mask`` keeps (its sum clipped at 1), as in the reference.
    Vocab-sharded logits (marked ``vocab_parallel_group`` by the mp form's
    LM head) go through ``_c_softmax_with_cross_entropy``, whose float32
    loss per position is rounded to the logits' dtype."""

    def forward(self, logits, labels, loss_mask=None):
        group = getattr(logits, "vocab_parallel_group", None)
        flat = logits.reshape(-1, logits.shape[-1])
        if group is not None:
            loss = _c_softmax_with_cross_entropy(
                flat, labels.reshape(-1), group).to(logits.dtype)
        else:
            logp = torch.log_softmax(flat, dim=-1)
            loss = -logp.gather(1, labels.reshape(-1, 1).long()).squeeze(1)
        if loss_mask is not None:
            m = loss_mask.reshape(-1).to(loss.dtype)
            return (loss * m).sum() / m.sum().clamp(min=1.0)
        return loss.mean()
