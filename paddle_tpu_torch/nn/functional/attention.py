"""The functional entries to the attention kernels (counterpart of
``scaled_dot_product_attention`` and ``paged_attention`` in
paddle_tpu/ops/nn_ops.py, the reference's functional routes to its Pallas
kernels K1-K4).

``scaled_dot_product_attention`` goes through ``ops.flash_attention``: on
CUDA tensors an eligible call (no mask, a sequence length a multiple of
128, a head_dim and dtype the kernels take) launches K1 forward and K2 + K3
backward; anything else takes the plain route and records why. On CPU
tensors it is the plain route. Where the reference drops the attention
OUTPUT for ``dropout_p`` (ROADMAP queue 3), the port follows Paddle and
drops the attention PROBABILITIES. The kernels K1-K3 carry no dropout of
the probabilities yet (ROADMAP queue 1), so on CUDA tensors a call that
trains with ``dropout_p > 0`` raises, naming the argument; on CPU tensors
the plain route drops them. The GPT model's attention keeps the
reference's output dropout (``ops.attention.output_dropout``), which runs
after K1.

``paged_attention`` maps the reference's ``kernel`` names: "pallas" and
"interpret" (the same kernel body, in the reference's interpreter) launch
K4 on CUDA tensors (``ops.paged_attention.paged_attention_route("cuda",
...)``; on CPU tensors the wrapper computes K4's plain version), "xla" is
the plain gather route. A ``mesh`` of more than one "mp" rank runs K4 per
shard, over this rank's contiguous block of heads, and gathers the heads
over the mesh's group, as the reference's ``shard_map`` returns them.
"""
from __future__ import annotations

import torch

from ...ops.attention import attention_logits
from ...ops.flash_attention import flash_attention
from ...ops.paged_attention import (_mesh_mp_degree, paged_attention_ref,
                                    paged_attention_route)
from .common import dropout

__all__ = ["scaled_dot_product_attention", "paged_attention"]


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, dropout_key=None):
    """``softmax(q k^T / sqrt(H) [+ mask]) v`` over ``[B, T, N, H]``
    inputs. Training with ``dropout_p > 0`` drops the probabilities
    (``upscale_in_train``, counter-based masks keyed by ``dropout_key``,
    None: drawn from torch's default generator): on CPU tensors, on the
    plain route; on CUDA tensors it raises, since the kernels carry no
    such dropout."""
    if dropout_p > 0.0 and training:
        if query.is_cuda:
            raise NotImplementedError(
                f"scaled_dot_product_attention: dropout_p={dropout_p} in "
                "training on CUDA tensors: the flash kernels K1-K3 do not "
                "drop the attention probabilities yet; pass dropout_p=0 "
                "or training=False")
        logits = attention_logits(query, key, attn_mask, is_causal)
        probs = dropout(torch.softmax(logits, dim=-1), dropout_p,
                        key=dropout_key).to(query.dtype)
        return torch.einsum("bnqk,bknh->bqnh", probs, value)
    return flash_attention(query, key, value, mask=attn_mask,
                           causal=is_causal)


def paged_attention(query, k_pool, v_pool, block_tables, seq_lens,
                    q_offsets, kernel="xla", mesh=None, name=None):
    """``query [B, T, H, Dh]`` over the pools ``[Nb, bs, H, Dh]`` through
    ``block_tables [B, M]``; ``seq_lens [B]`` counts each slot's valid rows
    including the span's own, ``q_offsets [B]`` is the position of span
    row 0. ``kernel``: "pallas" | "interpret" (K4) or "xla" (plain)."""
    if kernel == "xla":
        return paged_attention_ref(query, k_pool, v_pool, block_tables,
                                   seq_lens, q_offsets)
    if kernel not in ("pallas", "interpret"):
        raise ValueError(f"unknown paged-attention kernel {kernel!r} "
                         "(expected pallas | interpret | xla)")
    mp = _mesh_mp_degree(mesh)
    if mp == 1:
        return paged_attention_route("cuda", query, k_pool, v_pool,
                                     block_tables, seq_lens, q_offsets)
    H = query.shape[2]
    if H % mp:
        raise ValueError(f"paged_attention: {H} heads do not divide over "
                         f"mesh axis mp={mp}")
    if not hasattr(mesh, "get_model_parallel_group"):
        raise ValueError("paged_attention: a mesh of more than one rank "
                         "must name its group (distributed.spmd."
                         "serving_mesh)")
    group = mesh.get_model_parallel_group()
    h = H // mp
    heads = slice(group.rank * h, (group.rank + 1) * h)
    local = paged_attention_route(
        "cuda", query[:, :, heads], k_pool[:, :, heads].contiguous(),
        v_pool[:, :, heads].contiguous(), block_tables, seq_lens, q_offsets)
    from ...distributed import collective

    parts = []
    collective.all_gather(parts, local.contiguous(), group=group)
    return torch.cat(parts, dim=2)
