"""Tensor-parallel layers (counterpart of
paddle_tpu/distributed/meta_parallel/mp_layers.py). Each holds its rank's
shard of the weight as a plain tensor; the reference holds the full
weight placed on a mesh. Layouts are torch's (a Linear weight is ``[out,
in]``):

* ``VocabParallelEmbedding``: rows ``[r * V/mp, (r + 1) * V/mp)`` of the
  table; the lookup is ``mp_ops._c_lookup_table``;
* ``ColumnParallelLinear``: output features ``[r * out/mp, ...)`` and
  their bias; the input passes ``_c_identity`` (its gradient is summed
  over the group), and ``gather_output`` all-gathers the output;
* ``RowParallelLinear``: input features ``[r * in/mp, ...)``; the partial
  products are all-reduced (``_mp_allreduce``) and the full bias is added
  once, after the reduction; ``input_is_parallel=False`` takes this rank's
  chunk of a replicated input first;
* ``ParallelCrossEntropy``: ``_c_softmax_with_cross_entropy`` on
  vocab-sharded logits.

A dimension that the mp degree does not divide stays whole on every rank
(the reference's rule), and the layer then runs without collectives.
``mp_group`` is a ``collective.Group`` (default: the fleet's mp group).
Weights are initialised as torch's ``nn.Linear`` / ``nn.Embedding``
initialise theirs (from ``generator`` when given); parity tests copy the
reference's weights in through :func:`~paddle_tpu_torch.distributed.spmd.local_shard`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import mp_ops
from .mp_ops import (_c_concat, _c_identity, _c_lookup_table,
                     _c_softmax_with_cross_entropy, _c_split, _mp_allreduce)

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy"]


def _split(size, group):
    """``(local size, sharded)`` of a dimension of ``size`` over the
    group."""
    n = group.nranks
    if n > 1 and size % n == 0:
        return size // n, True
    return size, False


def _param(shape, device, dtype, spec, group=None, sharded=False):
    """A parameter annotated with ``spec``; a local shard (``sharded``)
    records it as ``mp_shard``, so ``spmd.shard_model`` leaves it be."""
    p = nn.Parameter(torch.empty(shape, device=device, dtype=dtype))
    p.sharding_spec = spec
    if sharded:
        p.mp_shard = (spec.index("mp"), (1, 1), group.rank, group.nranks)
    return p


class VocabParallelEmbedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.group = mp_ops.mp_group(mp_group)
        local, self.sharded = _split(num_embeddings, self.group)
        self.weight = _param((local, embedding_dim), device, dtype,
                             ("mp", None), self.group, self.sharded)
        with torch.no_grad():
            self.weight.normal_(generator=generator)

    def forward(self, x):
        if not self.sharded:
            return F.embedding(x, self.weight)
        return _c_lookup_table(self.weight, x, group=self.group)


class ColumnParallelLinear(nn.Module):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, mp_group=None,
                 fuse_matmul_bias=False, name=None, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.group = mp_ops.mp_group(mp_group)
        local, self.sharded = _split(out_features, self.group)
        self.gather_output = gather_output
        self.weight = _param((local, in_features), device, dtype,
                             ("mp", None), self.group, self.sharded)
        self.bias = _param((local,), device, dtype, ("mp",), self.group,
                           self.sharded) if has_bias else None
        _init_linear(self.weight, self.bias, in_features, generator)

    def forward(self, x):
        if not self.sharded:
            return F.linear(x, self.weight, self.bias)
        out = F.linear(_c_identity(x, self.group), self.weight, self.bias)
        return _c_concat(out, self.group) if self.gather_output else out


class RowParallelLinear(nn.Module):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False, mp_group=None,
                 fuse_matmul_bias=False, name=None, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.group = mp_ops.mp_group(mp_group)
        local, self.sharded = _split(in_features, self.group)
        self.input_is_parallel = input_is_parallel
        self.weight = _param((out_features, local), device, dtype,
                             (None, "mp"), self.group, self.sharded)
        self.bias = _param((out_features,), device, dtype, None) \
            if has_bias else None
        _init_linear(self.weight, self.bias, in_features, generator)

    def forward(self, x):
        if not self.sharded:
            return F.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = _c_split(x, self.group)
        out = _mp_allreduce(F.linear(x, self.weight), self.group)
        return out if self.bias is None else out + self.bias


def _init_linear(weight, bias, fan_in, generator):
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=generator)
        if bias is not None:
            bias.uniform_(-bound, bound, generator=generator)


class ParallelCrossEntropy(nn.Module):
    """Per-position loss ``[..., 1]`` of vocab-sharded logits; a label of
    shape ``[..., 1]`` or ``[...]``."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.group = mp_ops.mp_group(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        if label.dim() == input.dim():
            label = label[..., 0]
        loss = _c_softmax_with_cross_entropy(input, label, self.group,
                                             self.ignore_index)
        return loss.unsqueeze(-1)
