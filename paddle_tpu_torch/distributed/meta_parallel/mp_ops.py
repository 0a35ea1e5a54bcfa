"""Tensor-parallel primitives (counterpart of
paddle_tpu/distributed/meta_parallel/mp_ops.py), each a
``torch.autograd.Function`` over the mp group, in the f/g pairs of
Megatron-LM:

* ``_c_identity``: forward identity, backward all-reduce (the replicated
  input of a column-parallel layer);
* ``_mp_allreduce``: forward all-reduce, backward identity (the partial
  sums of a row-parallel layer);
* ``_c_split``: forward this rank's chunk of the last dim, backward
  all-gather; ``_c_concat``: forward all-gather of the last dim, backward
  this rank's chunk;
* ``_c_lookup_table``: a vocab-sharded embedding lookup (ids outside this
  rank's rows give zeros; the all-reduce assembles every row);
* ``_c_softmax_with_cross_entropy``: cross-entropy over vocab-sharded
  logits without gathering them: the max and the sum of exponentials are
  reduced over the group, and the label's logit is taken from the rank
  that holds it.

The reference runs these inside ``shard_map`` on shard-local arrays (and as
layout annotations outside); here every rank is a process holding its
shard, so they always run on local tensors. ``group`` is a
``collective.Group`` or an axis name (default ``"mp"``); a group of one
process makes every primitive local. Counters (registry scope ``mp``):
``<op>.calls`` / ``<op>.bytes`` per forward call.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...profiler import registry as _registry
from .. import collective, parallel_env

__all__ = ["_c_identity", "_mp_allreduce", "_c_split", "_c_concat",
           "_c_lookup_table", "_c_softmax_with_cross_entropy",
           "mp_group", "MP_AXIS"]

MP_AXIS = "mp"


def _tally(name, *tensors):
    _registry.tally("mp", name, *tensors)


def mp_group(group=None):
    """``group`` as a ``collective.Group`` (None: the fleet's mp group, or
    this process alone before ``fleet.init``)."""
    if isinstance(group, collective.Group):
        return group
    try:
        return collective.axis_group(group or MP_AXIS)
    except ValueError:
        return collective.Group([parallel_env.get_rank()], 0, None,
                                axis_name=MP_AXIS)


def _chunk(x, group):
    n = group.nranks
    size = x.shape[-1] // n
    return x.narrow(-1, group.rank * size, size).contiguous()


class _Identity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collective.psum(g, ctx.group), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return collective.psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _chunk(x, group)

    @staticmethod
    def backward(ctx, g):
        return collective.all_gather_axis(g.contiguous(), ctx.group,
                                          tiled_dim=g.dim() - 1), None


class _Concat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return collective.all_gather_axis(x.contiguous(), group,
                                          tiled_dim=x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.group), None


def _c_identity(x, group=None):
    _tally("_c_identity", x)
    g = mp_group(group)
    return x if g.nranks == 1 else _Identity.apply(x, g)


def _mp_allreduce(x, group=None):
    _tally("_mp_allreduce", x)
    g = mp_group(group)
    return x if g.nranks == 1 else _AllReduce.apply(x, g)


def _c_split(x, group=None):
    _tally("_c_split", x)
    g = mp_group(group)
    return x if g.nranks == 1 else _Split.apply(x, g)


def _c_concat(x, group=None):
    _tally("_c_concat", x)
    g = mp_group(group)
    return x if g.nranks == 1 else _Concat.apply(x, g)


def _c_lookup_table(table, ids, start_index=0, group=None):
    """Rows ``ids`` of a table whose rank ``r`` holds rows ``[start_index +
    r * V_local, start_index + (r + 1) * V_local)`` as ``table``."""
    _tally("_c_lookup_table", table)
    g = mp_group(group)
    v_local = table.shape[0]
    local = ids.long() - (start_index + g.rank * v_local)
    valid = (local >= 0) & (local < v_local)
    rows = F.embedding(local.clamp(0, v_local - 1), table)
    rows = rows * valid.unsqueeze(-1).to(rows.dtype)
    return rows if g.nranks == 1 else _AllReduce.apply(rows, g)


class _ShardedCE(torch.autograd.Function):
    """Cross-entropy per position over vocab-sharded logits ``[..., V/mp]``
    in float32; the gradient, ``softmax - onehot`` on this rank's columns,
    in the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, label, group, ignore_index):
        lg = logits.float()
        v_local = lg.shape[-1]
        m = collective.pmax(lg.max(-1).values, group)
        shifted = lg - m.unsqueeze(-1)
        e = shifted.exp()
        sumexp = collective.psum(e.sum(-1), group)
        local = label.long() - group.rank * v_local
        valid = (local >= 0) & (local < v_local)
        safe = local.clamp(0, v_local - 1).unsqueeze(-1)
        picked = shifted.gather(-1, safe).squeeze(-1)
        label_logit = collective.psum(
            torch.where(valid, picked, torch.zeros_like(picked)), group)
        loss = sumexp.log() - label_logit
        keep = None
        if ignore_index >= 0:
            keep = label != ignore_index
            loss = torch.where(keep, loss, torch.zeros_like(loss))
        ctx.save_for_backward(e, sumexp, safe, valid, keep)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        e, sumexp, safe, valid, keep = ctx.saved_tensors
        grad = e / sumexp.unsqueeze(-1)
        grad.scatter_add_(-1, safe, -valid.to(grad.dtype).unsqueeze(-1))
        scale = g.float() if keep is None else \
            torch.where(keep, g.float(), torch.zeros_like(g, dtype=grad.dtype))
        return (grad * scale.unsqueeze(-1)).to(ctx.dtype), None, None, None


def _c_softmax_with_cross_entropy(logits, label, group=None,
                                  ignore_index=-100):
    """Per-position loss ``[...]`` (float32) of vocab-sharded ``logits``
    ``[..., V/mp]`` at integer ``label`` ``[...]`` (global vocab ids);
    positions whose label is ``ignore_index`` (when it is >= 0) give 0."""
    _tally("_c_softmax_with_cross_entropy", logits)
    return _ShardedCE.apply(logits, label, mp_group(group), ignore_index)
