"""Metrics aggregated over ranks (counterpart of
paddle_tpu/distributed/fleet/metrics.py): each rank passes its local
counter, every rank gets the group's reduction as a numpy array. The
derived metrics reduce their counters, never their ratios. The reference
holds the ranks' counters as the rows of one array; here rank ``r``'s
local value is row ``r``."""
from __future__ import annotations

import numpy as np
import torch

from .. import collective

__all__ = ["sum", "max", "min", "mean", "acc", "auc"]

_builtin_max = max


def _reduce(local_value, op, group):
    group = group or collective.get_group(0)
    if isinstance(local_value, torch.Tensor):
        t = local_value.detach().to("cpu", torch.float64).clone()
    else:
        t = torch.as_tensor(np.asarray(local_value, np.float64))
    collective.all_reduce(t, op, group=group)
    return t.numpy().astype(np.float32)


def sum(local_value, group=None):  # noqa: A001 (the reference's name)
    """The sum of every rank's ``local_value``."""
    return _reduce(local_value, collective.ReduceOp.SUM, group)


def max(local_value, group=None):  # noqa: A001
    return _reduce(local_value, collective.ReduceOp.MAX, group)


def min(local_value, group=None):  # noqa: A001
    return _reduce(local_value, collective.ReduceOp.MIN, group)


def mean(local_value, group=None):
    group = group or collective.get_group(0)
    return sum(local_value, group) / _builtin_max(group.nranks, 1)


def acc(correct, total, group=None):
    """Accuracy from every rank's ``(correct, total)`` counters."""
    c = sum(correct, group)
    t = sum(total, group)
    return float(np.asarray(c).reshape(-1)[0] /
                 _builtin_max(float(np.asarray(t).reshape(-1)[0]), 1.0))


def auc(stat_pos, stat_neg, group=None):
    """AUC from every rank's histograms of positive and negative
    predictions by threshold bucket: the histograms are summed, then the
    ROC curve is integrated from the highest bucket down."""
    pos = np.asarray(sum(stat_pos, group), np.float64).reshape(-1)
    neg = np.asarray(sum(stat_neg, group), np.float64).reshape(-1)
    tot_pos = pos.sum()
    tot_neg = neg.sum()
    if tot_pos == 0 or tot_neg == 0:
        return 0.5
    area = 0.0
    cum_pos = 0.0
    cum_neg = 0.0
    for i in range(len(pos) - 1, -1, -1):
        new_pos = cum_pos + pos[i]
        new_neg = cum_neg + neg[i]
        area += (new_neg - cum_neg) * (cum_pos + new_pos) / 2.0
        cum_pos, cum_neg = new_pos, new_neg
    return float(area / (tot_pos * tot_neg))
