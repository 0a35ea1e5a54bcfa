"""Losses and distances (counterpart of the loss ops of
paddle_tpu/ops/nn_ops.py:816-1079). Each is the reference's formula on
torch tensors; where torch has the same function it is called, so
``auto_cast``'s black list (``mse_loss``, ``l1_loss``, ``nll_loss``, ...)
keeps it in float32.

Where the reference departs from Paddle the port follows Paddle (ROADMAP
queue 3): a hard label equal to ``ignore_index`` is dropped whatever its
sign (``cross_entropy``, ``nll_loss``); ``binary_cross_entropy_with_logits``
weighs only the positive term by ``pos_weight``; ``ctc_loss``'s ``"mean"``
divides each sequence's loss by its label length first. Where the reference
ignores an argument the port refuses a value it cannot honour:
``rnnt_loss``'s ``fastemit_lambda`` other than 0, and a ``group`` of more
than one rank for ``margin_cross_entropy`` and ``class_center_sample``.

``rnnt_loss`` runs the reference's forward-variable recursion over the
``(T, U + 1)`` lattice as an anti-diagonal wavefront: ``T + U`` steps, each
vectorised over the batch and one diagonal, where the reference takes
``T * (U + 1)`` dependent steps. Every cell computes the reference's
``logaddexp`` of the same two terms, so the values agree cell by cell.
"""
from __future__ import annotations

import functools
import logging

import numpy as np
import torch
import torch.nn.functional as F

from ...profiler import explainer as _explain

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "mse_loss", "l1_loss",
    "nll_loss", "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "smooth_l1_loss", "kl_div", "margin_ranking_loss",
    "hinge_embedding_loss", "cosine_similarity", "cosine_embedding_loss",
    "label_smooth", "log_loss", "square_error_cost", "sigmoid_focal_loss",
    "dice_loss", "ctc_loss", "triplet_margin_loss", "pairwise_distance",
    "npair_loss", "rnnt_loss", "margin_cross_entropy", "hsigmoid_loss",
    "class_center_sample",
]

_log = logging.getLogger(__name__)


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"reduction {reduction!r} (expected mean | sum | none)")


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """The reference's cross_entropy over class dimension ``axis``, in the
    input's dtype: ``-log_softmax(input)[label]`` (``use_softmax=False``:
    ``-log(max(input, 1e-30))[label]``), with ``soft_label`` a distribution
    per row, ``label_smoothing`` mixing the one-hot label with the uniform
    one, and ``weight`` scaling each row by its label's class weight.

    A hard label equal to ``ignore_index`` contributes nothing and a
    ``"mean"`` averages over the rows kept. The reference drops such rows
    only when ``ignore_index >= 0``, so its default of -100 drops none
    (ROADMAP queue 3); the port drops them for any ``ignore_index``, as
    Paddle does."""
    lp = (torch.log_softmax(input, dim=axis) if use_softmax
          else torch.log(input.clamp_min(1e-30)))
    if soft_label:
        loss = -(label * lp).sum(axis)
        return _reduce(loss, reduction)
    lab = label.long()
    if lab.dim() == lp.dim():
        lab = lab.squeeze(axis)
    keep = lab != ignore_index
    safe = torch.where(keep, lab, torch.zeros_like(lab))
    if label_smoothing > 0.0:
        n = lp.shape[axis]
        onehot = F.one_hot(safe, n).to(lp.dtype).movedim(-1, axis)
        soft = onehot * (1 - label_smoothing) + label_smoothing / n
        loss = -(soft * lp).sum(axis)
    else:
        loss = -lp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if weight is not None:
        loss = loss * weight[safe]
    loss = torch.where(keep, loss, torch.zeros((), dtype=loss.dtype,
                                               device=loss.device))
    if reduction == "mean":
        return loss.sum() / keep.sum().clamp_min(1)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """Per-row losses with the class dimension kept (size 1)."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, axis)
    return loss


def mse_loss(input, label, reduction="mean", name=None):
    return F.mse_loss(input, label, reduction=reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return F.l1_loss(input, label, reduction=reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """``-input[label]`` per row, weighted by ``weight[label]``; ``"mean"``
    divides by the weights kept."""
    return F.nll_loss(input, label.long(), weight, ignore_index=ignore_index,
                      reduction=reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    """``-(y log p + (1 - y) log(1 - p))``, each log of at least 1e-12."""
    loss = -(label * torch.log(input.clamp_min(1e-12))
             + (1 - label) * torch.log((1 - input).clamp_min(1e-12)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """``-(pos_weight y log sigmoid(z) + (1 - y) log(1 - sigmoid(z)))``,
    times ``weight``."""
    return F.binary_cross_entropy_with_logits(
        logit, label, weight, reduction=reduction, pos_weight=pos_weight)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """``0.5 d^2 / delta`` where ``|d| < delta``, else ``|d| - 0.5
    delta``."""
    return F.smooth_l1_loss(input, label, reduction=reduction, beta=delta)


def kl_div(input, label, reduction="mean", name=None):
    """``y (log y - input)`` with ``input`` log-probabilities; ``y = 0``
    contributes 0."""
    loss = label * (torch.log(label.clamp_min(1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce((-label * (input - other) + margin).clamp_min(0.0),
                   reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    loss = torch.where(label == 1, input, (margin - input).clamp_min(0.0))
    return _reduce(loss, reduction)


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    """``x1 . x2 / max(|x1| |x2|, eps)`` along ``axis``."""
    dot = (x1 * x2).sum(axis)
    norms = x1.square().sum(axis).sqrt() * x2.square().sum(axis).sqrt()
    return dot / norms.clamp_min(eps)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    cos = (input1 * input2).sum(-1) / (
        input1.norm(dim=-1) * input2.norm(dim=-1)).clamp_min(1e-12)
    loss = torch.where(label == 1, 1 - cos, (cos - margin).clamp_min(0.0))
    return _reduce(loss, reduction)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def log_loss(input, label, epsilon=1e-4, name=None):
    return (-label * torch.log(input + epsilon)
            - (1 - label) * torch.log(1 - input + epsilon))


def square_error_cost(input, label, name=None):
    return (input - label).square()


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    p = torch.sigmoid(logit)
    ce = logit.clamp_min(0) - logit * label + torch.log1p(
        torch.exp(-logit.abs()))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * (1 - p_t).pow(gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """``1 - (2 |p . y| + eps) / (|p| + |y| + eps)`` per sample, averaged;
    ``label`` holds class ids with a trailing dimension of 1."""
    y = F.one_hot(label.long().squeeze(-1), input.shape[-1]).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = (input * y).sum(dims)
    union = input.sum(dims) + y.sum(dims)
    return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over ``log_probs`` ``[T, B, C]`` (log-softmax over C);
    ``"mean"`` averages each sequence's loss divided by its label length,
    as Paddle does."""
    lp = torch.log_softmax(log_probs, -1)
    return F.ctc_loss(lp, labels.long(), input_lengths.long(),
                      label_lengths.long(), blank=blank,
                      reduction=reduction, zero_infinity=False)


def _pdist(a, b, p, epsilon, keepdim=False):
    return (a - b).abs().add(epsilon).pow(p).sum(-1, keepdim=keepdim) \
        .pow(1.0 / p)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    dp = _pdist(input, positive, p, epsilon)
    dn = _pdist(input, negative, p, epsilon)
    if swap:
        dn = torch.minimum(dn, _pdist(positive, negative, p, epsilon))
    return _reduce((dp - dn + margin).clamp_min(0.0), reduction)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """``(sum |x - y| + eps)^p)^(1/p)`` over the last dimension."""
    return _pdist(x, y, p, epsilon, keepdim)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    sim = anchor @ positive.T
    y = labels.reshape(-1, 1)
    same = (y == y.T).to(anchor.dtype)
    same = same / same.sum(1, keepdim=True)
    ce = -(torch.log_softmax(sim, 1) * same).sum(1).mean()
    reg = l2_reg * (anchor.square().sum(1).mean()
                    + positive.square().sum(1).mean()) / 2
    return ce + reg


# the reference's stand-in for log(0) in the RNN-T lattice
_NEG = -1e30


def _skew(x, T, U1, t_shift):
    """``x [B, T, U1]`` read along anti-diagonals: ``out[b, d, u] = x[b, d -
    u + t_shift, u]``, and where that row lies outside ``[0, T)`` a mask
    that is False."""
    D = T + U1 - 1
    d = torch.arange(D, device=x.device)[:, None]
    u = torch.arange(U1, device=x.device)[None, :]
    t = d - u + t_shift
    valid = (t >= 0) & (t < T)
    idx = t.clamp(0, T - 1)
    out = x.gather(1, idx[None].expand(x.shape[0], D, U1))
    return out, valid


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.0, reduction="mean", name=None):
    """RNN-T loss of ``input`` ``[B, T, U + 1, V]`` logits (log-softmax
    over V in float32, or float64 for float64 logits), ``label`` ``[B,
    U]``: ``-log P(label | input)``
    from the forward variables ``alpha [t, u] = logaddexp(alpha[t - 1, u]
    + blank[t - 1, u], alpha[t, u - 1] + emit[t, u - 1])`` (row 0 emits
    only, column 0 takes blanks only), read at each sequence's
    ``(input_length - 1, label_length)``. The gradient comes from
    autograd."""
    if fastemit_lambda != 0.0:
        raise ValueError(f"rnnt_loss: fastemit_lambda={fastemit_lambda} is "
                         "not supported (only 0: plain RNN-T)")
    logp = torch.log_softmax(
        input if input.dtype == torch.float64 else input.float(), -1)
    B, T, U1, V = logp.shape
    blank_lp = logp[..., blank]                                # [B, T, U1]
    lab = label.long().clamp(0, V - 1)
    emit = logp[:, :, :-1, :].gather(
        -1, lab[:, None, :, None].expand(B, T, U1 - 1, 1))[..., 0]
    # emit[t, u - 1] sits at column u; column 0 never emits into
    emit = F.pad(emit, (1, 0), value=_NEG)                     # [B, T, U1]
    from_top, top_ok = _skew(blank_lp, T, U1, -1)   # blank[t - 1, u]
    from_left, cell_ok = _skew(emit, T, U1, 0)      # emit[t, u - 1]
    left_ok = cell_ok & (torch.arange(U1, device=logp.device) > 0)
    neg = torch.full((), _NEG, dtype=logp.dtype, device=logp.device)
    first = torch.where(torch.arange(U1, device=logp.device) == 0,
                        torch.zeros_like(neg), neg)
    alphas = [first.expand(B, U1)]
    for d in range(1, T + U1 - 1):
        prev = alphas[-1]
        top = torch.where(top_ok[d], prev + from_top[:, d], neg)
        shifted = F.pad(prev[:, :-1], (1, 0), value=_NEG)
        left = torch.where(left_ok[d], shifted + from_left[:, d], neg)
        alphas.append(torch.where(cell_ok[d], torch.logaddexp(top, left),
                                  neg))
    alpha = torch.stack(alphas, 1)                             # [B, D, U1]
    bi = torch.arange(B, device=logp.device)
    t_last = (input_lengths.long() - 1).clamp(0, T - 1)
    u_last = label_lengths.long().clamp(0, U1 - 1)
    final = alpha[bi, t_last + u_last, u_last] + blank_lp[bi, t_last,
                                                         u_last]
    return _reduce(-final, reduction)


def _one_rank(group, op):
    if group is not None and group is not False and \
            getattr(group, "nranks", 1) > 1:
        raise ValueError(f"{op}: a group of {group.nranks} ranks (the "
                         "class-parallel form) is not supported; the port "
                         "computes over one rank's classes")


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """ArcFace / CosFace loss: ``logits`` are cosines; the label's becomes
    ``cos(margin1 * theta + margin2) - margin3``, every logit is scaled by
    ``scale``, then softmax cross entropy (``"none"``: ``[B, 1]``). With
    ``return_softmax`` also the softmax."""
    _one_rank(group, "margin_cross_entropy")
    lab = label.reshape(-1).long()
    theta = torch.acos(logits.clamp(-1.0 + 1e-7, 1.0 - 1e-7))
    target = torch.cos(margin1 * theta + margin2) - margin3
    onehot = F.one_hot(lab, logits.shape[-1]).bool()
    adj = torch.where(onehot, target, logits) * scale
    logp = torch.log_softmax(adj.float(), -1)
    loss = -logp.gather(-1, lab[:, None])
    out = _reduce(loss, reduction)
    return (out, logp.exp()) if return_softmax else out


@functools.lru_cache(maxsize=None)
def _complete_tree_paths(num_classes):
    """The reference's default tree: class c is leaf ``c + num_classes -
    1`` of a heap-ordered complete binary tree; its path holds the internal
    nodes from the root down and its code 1 where the step goes to a left
    (odd) child, padded with -1 / 0 to the tree's depth."""
    depth = int(np.ceil(np.log2(max(num_classes, 2))))
    tables, codes = [], []
    for c in range(num_classes):
        node, t, k = c + num_classes - 1, [], []
        while node > 0:
            parent = (node - 1) // 2
            t.append(parent)
            k.append(node % 2)
            node = parent
        t = t[::-1][:depth] + [-1] * max(0, depth - len(t))
        k = k[::-1][:depth] + [0] * max(0, depth - len(k))
        tables.append(t[:depth])
        codes.append(k[:depth])
    return np.asarray(tables, np.int64), np.asarray(codes, np.int64)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss ``[B, 1]``: the sum over the label's path
    of ``softplus((1 - 2 code) (w_node . x + b_node))``; the path is the
    complete tree's by default, else ``path_table`` / ``path_code`` (-1
    ends a path)."""
    if path_table is None:
        table, code = _complete_tree_paths(int(num_classes))
        path_table = torch.from_numpy(table).to(input.device)
        path_code = torch.from_numpy(code).to(input.device)
    lab = label.reshape(-1).long()
    nodes = path_table.long()[lab]                              # [B, D]
    codes = path_code.long()[lab]
    valid = nodes >= 0
    ni = nodes.clamp(0, weight.shape[0] - 1)
    logits = torch.einsum("bdf,bf->bd", weight[ni], input)
    if bias is not None:
        logits = logits + bias.reshape(-1)[ni]
    per_node = F.softplus((1.0 - 2.0 * codes.to(logits.dtype)) * logits)
    return torch.where(valid, per_node, torch.zeros_like(per_node)).sum(
        -1, keepdim=True)


def class_center_sample(label, num_classes, num_samples, group=None):
    """PartialFC's sampling, as the reference draws it on the host: every
    positive class of ``label``, then negatives drawn without replacement
    (numpy's generator seeded from the labels) up to ``num_samples``.
    Returns ``(label remapped into the sampled classes, the sampled
    classes)``. Where there are more positive classes than
    ``num_samples`` the lowest ``num_samples`` are kept and the others'
    labels become -1, as in the reference; that is logged and recorded
    as a ``class_center_sample_truncated`` event."""
    _one_rank(group, "class_center_sample")
    lab = label.detach().cpu().numpy().reshape(-1)
    pos = np.unique(lab)
    if len(pos) >= num_samples:
        sampled = pos[:num_samples]
        if len(pos) > num_samples:
            why = (f"{len(pos)} positive classes exceed num_samples="
                   f"{num_samples}; the labels of {len(pos) - num_samples} "
                   "classes become -1")
            _log.warning("class_center_sample: %s", why)
            _explain.record("class_center_sample_truncated",
                            op="class_center_sample", why=why)
    else:
        rng = np.random.default_rng(abs(hash(tuple(lab.tolist()))) % 2**32)
        neg_pool = np.setdiff1d(np.arange(num_classes), pos)
        extra = rng.choice(neg_pool, num_samples - len(pos), replace=False)
        sampled = np.concatenate([pos, extra])
    remap = -np.ones(num_classes, np.int64)
    remap[sampled] = np.arange(len(sampled))
    dev = label.device
    return (torch.from_numpy(remap[lab]).to(dev),
            torch.from_numpy(sampled.astype(np.int64)).to(dev))
