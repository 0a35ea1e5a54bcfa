"""Losses and distances (counterpart of the loss ops of
paddle_tpu/ops/nn_ops.py:816-1079). Each is the reference's formula on
torch tensors; where torch has the same function it is called, so
``auto_cast``'s black list (``mse_loss``, ``l1_loss``, ``nll_loss``, ...)
keeps it in float32.

Where the reference departs from Paddle the port follows Paddle (ROADMAP
queue 3): a hard label equal to ``ignore_index`` is dropped whatever its
sign (``cross_entropy``, ``nll_loss``); ``binary_cross_entropy_with_logits``
weighs only the positive term by ``pos_weight``; ``ctc_loss``'s ``"mean"``
divides each sequence's loss by its label length first.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "mse_loss", "l1_loss",
    "nll_loss", "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "smooth_l1_loss", "kl_div", "margin_ranking_loss",
    "hinge_embedding_loss", "cosine_similarity", "cosine_embedding_loss",
    "label_smooth", "log_loss", "square_error_cost", "sigmoid_focal_loss",
    "dice_loss", "ctc_loss", "triplet_margin_loss", "pairwise_distance",
    "npair_loss",
]


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
