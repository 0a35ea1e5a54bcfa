"""Functional ops of the encoder path (counterpart of the parts of
paddle_tpu/nn/functional that BERT and the transformer layers reach:
``ops/activation.py``'s gelu, relu and tanh, ``ops/nn_ops.py``'s dropout
and cross_entropy)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops.counter_rng import hashed_dropout, new_key

__all__ = ["gelu", "relu", "tanh", "dropout", "cross_entropy"]


def gelu(x, approximate=False, name=None):
    """Exact (erf) GELU by default, the tanh form with ``approximate``."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x, name=None):
    return F.relu(x)


def tanh(x, name=None):
    return torch.tanh(x)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, key=None, site=0):
    """The reference's dropout: when training, each element (or each slice
    along the dimensions not in ``axis``, when ``axis`` names some) is
    zeroed with probability ``p``; ``upscale_in_train`` scales the kept
    ones by ``1 / (1 - p)``, ``downscale_in_infer`` keeps them as they are
    and scales by ``1 - p`` in inference.

    The keep-mask is a hash of ``key`` (two 32-bit words,
    ``ops.counter_rng.new_key``; None draws one from torch's default
    generator), the call ``site`` and the element's index
    (:func:`~paddle_tpu_torch.ops.counter_rng.hashed_dropout`), so it is
    the same eagerly, in a CUDA graph's replay and in a recomputation."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode {mode!r} (expected upscale_in_train "
                         "| downscale_in_infer)")
    if p >= 1.0:
        return x * 0.0
    if key is None:
        key = new_key(x.device)
    if axis is None and mode == "upscale_in_train":
        return hashed_dropout(x, p, key, site)
    axes = (None if axis is None else
            tuple(axis) if isinstance(axis, (list, tuple)) else (axis,))
    shape = x.shape if axes is None else tuple(
        s if i in axes else 1 for i, s in enumerate(x.shape))
    keep = hashed_dropout(torch.ones(shape, device=x.device), p, key,
                          site) > 0
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, zero)


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


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"reduction {reduction!r} (expected mean | sum | none)")
