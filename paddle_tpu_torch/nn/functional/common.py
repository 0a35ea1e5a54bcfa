"""``linear``, ``embedding``, ``sequence_mask``, dropouts, resizing,
shuffles, patches, padding and one_hot (counterpart of
paddle_tpu/ops/nn_ops.py's linear, embedding, sequence_mask, dropout,
resize and shuffle ops and ops/manipulation.py's ``pad``).

Every dropout here draws its keep-mask from the port's counter-based hash
(``ops.counter_rng.hashed_dropout``): the same eagerly, in a CUDA graph's
replay and in a recomputation.

Where the reference departs from Paddle the port follows Paddle (ROADMAP
queue 3): ``interpolate`` resizes by Paddle's rule (no antialiasing when it
shrinks, ``align_corners`` honoured, ``"area"`` the adaptive mean), and
``pad``'s short form pads the last dimension by its first pair.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops.counter_rng import hashed_dropout, new_key
from .conv import channels_last, ntuple

__all__ = ["linear", "embedding", "sequence_mask", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "interpolate", "upsample", "pixel_shuffle", "pixel_unshuffle",
           "channel_shuffle", "unfold", "fold", "one_hot", "pad"]


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with ``weight`` in the reference's ``[in,
    out]`` layout (``nn.Linear`` holds its weight ``[out, in]`` and passes
    ``.t()``)."""
    return F.linear(x, weight.t(), bias)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows ``weight[x]``; every lookup of ``padding_idx`` gives zeros (so
    that row takes no gradient) whatever the row holds. ``sparse``: the
    weight's gradient is a sparse tensor of the looked-up rows, as the
    reference's SelectedRows gradient is in an eager step."""
    out = F.embedding(x, weight, sparse=sparse)
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx).unsqueeze(-1), 0.0)
    return out


def sequence_mask(lengths, maxlen=None, dtype="int64", name=None):
    """``mask[..., j] = j < lengths[...]`` over ``maxlen`` columns. With
    ``maxlen`` None it is ``max(lengths)``, read on the host as the
    reference reads it."""
    if maxlen is None:
        maxlen = int(lengths.max())
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    cols = torch.arange(int(maxlen), device=lengths.device)
    return (cols < lengths.unsqueeze(-1)).to(dt)


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
    keep = _keep_mask(x, p, key, site, axes)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, zero)


def _keep_mask(x, p, key, site, axes=None):
    shape = x.shape if axes is None else tuple(
        s if i in axes else 1 for i, s in enumerate(x.shape))
    return hashed_dropout(torch.ones(shape, device=x.device), p, key,
                          site) > 0


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None,
              key=None, site=0):
    """Whole channels dropped: one mask entry per (sample, channel)."""
    axis = (0, 1) if data_format == "NCHW" else (0, 3)
    return dropout(x, p, axis=axis, training=training, key=key, site=site)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None,
              key=None, site=0):
    axis = (0, 1) if data_format == "NCDHW" else (0, 4)
    return dropout(x, p, axis=axis, training=training, key=key, site=site)


def alpha_dropout(x, p=0.5, training=True, name=None, key=None, site=0):
    """SELU's dropout: dropped elements take SELU's negative saturation,
    then an affine map keeps the mean and variance."""
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    if key is None:
        key = new_key(x.device)
    keep = _keep_mask(x, p, key, site)
    q = 1.0 - p
    a = (q + alpha_p ** 2 * q * p) ** -0.5
    b = -a * alpha_p * p
    fill = torch.full((), alpha_p, dtype=x.dtype, device=x.device)
    return a * torch.where(keep, x, fill) + b


_MODES = {"nearest": "nearest", "linear": "linear", "bilinear": "bilinear",
          "trilinear": "trilinear", "bicubic": "bicubic", "area": "area"}


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial dimensions to ``size``, or to ``int(in *
    scale_factor)``. ``nearest`` takes input ``floor(o * in / out)`` (the
    reference's rule); the linear modes sample at half-pixel centres, or
    corner to corner with ``align_corners``."""
    if mode not in _MODES:
        raise ValueError(f"interpolate mode {mode!r}")
    if align_mode != 0 and mode in ("linear", "bilinear", "trilinear") \
            and not align_corners:
        raise NotImplementedError("interpolate align_mode=1")
    last = channels_last(data_format)
    a = x.movedim(-1, 1) if last else x
    spatial = a.shape[2:]
    n = len(spatial)
    if size is not None:
        out = ntuple(size, n)
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * n
        out = tuple(int(s * f) for s, f in zip(spatial, sf))
    kw = {"align_corners": align_corners} if mode in (
        "linear", "bilinear", "trilinear", "bicubic") else {}
    y = F.interpolate(a, size=out, mode=_MODES[mode], **kw)
    return y.movedim(1, -1) if last else y


upsample = interpolate


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    if channels_last(data_format):
        return F.pixel_shuffle(x.movedim(-1, 1), upscale_factor).movedim(1,
                                                                         -1)
    return F.pixel_shuffle(x, upscale_factor)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    if channels_last(data_format):
        return F.pixel_unshuffle(x.movedim(-1, 1),
                                 downscale_factor).movedim(1, -1)
    return F.pixel_unshuffle(x, downscale_factor)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    """Channels ``[g0c0, g0c1, ..., g1c0, ...]`` reordered to ``[g0c0,
    g1c0, ..., g0c1, ...]``."""
    last = channels_last(data_format)
    a = x.movedim(-1, 1) if last else x
    N, C = a.shape[:2]
    y = a.reshape(N, groups, C // groups, *a.shape[2:]).transpose(1, 2) \
        .reshape(a.shape)
    return y.movedim(1, -1) if last else y


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """Sliding ``[N, C * kh * kw, L]`` patches of an NCHW input."""
    return F.unfold(x, ntuple(kernel_sizes, 2), ntuple(dilations, 2),
                    ntuple(paddings, 2), ntuple(strides, 2))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """The sum of ``[N, C * kh * kw, L]`` patches back into NCHW."""
    return F.fold(x, ntuple(output_sizes, 2), ntuple(kernel_sizes, 2),
                  ntuple(dilations, 2), ntuple(paddings, 2),
                  ntuple(strides, 2))


def one_hot(x, num_classes, name=None):
    """float32 one-hot rows (the default dtype)."""
    return F.one_hot(x.long(), num_classes).to(torch.get_default_dtype())


_PAD_MODES = {"constant": "constant", "reflect": "reflect",
              "replicate": "replicate", "circular": "circular"}


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Paddle's ``pad``: ``2 * x.dim()`` entries pad every dimension, first
    to last, as ``(lo, hi)`` pairs; a shorter list pads the spatial
    dimensions (the trailing ones, or those between N and C for a
    channels-last ``data_format``), the first pair the last of them, as
    ``[left, right, top, bottom, front, back]``."""
    p = [int(v) for v in (pad.tolist() if torch.is_tensor(pad) else pad)]
    nd = x.dim()
    if len(p) == 2 * nd:
        pairs = [(p[2 * i], p[2 * i + 1]) for i in range(nd)]
        flat = [q for lo_hi in reversed(pairs) for q in lo_hi]
        return _pad(x, flat, mode, value)
    last = channels_last(data_format) and nd >= 3
    a = x.movedim(-1, 1) if last else x
    y = _pad(a, p, mode, value)
    return y.movedim(1, -1) if last else y


def _pad(x, flat, mode, value):
    if mode == "constant":
        return F.pad(x, flat, value=value)
    return F.pad(x, flat, mode=_PAD_MODES[mode])
