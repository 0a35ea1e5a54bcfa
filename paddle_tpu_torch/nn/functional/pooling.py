"""Pooling (counterpart of the pool ops of paddle_tpu/ops/nn_ops.py: the
reference's ``reduce_window`` becomes ``F.max_pool*d`` / ``F.avg_pool*d``
and the adaptive pools ``F.adaptive_*``), the max pools with their indices
and the max unpools.

Padding takes the convolutions' forms (``conv.resolve_pairs``): an int,
one per spatial dimension, ``(lo, hi)`` pairs, or ``"SAME"`` / ``"VALID"``
(XLA's rule, as in the reference). torch pads
symmetrically and by at most half the window, so any other padding is
applied by ``F.pad`` first (with ``-inf`` for a max pool; an exclusive
average then divides by the count of real elements in each window).

Where the reference departs from Paddle the port follows Paddle (ROADMAP
queue 3): ``ceil_mode`` is honoured (the reference drops it), the
adaptive pools read ``data_format`` (the reference assumes channels
first) and ``adaptive_max_pool2d(return_mask=True)`` returns the mask. The
masks are flat indices into each input plane, int64.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .conv import (from_channels_first, ntuple, pad_pairs, resolve_pairs,
                   to_channels_first)

__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool2d", "max_pool2d_with_index",
           "max_pool3d_with_index", "max_unpool1d", "max_unpool2d",
           "max_unpool3d"]

_MAX = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _native(pairs, ks):
    """The symmetric padding torch takes, or None."""
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pairs, ks)):
        return tuple(lo for lo, _ in pairs)
    return None


def _max_pool(n, x, kernel_size, stride, padding, return_mask, ceil_mode,
              data_format):
    ks = ntuple(kernel_size, n)
    st = ntuple(stride if stride is not None else kernel_size, n)
    x = to_channels_first(x, data_format)
    pairs = resolve_pairs(n, x, padding, ks, st, (1,) * n, data_format)
    pad = _native(pairs, ks)
    if pad is None:
        if return_mask:
            raise ValueError("max pool with return_mask takes a symmetric "
                             "numeric padding of at most half the window")
        x, pad = pad_pairs(x, pairs, value=float("-inf")), 0
    out = _MAX[n](x, ks, st, pad, ceil_mode=ceil_mode,
                  return_indices=return_mask)
    if return_mask:
        return (from_channels_first(out[0], data_format),
                from_channels_first(out[1], data_format))
    return from_channels_first(out, data_format)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _max_pool(1, x, kernel_size, stride, padding, return_mask,
                     ceil_mode, data_format)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _max_pool(2, x, kernel_size, stride, padding, return_mask,
                     ceil_mode, data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max_pool(3, x, kernel_size, stride, padding, return_mask,
                     ceil_mode, data_format)


def _avg_pool(n, x, kernel_size, stride, padding, ceil_mode, exclusive,
              divisor_override, data_format):
    """The mean of each window; ``exclusive`` leaves the padding out of the
    count, ``divisor_override`` replaces the count."""
    ks = ntuple(kernel_size, n)
    st = ntuple(stride if stride is not None else kernel_size, n)
    x = to_channels_first(x, data_format)
    pairs = resolve_pairs(n, x, padding, ks, st, (1,) * n, data_format)
    pad = _native(pairs, ks)
    kw = {} if n == 1 else {"divisor_override": divisor_override}
    if pad is not None:
        out = _AVG[n](x, ks, st, pad, ceil_mode, not exclusive, **kw)
        return from_channels_first(out, data_format)
    # padded here: a window's sum, divided by its size or its real count
    xp = pad_pairs(x, pairs)
    size = math.prod(ks)
    total = _AVG[n](xp, ks, st, 0, ceil_mode, True) * size
    if divisor_override:
        out = total / divisor_override
    elif exclusive:
        ones = pad_pairs(torch.ones_like(x[:1, :1]), pairs)
        out = total / (_AVG[n](ones, ks, st, 0, ceil_mode, True) * size)
    else:
        out = total / size
    return from_channels_first(out, data_format)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _avg_pool(1, x, kernel_size, stride, padding, ceil_mode,
                     exclusive, None, data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _avg_pool(2, x, kernel_size, stride, padding, ceil_mode,
                     exclusive, divisor_override, data_format)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _avg_pool(3, x, kernel_size, stride, padding, ceil_mode,
                     exclusive, divisor_override, data_format)


_ADAPTIVE = {("avg", 1): F.adaptive_avg_pool1d,
             ("avg", 2): F.adaptive_avg_pool2d,
             ("avg", 3): F.adaptive_avg_pool3d,
             ("max", 2): F.adaptive_max_pool2d}


def _adaptive(n, kind, x, output_size, data_format, return_mask=False):
    """Output cell ``i`` of a dimension of ``L`` cells over ``N`` inputs
    pools inputs ``[floor(i N / L), ceil((i + 1) N / L))``, as the
    reference's windows; None in ``output_size`` keeps that dimension."""
    x = to_channels_first(x, data_format)
    size = ntuple(output_size, n) if not isinstance(output_size, (
        list, tuple)) else tuple(
        x.shape[2 + i] if s is None else int(s)
        for i, s in enumerate(output_size))
    fn = _ADAPTIVE[kind, n]
    if kind == "max":
        out = fn(x, size, return_indices=return_mask)
        if return_mask:
            return (from_channels_first(out[0], data_format),
                    from_channels_first(out[1], data_format))
        return from_channels_first(out, data_format)
    return from_channels_first(fn(x, size), data_format)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(1, "avg", x, output_size, "NCL")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(2, "avg", x, output_size, data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(3, "avg", x, output_size, data_format)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(2, "max", x, output_size, "NCHW", return_mask)


def _max_pool_index(n, x, kernel_size, stride, padding):
    """``(pooled, flat indices)`` of an ``NC{spatial}`` input padded by
    ``padding`` on every side (with -inf): each index is the maximum's flat
    position in its unpadded input plane (clipped into it), int32, as the
    reference computes it."""
    ks = ntuple(kernel_size, n)
    st = ntuple(stride if stride is not None else kernel_size, n)
    p = ntuple(padding, n)
    xp = F.pad(x, [q for pi in reversed(p) for q in (pi, pi)],
               value=float("-inf"))
    out, idx = _MAX[n](xp, ks, st, 0, return_indices=True)
    coords, rem = [], idx
    for d in reversed(range(n)):
        coords.append(rem % xp.shape[2 + d])
        rem = rem // xp.shape[2 + d]
    flat = torch.zeros_like(idx)
    for d, c in enumerate(reversed(coords)):
        size = x.shape[2 + d]
        flat = flat * size + (c - p[d]).clamp(0, size - 1)
    return out, flat.to(torch.int32)


def max_pool2d_with_index(x, kernel_size, stride=None, padding=0,
                          name=None):
    return _max_pool_index(2, x, kernel_size, stride, padding)


def max_pool3d_with_index(x, kernel_size, stride=None, padding=0,
                          name=None):
    return _max_pool_index(3, x, kernel_size, stride, padding)


def _max_unpool(n, x, indices, kernel_size, stride, padding, data_format,
                output_size):
    """Each value of ``x`` written at its flat index of a zero output plane
    of ``output_size`` (default ``(in - 1) * stride - 2 * padding +
    kernel``); an index outside the plane is dropped. Channels first only,
    as in Paddle."""
    if data_format != ("NCL", "NCHW", "NCDHW")[n - 1]:
        raise ValueError(f"max_unpool{n}d takes data_format "
                         f"{('NCL', 'NCHW', 'NCDHW')[n - 1]!r} only, got "
                         f"{data_format!r}")
    ks = ntuple(kernel_size, n)
    st = ntuple(stride if stride is not None else kernel_size, n)
    p = ntuple(padding, n)
    if output_size is None:
        out_sp = tuple((x.shape[2 + d] - 1) * st[d] - 2 * p[d] + ks[d]
                       for d in range(n))
    else:
        out_sp = tuple(int(s) for s in output_size[-n:])
    N, C = x.shape[:2]
    size = math.prod(out_sp)
    # an index outside the plane writes to a spare last slot, dropped: the
    # reference's scatter drops it
    idx = indices.reshape(N, C, -1).long()
    idx = torch.where((idx >= 0) & (idx < size), idx, size)
    out = x.new_zeros(N, C, size + 1).scatter(2, idx, x.reshape(N, C, -1))
    return out[..., :size].reshape(N, C, *out_sp)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _max_unpool(1, x, indices, kernel_size, stride, padding,
                       data_format, output_size)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _max_unpool(2, x, indices, kernel_size, stride, padding,
                       data_format, output_size)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _max_unpool(3, x, indices, kernel_size, stride, padding,
                       data_format, output_size)
