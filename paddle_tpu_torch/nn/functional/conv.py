"""Convolutions (counterpart of the conv ops of paddle_tpu/ops/nn_ops.py).

The reference lowers every convolution to XLA's ``conv_general_dilated``;
the port calls ``F.conv1d/2d/3d`` and ``F.conv_transpose1d/2d/3d`` (cuDNN on
the card; TF32 stays off, ``paddle_tpu_torch/__init__.py``), so
``auto_cast`` sees the calls its white list names. The weight layouts are
the reference's and torch's alike: ``[out, in / groups, *kernel]``, and
``[in, out / groups, *kernel]`` for a transposed convolution.

Padding takes every form of the reference's ``normalize_conv_padding``: an
int, one int per spatial dimension, ``[lo0, hi0, lo1, hi1, ...]``, one
``(lo, hi)`` pair per spatial dimension, the pairs of every dimension (batch
and channel pairs zero), and ``"SAME"`` / ``"VALID"`` at any stride. torch
takes one symmetric padding per dimension, so an asymmetric padding (which
``"SAME"`` gives where the total is odd) is applied by ``F.pad`` first. A
channels-last ``data_format`` (``NLC``, ``NHWC``, ``NDHWC``) is the
caller's layout: the input is viewed channels-first and the output given
back channels-last.
"""
from __future__ import annotations

import torch.nn.functional as F

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose",
           "normalize_conv_padding", "ntuple", "channels_last"]

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def ntuple(v, n):
    """``v`` as a tuple of ``n`` ints (an int repeated)."""
    if isinstance(v, int) or (hasattr(v, "__index__")
                              and not isinstance(v, (list, tuple))):
        return (int(v),) * n
    return tuple(int(i) for i in v)


def channels_last(data_format):
    return data_format in ("NHWC", "NLC", "NDHWC")


def normalize_conv_padding(n, padding, channels_last_=False):
    """The reference's padding forms as ``"SAME"`` / ``"VALID"`` or ``n``
    ``(lo, hi)`` pairs (a copy of ``paddle_tpu/ops/nn_ops.py:67-97``)."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if padding and isinstance(padding[0], (list, tuple)):
        pairs = [tuple(int(q) for q in p) for p in padding]
        if len(pairs) == n:
            return pairs
        if len(pairs) == n + 2:
            other = [pairs[0], pairs[-1]] if channels_last_ else pairs[:2]
            spatial = pairs[1:1 + n] if channels_last_ else pairs[2:]
            if any(p != (0, 0) for p in other):
                raise ValueError(
                    "conv padding on batch/channel dims must be (0, 0); "
                    f"got {padding!r}")
            return spatial
        raise ValueError(f"conv padding pairs form needs {n} or {n + 2} "
                         f"pairs; got {padding!r}")
    if len(padding) == n:
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    raise ValueError(f"unsupported conv padding form {padding!r}")


def same_pairs(sizes, kernel, stride, dilation):
    """XLA's ``"SAME"``: the output is ``ceil(in / stride)`` long, the total
    padding split with the odd element after."""
    pairs = []
    for size, k, s, d in zip(sizes, kernel, stride, dilation):
        out = -(-size // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
        pairs.append((total // 2, total - total // 2))
    return pairs


def to_channels_first(x, data_format):
    return x.movedim(-1, 1) if channels_last(data_format) else x


def from_channels_first(x, data_format):
    return x.movedim(1, -1) if channels_last(data_format) else x


def pad_pairs(x, pairs, mode="constant", value=0.0):
    """``x`` (channels-first) padded by one ``(lo, hi)`` pair per trailing
    spatial dimension."""
    flat = [q for lo_hi in reversed(pairs) for q in lo_hi]
    if mode == "constant":
        return F.pad(x, flat, value=value)
    return F.pad(x, flat, mode=mode)


def resolve_pairs(n, x, padding, kernel, stride, dilation, data_format):
    """One ``(lo, hi)`` pair per spatial dimension of channels-first ``x``
    for any padding form."""
    pad = normalize_conv_padding(n, padding, channels_last(data_format))
    if pad == "VALID":
        return [(0, 0)] * n
    if pad == "SAME":
        return same_pairs(x.shape[2:], kernel, stride, dilation)
    if isinstance(pad, str):
        raise ValueError(f"unknown padding {padding!r}")
    return pad


def _conv_nd(n, x, weight, bias, stride, padding, dilation, groups,
             data_format, padding_mode="zeros"):
    stride, dilation = ntuple(stride, n), ntuple(dilation, n)
    x = to_channels_first(x, data_format)
    pairs = resolve_pairs(n, x, padding, weight.shape[2:], stride, dilation,
                          data_format)
    if padding_mode != "zeros":
        x = pad_pairs(x, pairs, mode=padding_mode)
        pad = 0
    elif all(lo == hi for lo, hi in pairs):
        pad = tuple(lo for lo, _ in pairs)
    else:
        x = pad_pairs(x, pairs)
        pad = 0
    out = _CONV[n](x, weight, bias, stride, pad, dilation, groups)
    return from_channels_first(out, data_format)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv_nd(1, x, weight, bias, stride, padding, dilation, groups,
                    data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv_nd(2, x, weight, bias, stride, padding, dilation, groups,
                    data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd(3, x, weight, bias, stride, padding, dilation, groups,
                    data_format)


def _conv_transpose_nd(n, x, weight, bias, stride, padding, output_padding,
                       dilation, groups, data_format, output_size):
    """The reference's transposed convolution: ``padding`` an int or one
    int per spatial dimension, trimmed from both ends of the full output;
    ``output_padding`` extra rows at the high end. ``output_size`` (which
    the reference drops) sets ``output_padding`` to what reaches it, as
    Paddle does."""
    stride, dilation = ntuple(stride, n), ntuple(dilation, n)
    padding = ntuple(padding, n)
    out_pad = ntuple(output_padding, n)
    x = to_channels_first(x, data_format)
    if output_size is not None:
        want = ntuple(output_size, n)[-n:]
        out_pad = tuple(
            w - ((i - 1) * s - 2 * p + d * (k - 1) + 1)
            for w, i, s, p, d, k in zip(want, x.shape[2:], stride, padding,
                                        dilation, weight.shape[2:]))
    out = _CONV_T[n](x, weight, bias, stride, padding, out_pad, groups,
                     dilation)
    return from_channels_first(out, data_format)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCL", output_size=None, name=None):
    return _conv_transpose_nd(1, x, weight, bias, stride, padding,
                              output_padding, dilation, groups, data_format,
                              output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCHW", output_size=None, name=None):
    return _conv_transpose_nd(2, x, weight, bias, stride, padding,
                              output_padding, dilation, groups, data_format,
                              output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCDHW", output_size=None, name=None):
    return _conv_transpose_nd(3, x, weight, bias, stride, padding,
                              output_padding, dilation, groups, data_format,
                              output_size)
