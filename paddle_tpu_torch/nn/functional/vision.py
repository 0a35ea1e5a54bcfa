"""Sampling grids and the temporal shift (counterpart of ``grid_sample``,
``affine_grid`` and ``temporal_shift`` in paddle_tpu/ops/nn_ops.py).

Where the reference ignores an argument the port follows Paddle (ROADMAP
queue 3): ``grid_sample`` honours ``mode`` ("bilinear" | "nearest") and
``padding_mode`` ("zeros" | "border" | "reflection"); the reference samples
bilinearly with zero padding whatever they say. ``temporal_shift`` reads
``data_format`` ("NCHW" | "NHWC").
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["grid_sample", "affine_grid", "temporal_shift"]

_GRID_MODES = ("bilinear", "nearest")
_PADDING_MODES = ("zeros", "border", "reflection")


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """``x [N, C, H, W]`` sampled at ``grid [N, Ho, Wo, 2]`` (x, y in [-1,
    1]; ``align_corners``: -1 and 1 are the corner pixels' centres, else
    their outer edges); returns ``[N, C, Ho, Wo]``."""
    if mode not in _GRID_MODES:
        raise ValueError(f"grid_sample mode {mode!r} (expected one of "
                         f"{_GRID_MODES})")
    if padding_mode not in _PADDING_MODES:
        raise ValueError(f"grid_sample padding_mode {padding_mode!r} "
                         f"(expected one of {_PADDING_MODES})")
    return F.grid_sample(x, grid.to(x.dtype), mode=mode,
                         padding_mode=padding_mode,
                         align_corners=align_corners)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """The ``[N, H, W, 2]`` grid of ``theta [N, 2, 3]`` applied to the
    normalised coordinates of an ``out_shape`` ``[N, C, H, W]`` output."""
    shape = [int(s) for s in (out_shape.tolist() if torch.is_tensor(out_shape)
                              else out_shape)]
    return F.affine_grid(theta, shape, align_corners=align_corners)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM's shift over ``[N * seg_num, C, H, W]``: the first ``C *
    shift_ratio`` channels take the next segment's values, the next as
    many the previous segment's, zeros at the ends; the rest stay."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"temporal_shift data_format {data_format!r}")
    a = x.movedim(-1, 1) if data_format == "NHWC" else x
    NT, C = a.shape[:2]
    v = a.reshape(NT // seg_num, seg_num, C, *a.shape[2:])
    c1, c2 = int(C * shift_ratio), int(C * 2 * shift_ratio)
    out = torch.zeros_like(v)
    out[:, :-1, :c1] = v[:, 1:, :c1]
    out[:, 1:, c1:c2] = v[:, :-1, c1:c2]
    out[:, :, c2:] = v[:, :, c2:]
    out = out.reshape(a.shape)
    return out.movedim(1, -1) if data_format == "NHWC" else out
