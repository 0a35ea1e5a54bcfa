"""Normalisations (counterpart of the norm ops of paddle_tpu/ops/nn_ops.py).

Statistics of a bf16 or float16 input are computed in float32 (the
reference's ``_stats_cast``): the backward of ``rsqrt(var + eps)`` overflows
float16. ``batch_norm`` calls ``F.batch_norm``, ``instance_norm``
``F.instance_norm``, ``group_norm`` ``F.group_norm``, so ``auto_cast``'s
black list keeps them in float32 as the reference's plan does.

``batch_norm``: Paddle's ``momentum`` weighs the running statistic,
``running = momentum * running + (1 - momentum) * batch``, which is
torch's ``1 - momentum``. The running variance takes the unbiased batch
variance; the output is normalised by the biased one. The running
statistics are updated in place, so a CUDA graph that captures the step
updates them at every replay.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...framework import static_leaf
from .conv import channels_last

__all__ = ["batch_norm", "layer_norm", "instance_norm", "group_norm",
           "rms_norm", "local_response_norm", "normalize"]

_LOW = (torch.float16, torch.bfloat16)


def _stats_cast(x):
    return x.float() if x.dtype in _LOW else x


def _out_dtype(x, weight):
    return x.dtype if weight is None else torch.promote_types(x.dtype,
                                                              weight.dtype)


def _channels_first(x, data_format):
    return x.movedim(-1, 1) if channels_last(data_format) and x.dim() > 2 \
        else x


def _channels_back(x, data_format):
    return x.movedim(1, -1) if channels_last(data_format) and x.dim() > 2 \
        else x


@static_leaf(None)
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch statistics when ``training`` (unless ``use_global_stats``),
    the running ones otherwise; the running ones are updated in place when
    batch statistics are used."""
    use_batch = training and not use_global_stats
    xf = _channels_first(_stats_cast(x), data_format)
    w = None if weight is None else _stats_cast(weight)
    b = None if bias is None else _stats_cast(bias)
    if use_batch and xf.numel() == xf.shape[1]:
        out = _batch_norm_single(xf, running_mean, running_var, w, b,
                                 momentum, epsilon)
    else:
        out = F.batch_norm(xf, running_mean, running_var, w, b, use_batch,
                           1.0 - momentum, epsilon)
    return _channels_back(out, data_format).to(_out_dtype(x, weight))


def _batch_norm_single(xf, running_mean, running_var, w, b, momentum,
                       epsilon):
    """Batch statistics of one value per channel (torch refuses them):
    each value its own mean, the variance 0, as the reference computes; the
    unbiased variance of one value is taken as 0 too."""
    shape = [1, -1] + [1] * (xf.dim() - 2)
    out = (xf - xf) * torch.rsqrt(xf.new_full((), epsilon))
    if w is not None:
        out = out * w.view(shape) + b.view(shape)
    with torch.no_grad():
        running_mean.mul_(momentum).add_(
            (1 - momentum) * xf.reshape(-1).to(running_mean.dtype))
        running_var.mul_(momentum)
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    out = F.layer_norm(_stats_cast(x), tuple(normalized_shape),
                       None if weight is None else _stats_cast(weight),
                       None if bias is None else _stats_cast(bias), epsilon)
    return out.to(_out_dtype(x, weight))


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """``x / sqrt(mean(x^2) + eps)`` over the last dimension, in float32,
    then scaled by ``weight``."""
    xf = x.float()
    out = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + epsilon)
           ).to(x.dtype)
    return out * weight if weight is not None else out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Each sample's channels normalised over their own spatial
    positions."""
    xf = _channels_first(_stats_cast(x), data_format)
    out = F.instance_norm(
        xf, running_mean, running_var,
        None if weight is None else _stats_cast(weight),
        None if bias is None else _stats_cast(bias),
        use_input_stats, 1.0 - momentum, eps)
    return _channels_back(out, data_format).to(_out_dtype(x, weight))


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    xf = _channels_first(_stats_cast(x), data_format)
    out = F.group_norm(xf, num_groups,
                       None if weight is None else _stats_cast(weight),
                       None if bias is None else _stats_cast(bias), epsilon)
    return _channels_back(out, data_format).to(_out_dtype(x, weight))


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * s / size)^beta``, ``s`` the sum of squares over
    ``size`` neighbouring channels."""
    out = F.local_response_norm(_channels_first(x, data_format), size, alpha,
                                beta, k)
    return _channels_back(out, data_format)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(||x||_p, epsilon)`` along ``axis``."""
    return F.normalize(x, p, axis, epsilon)
