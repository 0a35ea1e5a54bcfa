"""Activation functions (counterpart of paddle_tpu/ops/activation.py): the
reference's names, signatures and defaults on torch tensors. Where torch has
the same function it is called, so ``auto_cast`` sees the torch call the
reference's op name maps to (``softmax``, ``log_softmax``); the rest are
written out as the reference writes them."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "relu", "relu_", "relu6", "gelu", "sigmoid", "silu", "swish", "softmax",
    "softmax_", "log_softmax", "tanh", "tanh_", "leaky_relu", "elu", "selu",
    "celu", "prelu", "softplus", "softsign", "mish", "hardshrink",
    "hardsigmoid", "hardswish", "hardtanh", "softshrink", "tanhshrink",
    "thresholded_relu", "log_sigmoid", "maxout", "glu", "rrelu", "swiglu",
]


def relu(x, name=None):
    return F.relu(x)


def relu_(x, name=None):
    return F.relu_(x)


def relu6(x, name=None):
    return F.relu6(x)


def gelu(x, approximate=False, name=None):
    """Exact (erf) GELU by default, the tanh form with ``approximate``."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def silu(x, name=None):
    return F.silu(x)


swish = silu


def _cast(x, dtype):
    if dtype is None:
        return x
    return x.to(getattr(torch, dtype) if isinstance(dtype, str) else dtype)


def softmax(x, axis=-1, dtype=None, name=None):
    return torch.softmax(_cast(x, dtype), axis)


def softmax_(x, axis=-1, dtype=None, name=None):
    return x.copy_(softmax(x, axis, dtype))


def log_softmax(x, axis=-1, dtype=None, name=None):
    return torch.log_softmax(_cast(x, dtype), axis)


def tanh(x, name=None):
    return torch.tanh(x)


def tanh_(x, name=None):
    return x.tanh_()


def leaky_relu(x, negative_slope=0.01, name=None):
    return F.leaky_relu(x, negative_slope)


def elu(x, alpha=1.0, name=None):
    return F.elu(x, alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    return F.celu(x, alpha)


def prelu(x, weight, data_format="NCHW", name=None):
    """``x`` where positive, else ``weight * x``: one slope, or one per
    channel (dimension 1, or the last one for a channels-last
    ``data_format``)."""
    if weight.numel() == 1:
        w = weight.reshape(())
    else:
        shape = [1] * x.dim()
        shape[1 if data_format == "NCHW" else x.dim() - 1] = weight.numel()
        w = weight.reshape(shape)
    return torch.where(x > 0, x, w * x)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return F.softplus(x, beta, threshold)


def softsign(x, name=None):
    return F.softsign(x)


def mish(x, name=None):
    return F.mish(x)


def hardshrink(x, threshold=0.5, name=None):
    return F.hardshrink(x, threshold)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x, name=None):
    return F.hardswish(x)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return F.hardtanh(x, min, max)


def softshrink(x, threshold=0.5, name=None):
    return F.softshrink(x, threshold)


def tanhshrink(x, name=None):
    return F.tanhshrink(x)


def thresholded_relu(x, threshold=1.0, name=None):
    return torch.where(x > threshold, x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))


def log_sigmoid(x, name=None):
    return F.logsigmoid(x)


def maxout(x, groups, axis=1, name=None):
    """The largest of each run of ``C / groups`` channels along ``axis``."""
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = x.shape[:ax] + (groups, c // groups) + x.shape[ax + 1:]
    return x.reshape(shape).amax(ax + 1)


def glu(x, axis=-1, name=None):
    return F.glu(x, axis)


def swiglu(x, y=None, name=None):
    """``silu(x) * y``; with no ``y``, the two halves of ``x``'s last
    dimension."""
    if y is None:
        x, y = x.chunk(2, -1)
    return F.silu(x) * y


def rrelu(x, lower=0.125, upper=0.333, training=True, name=None):
    """Randomised leaky ReLU: a slope drawn uniformly in ``[lower, upper]``
    per element when training (from torch's default generator of ``x``'s
    device), their mean in inference."""
    if not training:
        return leaky_relu(x, (lower + upper) / 2)
    slope = torch.empty_like(x).uniform_(lower, upper)
    return torch.where(x >= 0, x, x * slope)
