"""Parameter initializers and ``ParamAttr`` (counterpart of
paddle_tpu/nn/initializer).

An initializer fills a tensor in place, ``init(tensor, generator=None)``,
drawing from the ``torch.Generator`` it is given (None: torch's default
generator of the tensor's device), and returns the tensor. The random ones
cannot give the reference's numbers (threefry is not reproduced); they draw
from the same distributions.

Fans follow the reference's layouts (``_fans``): a 2-D weight is read as
the reference's Linear stores it, ``[in, out]``. The port's Linear stores
``[out, in]`` and hands its initializer the ``[in, out]`` view
(``weight.t()``, see ``nn/layer/layers.py``), so fan-in and fan-out are
the reference's for every layer.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Orthogonal", "Dirac", "calculate_gain", "ParamAttr",
]


def _fans(shape):
    """``(fan_in, fan_out)`` of a shape in the reference's layouts: a vector
    is its own fan both ways, a matrix is ``[in, out]``, and a convolution
    kernel ``[out, in, *window]``."""
    shape = tuple(shape)
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def calculate_gain(nonlinearity, param=None):
    """The reference's gains. For ``leaky_relu`` a ``param`` of 0 or None
    means a slope of 0.01, as the reference reads ``param or 0.01``."""
    gains = {"sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
             "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
             "leaky_relu": math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
             "selu": 3.0 / 4.0}
    return gains[nonlinearity]


class Initializer:
    """Base: ``init(tensor, generator=None)`` fills ``tensor`` in place under
    ``torch.no_grad()`` and returns it."""

    def __call__(self, tensor, generator=None):
        with torch.no_grad():
            self._fill(tensor, generator)
        return tensor

    def _fill(self, tensor, generator):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _fill(self, tensor, generator):
        tensor.fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _fill(self, tensor, generator):
        tensor.normal_(self.mean, self.std, generator=generator)


class TruncatedNormal(Initializer):
    """``mean + std * z``, ``z`` a standard normal truncated to ``[a, b]``:
    the bounds are in units of ``std``, as the reference's."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _fill(self, tensor, generator):
        torch.nn.init.trunc_normal_(tensor, 0.0, 1.0, self.a, self.b,
                                    generator=generator)
        tensor.mul_(self.std).add_(self.mean)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _fill(self, tensor, generator):
        tensor.uniform_(self.low, self.high, generator=generator)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fill(self, tensor, generator):
        fi, fo = _fans(tensor.shape)
        limit = self.gain * math.sqrt(
            6.0 / ((self.fan_in or fi) + (self.fan_out or fo)))
        tensor.uniform_(-limit, limit, generator=generator)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fill(self, tensor, generator):
        fi, fo = _fans(tensor.shape)
        std = self.gain * math.sqrt(
            2.0 / ((self.fan_in or fi) + (self.fan_out or fo)))
        tensor.normal_(0.0, std, generator=generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _fill(self, tensor, generator):
        fi = self.fan_in or _fans(tensor.shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        tensor.uniform_(-limit, limit, generator=generator)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _fill(self, tensor, generator):
        fi = self.fan_in or _fans(tensor.shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        tensor.normal_(0.0, gain / math.sqrt(fi), generator=generator)


class Assign(Initializer):
    """Copies ``value`` (an array, a list or a tensor of the tensor's
    shape); raises ``ValueError`` on another shape."""

    def __init__(self, value):
        self.value = value

    def _fill(self, tensor, generator):
        v = self.value
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.array(v, dtype=np.float64))
        if tuple(v.shape) != tuple(tensor.shape):
            raise ValueError(f"Assign shape mismatch {tuple(v.shape)} vs "
                             f"{tuple(tensor.shape)}")
        tensor.copy_(v)


class Orthogonal(Initializer):
    """``gain`` times a matrix with orthonormal columns (rows, when it has
    fewer rows than columns), the trailing dimension taken as the columns
    and the others flattened into rows, as the reference's
    (``jax.nn.initializers.orthogonal``): the QR factor of a normal draw,
    its columns' signs set by R's diagonal."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def _fill(self, tensor, generator):
        cols = tensor.shape[-1]
        rows = tensor.numel() // cols
        wide = rows < cols
        a = torch.empty((cols, rows) if wide else (rows, cols),
                        dtype=torch.float32, device=tensor.device)
        a.normal_(0.0, 1.0, generator=generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r)).unsqueeze(0)
        if wide:
            q = q.t()
        tensor.copy_((self.gain * q).reshape(tensor.shape))


class Dirac(Initializer):
    """A convolution kernel ``[out, in, *window]`` that passes input
    channel ``i`` to output channel ``i`` of each group (a one at the
    window's centre), zeros elsewhere."""

    def __init__(self, groups=1):
        self.groups = groups

    def _fill(self, tensor, generator):
        tensor.zero_()
        oc, ic = tensor.shape[0], tensor.shape[1]
        per = oc // self.groups
        centers = [s // 2 for s in tensor.shape[2:]]
        for g in range(self.groups):
            for i in range(min(per, ic)):
                tensor[(g * per + i, i, *centers)] = 1.0


class ParamAttr:
    """``paddle.ParamAttr``: a parameter's initializer, learning-rate
    multiplier, regularizer, trainability and clipping. The port's
    optimizers read the last four from the parameter
    (``optimize_attr``, ``regularizer``, ``requires_grad``,
    ``need_clip``), which the layers set from this."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """The reference's coercion: None -> default, an Initializer -> its
        attr, a str -> a name, False -> False (no parameter)."""
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, Initializer):
            return ParamAttr(initializer=attr)
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return False
        return ParamAttr()
