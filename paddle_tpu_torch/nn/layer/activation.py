"""Activation layers (counterpart of paddle_tpu/nn/layer/activation.py): each
calls its function of ``nn.functional`` with the arguments it was built
with. ``PReLU``'s slopes are a parameter (one, or one per channel)."""
from __future__ import annotations

from torch import nn

from .. import functional as PF
from ..initializer import Constant
from .layers import ParamLayer

__all__ = ["ReLU", "ReLU6", "GELU", "Sigmoid", "Silu", "Swish", "Softmax",
           "LogSoftmax", "Tanh", "LeakyReLU", "ELU", "SELU", "CELU", "PReLU",
           "Softplus", "Softsign", "Mish", "Hardshrink", "Hardsigmoid",
           "Hardswish", "Hardtanh", "Softshrink", "Tanhshrink",
           "ThresholdedReLU", "LogSigmoid", "Maxout", "GLU"]


def _layer(cls_name, fn, *arg_names, **defaults):
    """A layer class whose ``__init__(*arg_names, name=None)`` (with
    ``defaults``) stores its arguments and whose forward is
    ``fn(x, *those arguments)``."""
    names = list(arg_names)

    def __init__(self, *args, name=None, **kw):
        nn.Module.__init__(self)
        vals = dict(defaults)
        vals.update(zip(names, args))
        vals.update(kw)
        self._args = tuple(vals[k] for k in names)

    def forward(self, x):
        return fn(x, *self._args)

    def extra_repr(self):
        return ", ".join(f"{k}={v}" for k, v in zip(names, self._args))

    return type(cls_name, (nn.Module,), {
        "__init__": __init__, "forward": forward, "extra_repr": extra_repr,
        "__doc__": f"The layer form of ``nn.functional.{fn.__name__}``.",
        "__module__": __name__})


ReLU = _layer("ReLU", PF.relu)
ReLU6 = _layer("ReLU6", PF.relu6)
Sigmoid = _layer("Sigmoid", PF.sigmoid)
Silu = _layer("Silu", PF.silu)
Swish = _layer("Swish", PF.swish)
Tanh = _layer("Tanh", PF.tanh)
Softsign = _layer("Softsign", PF.softsign)
Mish = _layer("Mish", PF.mish)
LogSigmoid = _layer("LogSigmoid", PF.log_sigmoid)
Tanhshrink = _layer("Tanhshrink", PF.tanhshrink)
Hardswish = _layer("Hardswish", PF.hardswish)
Hardsigmoid = _layer("Hardsigmoid", PF.hardsigmoid)
GELU = _layer("GELU", PF.gelu, "approximate", approximate=False)
Softmax = _layer("Softmax", PF.softmax, "axis", axis=-1)
LogSoftmax = _layer("LogSoftmax", PF.log_softmax, "axis", axis=-1)
LeakyReLU = _layer("LeakyReLU", PF.leaky_relu, "negative_slope",
                   negative_slope=0.01)
ELU = _layer("ELU", PF.elu, "alpha", alpha=1.0)
SELU = _layer("SELU", PF.selu, "scale", "alpha", scale=1.0507009873554805,
              alpha=1.6732632423543772)
CELU = _layer("CELU", PF.celu, "alpha", alpha=1.0)
Softplus = _layer("Softplus", PF.softplus, "beta", "threshold", beta=1.0,
                  threshold=20.0)
Hardshrink = _layer("Hardshrink", PF.hardshrink, "threshold", threshold=0.5)
Hardtanh = _layer("Hardtanh", PF.hardtanh, "min", "max", min=-1.0, max=1.0)
Softshrink = _layer("Softshrink", PF.softshrink, "threshold", threshold=0.5)
ThresholdedReLU = _layer("ThresholdedReLU", PF.thresholded_relu,
                         "threshold", threshold=1.0)
Maxout = _layer("Maxout", PF.maxout, "groups", "axis", axis=1)
GLU = _layer("GLU", PF.glu, "axis", axis=-1)


class PReLU(ParamLayer, nn.Module):
    """``x`` where positive, else ``weight * x``; ``weight`` holds
    ``num_parameters`` slopes (1, or one per channel), ``init`` each."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        nn.Module.__init__(self)
        self._data_format = data_format
        self.create_parameter("weight", [num_parameters], weight_attr,
                              default_initializer=Constant(init))

    def forward(self, x):
        return PF.prelu(x, self.weight, self._data_format)
