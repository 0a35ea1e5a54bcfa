"""Optimizers of the port (counterpart of paddle_tpu/optimizer): the
Optimizer base, SGD, Momentum, Lars, the Adam family, the regularizers and
the fifteen learning-rate schedulers."""
from . import lr
from .adam import Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb, RMSProp
from .optimizer import SGD, Lars, Momentum, Optimizer
from .regularizer import L1Decay, L2Decay

__all__ = ["Optimizer", "SGD", "Momentum", "Lars", "Adam", "AdamW",
           "Adamax", "Adagrad", "Adadelta", "RMSProp", "Lamb", "L1Decay",
           "L2Decay", "lr"]
