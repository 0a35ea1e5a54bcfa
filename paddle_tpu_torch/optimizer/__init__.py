"""Optimizers of the port (counterpart of paddle_tpu/optimizer): the
Optimizer base, Adam and AdamW, and the GPT pretraining schedulers."""
from . import lr
from .adam import Adam, AdamW
from .optimizer import Optimizer

__all__ = ["Optimizer", "Adam", "AdamW", "lr"]
