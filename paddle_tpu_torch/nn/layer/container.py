"""Containers (counterpart of paddle_tpu/nn/layer/container.py's
LayerList): torch's ModuleList already has the reference's interface
(indexing, slicing, ``append`` returning the list, ``insert``, ``extend``,
iteration and length), so the port's LayerList is it."""
from __future__ import annotations

from torch import nn

__all__ = ["LayerList"]

LayerList = nn.ModuleList
