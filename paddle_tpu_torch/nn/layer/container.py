"""Containers (counterpart of paddle_tpu/nn/layer/container.py).

torch's ``ModuleList``, ``ModuleDict`` and ``ParameterList`` already have
the reference's interfaces (indexing, ``append`` returning the container,
``insert``, ``extend``, ``keys`` / ``items`` / ``values`` / ``pop`` /
``update``), so ``LayerList``, ``LayerDict`` and ``ParameterList`` are
them. ``Sequential`` adds the reference's constructor forms to torch's.
"""
from __future__ import annotations

from collections import OrderedDict

from torch import nn

__all__ = ["Sequential", "LayerList", "LayerDict", "ParameterList"]

LayerList = nn.ModuleList
LayerDict = nn.ModuleDict
ParameterList = nn.ParameterList


class Sequential(nn.Sequential):
    """``Sequential(l0, l1, ...)`` names its children ``"0"``, ``"1"``, ...;
    ``Sequential(OrderedDict(...))`` and ``Sequential((name, layer), ...)``
    name them. A slice is a new ``Sequential`` of those layers, named from
    ``"0"`` again, as the reference's is."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            super().__init__(layers[0])
            return
        super().__init__()
        for i, layer in enumerate(layers):
            if isinstance(layer, (list, tuple)) and len(layer) == 2:
                self.add_module(str(layer[0]), layer[1])
            else:
                self.add_module(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return super().__getitem__(idx)
