"""How the vision models place and initialise themselves.

A model builds its layers on the meta device (``with torch.device("meta")``
in its ``__init__``), then :func:`adopt` moves them to ``device`` (None:
the current CUDA device, an error without one; ``"cpu"`` for the CPU) and
initialises every parameter and running statistic once, in module order,
from ``generator`` (None: torch's default generator of that device), as
the BERT model does. A model with dropout draws one key per training
forward from the same generator, which every Dropout hashes with its own
site (``nn.layer.common.DropoutKeys``); ``TrainStep`` registers the
generator with its graph, so each replay draws a new key.
"""
from __future__ import annotations

from ...device import resolve_device
from ...nn.layer.common import DropoutKeys
from ...nn.layer.layers import init_parameters

__all__ = ["adopt", "resolve_device"]


def _draw(module, args):
    if module.training:
        module.dropout_keys.draw(next(module.parameters()).device)


def adopt(model, device, generator):
    """``model`` (built on the meta device) on ``device``, initialised from
    ``generator``; returns it."""
    dev = resolve_device(device)
    model.to_empty(device=dev)
    init_parameters(model, generator)
    model.generator = generator
    keys = DropoutKeys(generator)
    keys.attach(model)
    if keys.layers:
        model.dropout_keys = keys
        model.register_forward_pre_hook(_draw)
    return model
