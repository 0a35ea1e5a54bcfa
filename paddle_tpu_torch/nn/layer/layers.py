"""How the port's Paddle-signature layers make their parameters
(counterpart of ``Layer.create_parameter`` in paddle_tpu/nn/layer/layers.py).

:class:`ParamLayer` is a mixin of torch modules: ``create_parameter``
registers a parameter under a name, remembers its ``ParamAttr`` and
initializer, and runs the initializer; ``reset_parameters(generator)`` runs
them all again, drawing from ``generator``. A model builds its layers on
the meta device, moves them with ``to_empty`` and calls
:func:`init_parameters` once with its own generator, so nothing is drawn
twice and torch's default generator is left alone.

The attributes the port's optimizers read from a parameter
(``optimize_attr``, ``regularizer``, ``need_clip``, ``requires_grad``) are
set from the ``ParamAttr`` at each (re)initialisation: ``to_empty`` makes
new parameter objects, so they are set again after it.
"""
from __future__ import annotations

import torch
from torch import nn

from ..initializer import Constant, ParamAttr, XavierUniform

__all__ = ["ParamLayer", "init_parameters"]


class ParamLayer:
    """Mixin giving a ``torch.nn.Module`` the reference's parameter
    creation. Its ``reset_parameters(generator=None)`` replaces the torch
    module's own."""

    def create_parameter(self, name, shape, attr=None, dtype=None,
                         is_bias=False, default_initializer=None,
                         transposed=False):
        """Register parameter ``name`` of ``shape`` (torch's layout) on
        torch's current default device and initialise it; or register None
        when ``attr`` is False. The initializer is ``attr``'s, else
        ``default_initializer``, else zeros for a bias and XavierUniform
        for a weight. ``transposed``: the initializer is handed ``.t()``, a
        2-D weight in the reference's ``[in, out]`` layout."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            self.register_parameter(name, None)
            return None
        init = attr.initializer or default_initializer or (
            Constant(0.0) if is_bias else XavierUniform())
        p = nn.Parameter(torch.empty(
            tuple(int(s) for s in shape),
            dtype=dtype or torch.get_default_dtype()))
        self.register_parameter(name, p)
        self.__dict__.setdefault("_param_specs", {})[name] = (
            attr, init, transposed)
        self._init_parameter(name, None)
        return p

    def _init_parameter(self, name, generator):
        attr, init, transposed = self._param_specs[name]
        p = getattr(self, name)
        if not p.is_meta:
            init(p.t() if transposed else p, generator)
        p.requires_grad_(attr.trainable)
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip

    def reset_parameters(self, generator=None):
        """Run every parameter's initializer again, drawing from
        ``generator`` (None: torch's default generator of its device)."""
        for name in getattr(self, "_param_specs", {}):
            self._init_parameter(name, generator)


def init_parameters(module, generator=None):
    """``reset_parameters(generator)`` of every :class:`ParamLayer` in
    ``module``, in module order: each parameter gets its own draw."""
    for mod in module.modules():
        if isinstance(mod, ParamLayer):
            mod.reset_parameters(generator)
    return module
