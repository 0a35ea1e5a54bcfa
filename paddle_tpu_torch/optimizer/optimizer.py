"""Optimizer base (counterpart of paddle_tpu/optimizer/optimizer.py).

Parameters are updated in place under ``torch.no_grad()``. Per-parameter
state (moments, master weights) lives in accumulators named like the
reference's, and ``state_dict()`` keys them as the reference does for
unnamed parameters: ``"<accumulator>/p<i>"`` by position in the parameter
list, plus ``"_opt_step"`` and, with a scheduler, ``"LR_Scheduler"``.
"""
from __future__ import annotations

import torch

from .lr import LRScheduler

__all__ = ["Optimizer"]


class Optimizer:
    """``parameters``: an iterable of tensors, or of ``(name, tensor)``
    pairs such as ``model.named_parameters()``; the names only reach
    ``apply_decay_param_fun`` (unnamed parameters give it None, as the
    reference's do). ``learning_rate``: a float or an
    :class:`~.lr.LRScheduler`. ``grad_clip``: a callable over
    ``[(param, grad)]`` such as ``nn.ClipGradByGlobalNorm``.

    ``step()`` clips, advances ``_opt_step`` by one, then updates each
    parameter that has a gradient. The reference's regularizers
    (``weight_decay`` on this base) are not ported yet."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        if parameters is None:
            raise ValueError("parameters is required (pass "
                             "model.parameters())")
        if weight_decay is not None:
            raise NotImplementedError(
                "the regularizers (Optimizer weight_decay) are not ported "
                "yet; AdamW's decoupled weight_decay is")
        self._parameter_list, self._parameter_names = [], []
        for item in parameters:
            name, p = item if isinstance(item, tuple) else (None, item)
            self._parameter_names.append(name)
            self._parameter_list.append(p)
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        # accumulator name -> {parameter position: tensor}
        self._accumulators: dict[str, dict[int, torch.Tensor]] = {}
        self._opt_step = 0

    # -- lr -----------------------------------------------------------------
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return self._learning_rate

    # -- accumulators -------------------------------------------------------
    def _acc(self, name, i, p, init=0.0, dtype=torch.float32):
        store = self._accumulators.setdefault(name, {})
        if i not in store:
            store[i] = torch.full(p.shape, init, dtype=dtype,
                                  device=p.device)
        return store[i]

    # -- step ---------------------------------------------------------------
    def _params_grads(self):
        return [(i, p, p.grad) for i, p in enumerate(self._parameter_list)
                if p is not None and p.requires_grad and p.grad is not None]

    @torch.no_grad()
    def step(self):
        ipg = self._params_grads()
        if self._grad_clip is not None:
            clipped = self._grad_clip([(p, g) for _, p, g in ipg])
            ipg = [(i, p, g) for (i, _, _), (p, g) in zip(ipg, clipped)]
        self._opt_step += 1
        for i, p, g in ipg:
            self._apply_one(i, p, g)

    def _apply_one(self, i, p, g):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            if p is None or p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    # -- state --------------------------------------------------------------
    def state_dict(self):
        sd = {}
        for name, store in self._accumulators.items():
            for i in sorted(store):
                sd[f"{name}/p{i}"] = store[i]
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        sd["_opt_step"] = self._opt_step
        return sd

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        """Restore from :meth:`state_dict` output: slots are copied into
        existing accumulators in place (created where missing) on their
        parameter's device; a slot whose shape differs from its
        parameter's raises ``ValueError``."""
        self._opt_step = int(state_dict.get("_opt_step", 0))
        if "LR_Scheduler" in state_dict and isinstance(self._learning_rate,
                                                       LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        for key, value in state_dict.items():
            if key in ("_opt_step", "LR_Scheduler"):
                continue
            name, _, pos = key.rpartition("/p")
            i = int(pos)
            p = self._parameter_list[i]
            value = torch.as_tensor(value)
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"optimizer slot {key!r} has shape "
                                 f"{tuple(value.shape)}, parameter {i} "
                                 f"{tuple(p.shape)}")
            self._acc(name, i, p).copy_(value)
