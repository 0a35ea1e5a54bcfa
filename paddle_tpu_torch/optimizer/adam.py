"""Adam and AdamW (counterpart of paddle_tpu/optimizer/adam.py).

Moments are float32 whatever the parameter's dtype. With
``multi_precision=True`` every non-float32 parameter keeps a float32 master
weight: the update runs on the master and the parameter receives it
rounded to its own dtype. The step count and the learning rate enter the
update as float32 scalars and the update follows the reference's order,
so float32 results agree with the reference to rounding; this is why the
port does not use ``torch.optim.AdamW``, which has no master weights and
orders its arithmetic differently.

Unlike the reference, which rebuilds the master weight from the rounded
parameter at every update (so its bf16 training never accumulates
updates below bf16's resolution), the master weight here is made once,
from the parameter, and then only the update writes it.
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._multi_precision = multi_precision

    def _uses_master(self, p):
        return self._multi_precision and p.dtype != torch.float32

    def _create_accumulators(self, i, p):
        self._acc("moment1", i, p)
        self._acc("moment2", i, p)
        if self._uses_master(p):
            masters = self._accumulators.setdefault("master_weight", {})
            if i not in masters:
                masters[i] = p.detach().float().clone()

    def _decay(self, i):
        """The decoupled weight-decay coefficient for parameter ``i``."""
        return 0.0

    def _apply_one(self, i, p, g):
        b1, b2, eps = self._beta1, self._beta2, self._eps
        self._create_accumulators(i, p)
        m = self._accumulators["moment1"][i]
        v = self._accumulators["moment2"][i]
        master = self._accumulators["master_weight"][i] \
            if self._uses_master(p) else None
        # float32 scalars kept on the host: the scalar arithmetic below runs
        # there, and a 0-d CPU tensor enters a CUDA kernel as an argument,
        # with no copy that would wait for the card
        lr = torch.tensor(self.get_lr(), dtype=torch.float32)
        t = torch.tensor(self._opt_step, dtype=torch.float32)
        wd = self._decay(i)
        gf = g.float()
        # the reference's operations, one rounding each, in its order:
        #   base *= 1 - lr * wd;  m = b1 * m + (1 - b1) * g;
        #   v = b2 * v + (1 - b2) * g * g;
        #   base -= lr * (m / (1 - b1**t)) / (sqrt(v / (1 - b2**t)) + eps)
        # written in place, so the 1.3 B-parameter update makes no copies.
        # A float32 parameter without a master weight is its own base.
        base = master if master is not None else p.detach().float()
        if wd:
            base.mul_(1 - lr * wd)
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * (gf * gf))
        denom = (v / (1 - b2 ** t)).sqrt_().add_(eps)
        base.sub_((lr * (m / (1 - b1 ** t))).div_(denom))
        if base.data_ptr() != p.data_ptr():
            p.copy_(base)


class AdamW(Adam):
    """Adam with decoupled weight decay: the base (master or parameter) is
    multiplied by ``1 - lr * weight_decay`` before the moment update, for
    every parameter whose name ``apply_decay_param_fun`` accepts (all of
    them when it is None)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, multi_precision)
        self._wd_coeff = weight_decay
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay(self, i):
        fun = self._apply_decay_param_fun
        if fun is not None and not fun(self._parameter_names[i]):
            return 0.0
        return self._wd_coeff
