"""The Adam family (counterpart of paddle_tpu/optimizer/adam.py): Adam and
AdamW (with ``lazy_mode`` and master weights), Adamax, Adagrad, Adadelta,
RMSProp and Lamb.

Every update follows the reference's operations in its order, one
rounding each, written in place so a 1.3 B-parameter update makes no
copies of its parameters; the rate and the step count are the base's
device scalars. Slots are float32 whatever the parameter's dtype, as in the
reference, and named as its accumulators are.

Adam and AdamW with ``multi_precision=True`` keep a float32 master weight
for every non-float32 parameter: the update runs on the master and the
parameter receives it rounded to its own dtype. Unlike the reference,
which rebuilds the master weight from the rounded parameter at every
update (so its bf16 training never accumulates updates below bf16's
resolution), the master weight here is made once, from the parameter, and
then only the update writes it. This is why the port does not use
``torch.optim.AdamW``, which has no master weights and orders its
arithmetic differently.
"""
from __future__ import annotations

import torch

from .optimizer import F32, Optimizer

__all__ = ["Adam", "AdamW", "Adamax", "Adagrad", "Adadelta", "RMSProp",
           "Lamb"]


class _BiasCorrected(Optimizer):
    """Bias corrections ``1 - beta ** t`` from the step-count scalar, once
    per step."""

    def _bc(self, beta):
        return self._derived(("bc", beta), lambda: 1 - beta ** self._t_buf)


class Adam(_BiasCorrected):
    """``lazy_mode=True`` with a sparse gradient (``nn.Embedding(
    sparse=True)``) updates only the looked-up rows' moments and weights,
    from the coalesced gradient (the reference's ``merged()``); otherwise a
    sparse gradient is made dense first, since every moment decays each
    step."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._multi_precision = multi_precision
        self._lazy_mode = lazy_mode

    def _uses_master(self, p):
        return self._multi_precision and p.dtype != F32

    def _slots(self, p):
        slots = [("moment1", F32, 0.0), ("moment2", F32, 0.0)]
        if self._uses_master(p):
            slots.append(("master_weight", F32, None))
        return slots

    def _decay(self, i):
        """The decoupled weight-decay coefficient for parameter ``i``."""
        return 0.0

    def _apply_one(self, i, p, g):
        b1, b2, eps = self._beta1, self._beta2, self._eps
        acc = self._accumulators
        m, v = acc["moment1"][i], acc["moment2"][i]
        master = acc["master_weight"][i] if self._uses_master(p) else None
        lr = self._lr_for(p)
        wd = self._decay(i)
        gf = g.float()
        # the reference's operations in its order:
        #   base *= 1 - lr * wd;  m = b1 * m + (1 - b1) * g;
        #   v = b2 * v + (1 - b2) * g * g;
        #   base -= lr * (m / (1 - b1**t)) / (sqrt(v / (1 - b2**t)) + eps)
        # A float32 parameter without a master weight is its own base.
        base = master if master is not None else p.detach().float()
        if wd:
            base.mul_(self._derived(("decay", id(lr), wd),
                                    lambda: 1 - lr * wd))
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * (gf * gf))
        denom = (v / self._bc(b2)).sqrt_().add_(eps)
        base.sub_((lr * (m / self._bc(b1))).div_(denom))
        if base.data_ptr() != p.data_ptr():
            p.copy_(base)

    def _supports_sparse_grad(self):
        return self._lazy_mode

    def _apply_one_sparse(self, i, p, g):
        b1, b2, eps = self._beta1, self._beta2, self._eps
        acc = self._accumulators
        m, v = acc["moment1"][i], acc["moment2"][i]
        master = acc["master_weight"][i] if self._uses_master(p) else None
        g = g.coalesce()
        rows, gf = g.indices()[0], g.values().float()
        lr = self._lr_for(p)
        m_r = b1 * m[rows] + (1 - b1) * gf
        v_r = b2 * v[rows] + (1 - b2) * (gf * gf)
        mhat = m_r / self._bc(b1)
        vhat = v_r / self._bc(b2)
        base = (master if master is not None else p.float())[rows]
        new_r = base - lr * mhat / (torch.sqrt(vhat) + eps)
        p.index_copy_(0, rows, new_r.to(p.dtype))
        m.index_copy_(0, rows, m_r)
        v.index_copy_(0, rows, v_r)
        if master is not None:
            master.index_copy_(0, rows, new_r)


class AdamW(Adam):
    """Adam with decoupled weight decay: the base (master or parameter) is
    multiplied by ``1 - lr * weight_decay`` before the moment update, for
    every parameter whose name ``apply_decay_param_fun`` accepts (all of
    them when it is None). A sparse gradient is always made dense: the
    decay moves every row."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._wd_coeff = weight_decay
        self._apply_decay_param_fun = apply_decay_param_fun

    def _supports_sparse_grad(self):
        return False

    def _decay(self, i):
        fun = self._apply_decay_param_fun
        if fun is not None and not fun(self._parameter_names[i]):
            return 0.0
        return self._wd_coeff


class Adamax(_BiasCorrected):
    """``m = b1 m + (1 - b1) g``; ``u = max(b2 u, |g|)``; ``w -= lr / (1 -
    b1**t) * m / (u + eps)``. Slots ``moment`` and ``inf_norm``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _slots(self, p):
        return [("moment", F32, 0.0), ("inf_norm", F32, 0.0)]

    def _apply_one(self, i, p, g):
        b1, b2, eps = self._beta1, self._beta2, self._eps
        m = self._accumulators["moment"][i]
        u = self._accumulators["inf_norm"][i]
        gf = g.float()
        m.mul_(b1).add_((1 - b1) * gf)
        torch.maximum(b2 * u, gf.abs(), out=u)
        step = self._lr_for(p) / self._bc(b1)
        p.copy_(p.float() - step * m / (u + eps))


class Adagrad(Optimizer):
    """``a += g * g``; ``w -= lr * g / (sqrt(a) + eps)``. Slot ``moment``,
    starting at ``initial_accumulator_value``."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _slots(self, p):
        return [("moment", F32, self._init_acc)]

    def _apply_one(self, i, p, g):
        a = self._accumulators["moment"][i]
        gf = g.float()
        a.add_(gf * gf)
        p.copy_(p.float() - self._lr_for(p) * gf
                / (torch.sqrt(a) + self._eps))


class Adadelta(Optimizer):
    """``E[g2] = rho E[g2] + (1 - rho) g * g``; ``d = sqrt(E[d2] + eps) /
    sqrt(E[g2] + eps) * g``; ``E[d2] = rho E[d2] + (1 - rho) d * d``;
    ``w -= lr * d``. Slots ``avg_squared_grad`` and
    ``avg_squared_update``."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps, self._rho = epsilon, rho

    def _slots(self, p):
        return [("avg_squared_grad", F32, 0.0),
                ("avg_squared_update", F32, 0.0)]

    def _apply_one(self, i, p, g):
        eps, rho = self._eps, self._rho
        ag = self._accumulators["avg_squared_grad"][i]
        au = self._accumulators["avg_squared_update"][i]
        gf = g.float()
        ag.mul_(rho).add_((1 - rho) * (gf * gf))
        upd = torch.sqrt(au + eps) / torch.sqrt(ag + eps) * gf
        au.mul_(rho).add_((1 - rho) * (upd * upd))
        p.copy_(p.float() - self._lr_for(p) * upd)


class RMSProp(Optimizer):
    """``E[g2] = rho E[g2] + (1 - rho) g * g`` (centered: less ``E[g]**2``,
    ``E[g] = rho E[g] + (1 - rho) g``); ``v = momentum v + lr * g /
    sqrt(E[g2] + eps)``; ``w -= v``. Slots ``mean_square``, ``mean_grad``
    and ``velocity``."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _slots(self, p):
        return [("mean_square", F32, 0.0), ("mean_grad", F32, 0.0),
                ("velocity", F32, 0.0)]

    def _apply_one(self, i, p, g):
        rho, eps, mom = self._rho, self._eps, self._momentum
        acc = self._accumulators
        ms, mg, vel = (acc[n][i] for n in ("mean_square", "mean_grad",
                                           "velocity"))
        gf = g.float()
        ms.mul_(rho).add_((1 - rho) * (gf * gf))
        if self._centered:
            mg.mul_(rho).add_((1 - rho) * gf)
            denom = ms - mg * mg
        else:
            denom = ms
        vel.mul_(mom).add_(self._lr_for(p) * gf / torch.sqrt(denom + eps))
        p.copy_(p.float() - vel)


class Lamb(_BiasCorrected):
    """Adam's moments, then the layer-wise trust ratio: ``r = mhat /
    (sqrt(vhat) + eps) + wd w``; ``w -= lr * (||w|| / ||r||) * r`` (ratio 1
    where either norm is 0). ``exclude_from_weight_decay_fn(param)`` True
    gives ``wd = 0``."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _slots(self, p):
        return [("moment1", F32, 0.0), ("moment2", F32, 0.0)]

    def _apply_one(self, i, p, g):
        b1, b2, eps = self._beta1, self._beta2, self._eps
        wd = 0.0 if (self._exclude_fn is not None and self._exclude_fn(p)) \
            else self._wd
        m = self._accumulators["moment1"][i]
        v = self._accumulators["moment2"][i]
        gf, wf = g.float(), p.float()
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * (gf * gf))
        mhat = m / self._bc(b1)
        vhat = v / self._bc(b2)
        r = mhat / (torch.sqrt(vhat) + eps) + wd * wf
        w_norm = torch.sqrt(torch.sum(torch.square(wf)))
        r_norm = torch.sqrt(torch.sum(torch.square(r)))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones((), device=p.device))
        p.copy_(wf - self._lr_for(p) * trust * r)
