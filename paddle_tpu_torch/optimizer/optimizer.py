"""Optimizer base, SGD, Momentum and Lars (counterpart of
paddle_tpu/optimizer/optimizer.py).

Parameters are updated in place under ``torch.no_grad()``. Per-parameter
state (moments, velocities, master weights) lives in accumulators named
like the reference's, and ``state_dict()`` keys them as the reference does
for unnamed parameters: ``"<accumulator>/p<i>"`` by position in the
parameter list, plus ``"_opt_step"`` and, with a scheduler,
``"LR_Scheduler"``.

The learning rate and the step count reach the update as float32 scalars
on the parameters' device (``_lr_buf`` and ``_t_buf``, views of one
two-element buffer), the reference's op inputs (``adam.py:48-53``) and
never constants: ``step()`` writes them from Python state with one
host-to-device copy before it updates. Under a CUDA graph
(``jit.TrainStep``) that write is left out of the capture and made before
each replay instead, so the graph and the eager loop run the same update
kernels on the same values, and a scheduler stepped between calls takes
effect at every replay.

``step()`` keeps the reference's order (``_step_impl``): a sparse gradient
is made dense where the update needs all of it (a regularizer, a clip, or
an optimizer without a row-wise rule), then the regularizer, then the
clip, then the step count advances, then each parameter is updated.
"""
from __future__ import annotations

import torch

from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Lars"]

F32 = torch.float32


def _capturing(t):
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


class Optimizer:
    """``parameters``: an iterable of tensors, or of ``(name, tensor)``
    pairs such as ``model.named_parameters()``; the names reach
    ``apply_decay_param_fun`` and Lars's exclusion list (unnamed parameters
    give None, as the reference's do). ``learning_rate``: a float or an
    :class:`~.lr.LRScheduler`. ``weight_decay``: a float (an
    :class:`~.regularizer.L2Decay`) or a regularizer. ``grad_clip``: a
    callable over ``[(param, grad)]`` such as ``nn.ClipGradByGlobalNorm``.

    A parameter's ``optimize_attr = {"learning_rate": m}`` scales its rate
    by ``m``, its ``regularizer`` replaces the optimizer's, and
    ``need_clip = False`` keeps it out of the clip."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is None:
            raise ValueError("parameters is required (pass "
                             "model.parameters())")
        self._parameter_list, self._parameter_names = [], []
        for item in parameters:
            pname, p = item if isinstance(item, tuple) else (None, item)
            self._parameter_names.append(pname)
            self._parameter_list.append(p)
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        if isinstance(weight_decay, float):
            from .regularizer import L2Decay

            weight_decay = L2Decay(weight_decay)
        self._weight_decay = weight_decay
        # accumulator name -> {parameter position: tensor}
        self._accumulators: dict[str, dict[int, torch.Tensor]] = {}
        self._opt_step = 0
        self._scalars = None  # float32 [lr, t] on the parameters' device
        self._cache: dict = {}  # device scalars derived once per step

    # -- lr -----------------------------------------------------------------
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = value

    @staticmethod
    def _lr_mult(p):
        attr = getattr(p, "optimize_attr", None)
        return float(attr.get("learning_rate", 1.0)) if attr else 1.0

    # -- device scalars -----------------------------------------------------
    def _scalar_buffers(self):
        if self._scalars is None:
            dev = next((p.device for p in self._parameter_list
                        if p is not None), torch.device("cpu"))
            if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "optimizer: the learning-rate and step scalars must "
                    "exist before a CUDA graph captures the step (run one "
                    "step eagerly first, as jit.TrainStep does)")
            self._scalars = torch.zeros(2, dtype=F32, device=dev)
            self._lr_buf, self._t_buf = self._scalars[0], self._scalars[1]
        return self._scalars

    def _write_scalars(self, lr, t):
        """Write ``[lr, t]`` into the device scalars: one copy from pinned
        host memory on a card (asynchronous, and a copy rather than a
        kernel), a plain copy on the CPU."""
        buf = self._scalar_buffers()
        host = torch.tensor([lr, t], dtype=F32)
        if buf.is_cuda:
            buf.copy_(host.pin_memory(), non_blocking=True)
        else:
            buf.copy_(host)

    def _derived(self, key, fn):
        """A device scalar computed from the buffers once per step."""
        v = self._cache.get(key)
        if v is None:
            v = self._cache[key] = fn()
        return v

    def _lr_for(self, p):
        """Parameter ``p``'s rate: ``_lr_buf`` times its multiplier."""
        m = self._lr_mult(p)
        if m == 1.0:
            return self._lr_buf
        return self._derived(("lr", m), lambda: self._lr_buf * m)

    # -- accumulators -------------------------------------------------------
    def _slots(self, p):
        """``[(accumulator name, dtype, initial value)]`` kept for ``p``;
        an initial value of None starts the slot as a copy of ``p``."""
        return []

    def _acc(self, name, i, p, init=0.0, dtype=F32):
        store = self._accumulators.setdefault(name, {})
        if i not in store:
            store[i] = (p.detach().to(dtype).clone() if init is None
                        else torch.full(p.shape, init, dtype=dtype,
                                        device=p.device))
        return store[i]

    def _create_accumulators(self, i, p):
        for name, dtype, init in self._slots(p):
            self._acc(name, i, p, init, dtype)

    def _ensure_accumulators(self):
        """Create every slot and the device scalars now (``jit.TrainStep``
        does this before it captures a step)."""
        self._scalar_buffers()
        for i, p in enumerate(self._parameter_list):
            if p is not None and p.requires_grad:
                self._create_accumulators(i, p)

    # -- step ---------------------------------------------------------------
    def _params_grads(self):
        return [(i, p, p.grad) for i, p in enumerate(self._parameter_list)
                if p is not None and p.requires_grad and p.grad is not None]

    @torch.no_grad()
    def step(self):
        ipg = self._params_grads()
        densify = (self._weight_decay is not None
                   or self._grad_clip is not None
                   or not self._supports_sparse_grad())
        if densify:
            ipg = [(i, p, g.to_dense() if g.is_sparse else g)
                   for i, p, g in ipg]
        if self._weight_decay is not None:
            ipg = [(i, p, self._weight_decay(p, g)) for i, p, g in ipg]
        if self._grad_clip is not None:
            clipped = self._grad_clip([(p, g) for _, p, g in ipg])
            ipg = [(i, p, g) for (i, _, _), (p, g) in zip(ipg, clipped)]
        self._opt_step += 1
        if not _capturing(self._scalar_buffers()):
            self._write_scalars(self.get_lr(), self._opt_step)
        self._cache = {}
        for i, p, g in ipg:
            self._create_accumulators(i, p)
            if g.is_sparse:
                if _capturing(g):
                    raise RuntimeError(
                        "optimizer: a sparse gradient's row update needs "
                        "its row count on the host and cannot be captured "
                        "in a CUDA graph; update it in an eager loop")
                self._apply_one_sparse(i, p, g)
            else:
                self._apply_one(i, p, g)

    def _apply_one(self, i, p, g):
        raise NotImplementedError

    def _supports_sparse_grad(self):
        """Override (with ``_apply_one_sparse``) for row-wise rules."""
        return False

    def _apply_one_sparse(self, i, p, g):
        raise NotImplementedError

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` then :meth:`step` (the eager form; there is
        no static mode). Returns ``(None, [(param, grad)])``."""
        loss.backward()
        self.step()
        return None, [(p, g) for _, p, g in self._params_grads()]

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            if p is None or p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

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
        the existing accumulators in place (created where missing) on
        their parameter's device, so a captured training step stays valid;
        a slot whose shape differs from its parameter's raises
        ``ValueError``."""
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
            self._create_accumulators(i, p)
            slot = self._accumulators.get(name, {}).get(i)
            if slot is None:
                slot = self._acc(name, i, p)
            slot.copy_(value)


class SGD(Optimizer):
    """``w -= lr * g``; a sparse gradient (``nn.Embedding(sparse=True)``)
    moves only its rows, duplicates summed by ``index_add_`` as the
    reference's row update sums them."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _apply_one(self, i, p, g):
        p.sub_((self._lr_for(p) * g.float()).to(p.dtype))

    def _supports_sparse_grad(self):
        return True

    def _apply_one_sparse(self, i, p, g):
        rows = g._indices()[0]
        p.index_add_(0, rows, ((-self._lr_for(p)) * g._values()).to(p.dtype))


class Momentum(Optimizer):
    """``v = mu v + g``; ``w -= lr v`` (or ``lr (g + mu v)`` with
    ``use_nesterov``), the velocity in the parameter's dtype and the
    arithmetic too, as in the reference."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _slots(self, p):
        return [("velocity", p.dtype, 0.0)]

    def _apply_one(self, i, p, g):
        mu = self._momentum
        vel = self._accumulators["velocity"][i]
        gg = g.to(p.dtype)
        lr = self._lr_for(p).to(p.dtype)
        vel.mul_(mu).add_(gg)
        if self._nesterov:
            p.sub_(lr * (gg + mu * vel))
        else:
            p.sub_(lr * vel)


class Lars(Momentum):
    """LARS momentum: ``local_lr = lr * lars_coeff * ||w|| / (||g|| + wd *
    ||w|| + eps)`` (``lr`` where either norm is 0), ``v = mu v + local_lr
    (g + wd w)``, ``w -= v``; norms and arithmetic in float32. A parameter
    whose name contains an entry of ``exclude_from_weight_decay`` takes
    ``wd = 0``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, epsilon=1e-9,
                 exclude_from_weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, momentum, parameters,
                         use_nesterov=False, weight_decay=None,
                         grad_clip=grad_clip, name=name)
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._eps = epsilon
        self._exclude = list(exclude_from_weight_decay or [])

    def _apply_one(self, i, p, g):
        mu, coeff, eps = self._momentum, self._lars_coeff, self._eps
        wd = self._lars_wd
        pname = self._parameter_names[i] or ""
        if any(k in pname for k in self._exclude):
            wd = 0.0
        vel = self._accumulators["velocity"][i]
        lr = self._lr_for(p)
        wf, gf = p.float(), g.float()
        w_norm = torch.sqrt(torch.sum(torch.square(wf)))
        g_norm = torch.sqrt(torch.sum(torch.square(gf)))
        local_lr = torch.where((w_norm > 0) & (g_norm > 0),
                               lr * coeff * w_norm
                               / (g_norm + wd * w_norm + eps), lr)
        v_new = mu * vel.float() + local_lr * (gf + wd * wf)
        p.copy_(wf - v_new)
        vel.copy_(v_new)
