"""Data parallelism (counterpart of paddle_tpu/distributed/parallel.py).

Each data-parallel rank runs the model on its share of the batch and takes
the mean of its own rows' loss. The gradients are then **averaged** over
the data-parallel group: the mean of the ranks' gradients of their mean
losses is the gradient of the mean loss over the whole batch, so every
rank's optimizer takes the step the reference takes over the global
batch (where the mean is one reduction over every row).

The average runs in the backward, as soon as each parameter's gradient is
complete: a hook on the parameter all-reduces the gradient that reaches
it (a parameter used twice, as a tied embedding is, receives one summed
gradient), so ``loss.backward()`` leaves synchronised gradients and a
plain training loop needs nothing more. ``apply_collective_grads``
averages whatever gradient the hooks did not (the reference's explicit
call): called after the backward, it finds nothing left to do.

An expert bank of an MoE layer at ``ep > 1`` (a parameter carrying
``expert_grad_sync = (dp group, ep)``) is held by one expert rank, which
receives through the expert all-to-all the gradient of every expert
rank's mean loss: its gradient is averaged over the dp group alone and
divided by ``ep``.

A ``DataParallel`` over the world (no group given, no fleet) follows the
world: when a rank tears its process group down and forms it again at the
same size, as an elastic survivor does after a sibling's restart, the
next backward averages over the new group.
"""
from __future__ import annotations

import torch
from torch import nn

from . import collective

__all__ = ["DataParallel", "sync_gradients", "broadcast_parameters"]


class _GradSync:
    """The backward hooks of one model over one group."""

    def __init__(self, module, group):
        self._group = group  # a Group, or a callable giving the current one
        self.synced: set = set()
        self._handles = [p.register_hook(self._hook(p))
                         for p in module.parameters() if p.requires_grad]

    def remove(self):
        """Take the hooks off (a ZeRO optimizer reduces the gradients
        itself)."""
        for h in self._handles:
            h.remove()
        self._handles = []

    def _hook(self, p):
        key = id(p)

        def hook(grad):
            self.synced.add(key)
            expert = getattr(p, "expert_grad_sync", None)
            if expert is not None:
                return _averaged(grad, expert[0]).div_(expert[1])
            return _averaged(grad, self.group)

        return hook

    @property
    def group(self):
        return self._group() if callable(self._group) else self._group


def _averaged(grad, group):
    if grad.is_sparse:  # sparse rows cannot ride an all-reduce
        grad = grad.to_dense()
    grad = grad.clone()
    collective.all_reduce(grad, collective.ReduceOp.AVG, group=group)
    return grad


def sync_gradients(module, group):
    """Average ``module``'s gradients over ``group`` in every backward
    (hooks, as above). Returns the handle; a group of one process adds no
    hook. ``group`` may be a callable giving the group at each backward."""
    now = group() if callable(group) else group
    if now is None or now.nranks <= 1:
        return None
    sync = _GradSync(module, group)
    module._grad_sync = sync
    return sync


def broadcast_parameters(module, group):
    """Make every rank of ``group`` start from its first rank's parameters
    and buffers (the reference's single copy)."""
    if group is None or group.nranks <= 1:
        return
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            collective.broadcast(t.data, src=group.ranks[0], group=group)


class DataParallel(nn.Module):
    """``DataParallel(layers, group=None)``: ``layers`` with its gradients
    averaged over ``group`` (default: the fleet's data-parallel group, else
    the world), its parameters broadcast from the group's first rank."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        if group is None:
            from .fleet import get_hybrid_communicate_group

            hcg = get_hybrid_communicate_group()
            # no fleet: the world, as it is at each backward
            group = hcg.get_data_parallel_group() if hcg is not None \
                else collective.get_group
        self._group = group
        broadcast_parameters(layers, self.group)
        self._sync = sync_gradients(layers, group)

    @property
    def group(self):
        return self._group() if callable(self._group) else self._group

    def forward(self, *inputs, **kwargs):
        if self._sync is not None:
            self._sync.synced.clear()
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        """The loss as it is: the gradients are averaged, not summed."""
        return loss

    @torch.no_grad()
    def apply_collective_grads(self):
        """Average every gradient the backward's hooks did not."""
        if self.group is None or self.group.nranks <= 1:
            return
        done = self._sync.synced if self._sync is not None else set()
        for p in self._layers.parameters():
            if p.grad is not None and id(p) not in done:
                p.grad = _averaged(p.grad, self.group)
        done.clear()

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    load_state_dict = set_state_dict
