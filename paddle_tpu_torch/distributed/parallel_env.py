"""The process group of a multi-process run (counterpart of
paddle_tpu/distributed/parallel_env.py).

The launcher protocol is the reference's: ``PADDLE_TRAINERS_NUM`` (the
world size), ``PADDLE_TRAINER_ID`` (this process's rank) and
``PADDLE_MASTER`` or ``PADDLE_COORDINATOR`` (``host:port`` of the
rendezvous). :func:`init_parallel_env` reads them and calls
``torch.distributed.init_process_group`` once per process.

Semantics differ from the reference in one place. The reference is one
controller over many devices: its ``get_world_size()`` is
``jax.device_count()``, and its CPU tests run eight virtual devices in one
process. The port runs one process per rank, so its world is the number of
processes and ``get_rank()`` is this process's rank among them.

Backend: NCCL when the rank's device is CUDA, gloo when the caller asks
for ``device="cpu"`` (the tests) or for ``backend="gloo"`` by name (gloo
then carries CUDA tensors too; see ``collective`` for the ops it stages
through host memory). Without a GPU and without ``device="cpu"`` it
raises, as every entry point of the port does. The process group's own
rendezvous is torch's c10d store: ``env://`` (``MASTER_ADDR`` /
``MASTER_PORT``, set here from ``PADDLE_MASTER``) or an ``init_method`` the
caller passes, such as ``file://`` in the tests.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["init_parallel_env", "get_rank", "get_world_size", "ParallelEnv",
           "barrier", "is_initialized", "device"]

_state = {"device": None}


def init_parallel_env(device=None, backend=None, init_method=None,
                      timeout=None):
    """Join the process group described by the launcher's environment and
    return a :class:`ParallelEnv`. A second call returns at once.

    ``device``: this rank's device (None: ``cuda:<local rank % cards>``,
    raising without a GPU; ``"cpu"`` for the tests). ``backend``: None
    picks NCCL for a CUDA device and gloo for the CPU; ``"gloo"`` forces
    gloo. ``init_method``: None reads ``env://`` (``PADDLE_MASTER`` or
    ``PADDLE_COORDINATOR`` sets ``MASTER_ADDR`` / ``MASTER_PORT``).
    ``timeout``: seconds for the rendezvous and every collective (torch's
    default when None)."""
    if dist.is_initialized():
        return ParallelEnv()
    nranks = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    if device is None:
        if not torch.cuda.is_available():
            resolve_device(None)  # raises, naming device="cpu"
        local = int(os.environ.get("PADDLE_LOCAL_RANK", str(rank)))
        device = torch.device("cuda", local % torch.cuda.device_count())
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if init_method is None:
        master = os.environ.get(
            "PADDLE_COORDINATOR", os.environ.get(
                "PADDLE_MASTER", os.environ.get("MASTER_ENDPOINT", "")))
        if master:
            host, _, port = master.rpartition(":")
            os.environ["MASTER_ADDR"] = host or "127.0.0.1"
            os.environ["MASTER_PORT"] = port
        os.environ.setdefault("MASTER_ADDR", "127.0.0.1")
        os.environ.setdefault("MASTER_PORT", "29500")
        init_method = "env://"
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout))
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=nranks, **kw)
    _state["device"] = dev
    return ParallelEnv()


def is_initialized():
    return dist.is_initialized()


def device():
    """This rank's device, as :func:`init_parallel_env` chose it (None
    before it ran)."""
    return _state["device"]


def get_rank(group=None):
    """This process's rank in the world, or in ``group`` (-1 outside it)."""
    if not dist.is_initialized():
        return 0
    if group is not None:
        return group.get_group_rank(dist.get_rank())
    return dist.get_rank()


def get_world_size(group=None):
    """The number of processes in the world, or ``group``'s size."""
    if group is not None:
        return group.nranks
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier(group=None):
    """Block until every rank of ``group`` (the world) reaches it."""
    if not dist.is_initialized():
        return
    from .collective import _default_group

    g = group or _default_group()
    if g.nranks > 1:
        dist.barrier(group=g.process_group)


class ParallelEnv:
    """The reference's ``ParallelEnv`` over this process's rank."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        dev = _state["device"]
        return dev.index if dev is not None and dev.type == "cuda" else 0

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:0")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else [self.current_endpoint]

    local_rank = rank
    nranks = world_size
