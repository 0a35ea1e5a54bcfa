"""``fleet`` (counterpart of paddle_tpu/distributed/fleet): ``init`` builds
the hybrid topology over the process group, ``distributed_model`` shards a
model for it, plus the role makers, ``worker_index`` / ``worker_num``,
``metrics`` and ``utils.recompute``.

``distributed_model`` is the counterpart of the reference's one-compilation
SPMD branch (``use_spmd``, which returns the model sharded and unwrapped),
the only form the port has: every parameter annotated with a
``sharding_spec`` keeps this rank's mp slice and the model's mp-aware
modules insert the tensor-parallel collectives (``spmd.shard_model``);
every gradient is averaged over the data-parallel group in the backward
(``parallel.sync_gradients``); a model that draws hashed dropout masks (a
GPT) gets one dropout stream on every rank and its data-parallel block of
the batch's rows (:func:`share_dropout_stream`). Pipeline and expert degrees above 1 raise
``NotImplementedError`` (ROADMAP queue 1 item 7).
"""
from __future__ import annotations

import os

from . import metrics  # noqa: F401
from . import utils  # noqa: F401
from .distributed_strategy import DistributedStrategy  # noqa: F401
from .topology import CommunicateTopology, HybridCommunicateGroup  # noqa: F401

__all__ = ["init", "is_initialized", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group",
           "get_strategy", "worker_index", "worker_num", "is_first_worker",
           "is_worker", "is_server", "server_num", "UserDefinedRoleMaker",
           "PaddleCloudRoleMaker", "Role", "DistributedStrategy",
           "CommunicateTopology", "HybridCommunicateGroup",
           "share_dropout_stream"]

_fleet_state = {"initialized": False, "hcg": None, "strategy": None,
                "role_maker": None, "optimizer": None}


class Role:
    WORKER = 1
    SERVER = 2


class PaddleCloudRoleMaker:
    """This process's role and the cluster's layout from the launcher's
    environment (``TRAINING_ROLE``, ``PADDLE_TRAINER_ID``,
    ``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_PSERVERS_IP_PORT_LIST``)."""

    def __init__(self, is_collective=False, **kwargs):
        self._is_collective = is_collective
        self._training_role = os.environ.get("TRAINING_ROLE", "TRAINER")
        self._worker_endpoints = [
            e for e in os.environ.get("PADDLE_TRAINER_ENDPOINTS",
                                      "").split(",") if e]
        self._server_endpoints = [
            e for e in os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST",
                                      "").split(",") if e]
        self._current_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self._role = (Role.SERVER if self._training_role == "PSERVER"
                      else Role.WORKER)

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER

    def is_first_worker(self):
        return self.is_worker() and self._current_id == 0

    def worker_index(self):
        return self._current_id

    def server_index(self):
        return self._current_id

    def worker_num(self):
        return max(len(self._worker_endpoints), 1)

    def server_num(self):
        return max(len(self._server_endpoints), 1)

    def get_trainer_endpoints(self):
        return list(self._worker_endpoints)

    def get_pserver_endpoints(self):
        return list(self._server_endpoints)


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    """An explicit role and rank instead of the environment's."""

    def __init__(self, is_collective=False, current_id=0, role=Role.WORKER,
                 worker_num=1, server_endpoints=(), **kwargs):
        self._is_collective = is_collective
        self._current_id = int(current_id)
        self._role = role
        self._worker_num = int(worker_num)
        self._worker_endpoints = []
        self._server_endpoints = list(server_endpoints)

    def worker_num(self):
        return self._worker_num

    def server_num(self):
        return len(self._server_endpoints)


def init(role_maker=None, is_collective=False, strategy=None,
         log_level="INFO"):
    """Join the process group (when the launcher's environment names more
    than one trainer and it is not joined yet) and build the hybrid
    topology of ``strategy.hybrid_configs``: ``dp_degree x pp_degree x
    sharding_degree x mp_degree`` must be the world's size. The
    parameter-server mode (a role maker with ``is_collective=False``) is
    not ported (ROADMAP queue 1 item 11)."""
    from .. import parallel_env

    if role_maker is not None and not is_collective:
        raise NotImplementedError(
            "fleet.init's parameter-server mode (distributed/ps) is not "
            "ported yet (ROADMAP queue 1 item 11); pass is_collective=True")
    if not parallel_env.is_initialized() and \
            int(os.environ.get("PADDLE_TRAINERS_NUM", "1")) > 1:
        parallel_env.init_parallel_env()
    strategy = strategy or DistributedStrategy()
    hc = strategy.hybrid_configs
    for key in ("pp_degree", "ep_degree"):
        if int(hc.get(key, 1)) > 1:
            raise NotImplementedError(
                f"fleet.init: {key}={hc[key]} needs pipeline or expert "
                "parallelism, which is not ported yet (ROADMAP queue 1 "
                "item 7)")
    topo = CommunicateTopology(
        ["data", "pipe", "sharding", "model"],
        [int(hc.get("dp_degree", 1)), 1, int(hc.get("sharding_degree", 1)),
         int(hc.get("mp_degree", 1))])
    hcg = HybridCommunicateGroup(topo)
    from .. import spmd

    spmd.enable(hcg)
    _fleet_state.update(initialized=True, hcg=hcg, strategy=strategy,
                        role_maker=role_maker, optimizer=None)


def is_initialized():
    return _fleet_state["initialized"]


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    return _fleet_state["hcg"]


def get_strategy():
    return _fleet_state["strategy"]


def distributed_model(model, criterion=None, optimizer=None):
    """``model`` sharded over the mp group and with its gradients averaged
    over the data-parallel group (see the module's docstring); returned
    itself, not wrapped, so its ``state_dict`` keeps its names. Call it
    before building the optimizer: sharding replaces parameter storage."""
    from .. import spmd
    from ..parallel import broadcast_parameters, sync_gradients

    hcg = _fleet_state["hcg"]
    if hcg is None:
        raise RuntimeError("call fleet.init() first")
    if getattr(model, "_fleet_distributed", False):
        return model  # a second call would average the gradients twice
    spmd.shard_model(model, hcg)
    dp = hcg.get_data_parallel_group()
    broadcast_parameters(model, dp)
    sync_gradients(model, dp)
    share_dropout_stream(model, dp.rank)
    model._fleet_distributed = True
    return model


def share_dropout_stream(model, batch_shard):
    """For each module of ``model`` that draws hashed dropout masks (one
    with ``batch_shard`` and ``set_generator``, as ``GPTModel``): its rows
    become block ``batch_shard`` of the batch's, and its ``generator``
    becomes the first rank's (its state broadcast over the world; a module
    without one gets a generator seeded with the first rank's
    ``torch.initial_seed()``), so every rank draws the same dropout keys."""
    import torch
    import torch.distributed as dist

    from .. import collective

    world = dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() > 1
    for mod in model.modules():
        if not hasattr(mod, "batch_shard") or \
                not hasattr(mod, "set_generator"):
            continue
        mod.batch_shard = batch_shard
        if not world:
            continue
        gen = mod.generator
        if gen is None:
            gen = torch.Generator(mod.device).manual_seed(
                torch.initial_seed())
        state = gen.get_state().to(mod.device)
        collective.broadcast(state, src=0)
        gen.set_state(state.cpu())
        mod.set_generator(gen)


def distributed_optimizer(optimizer, strategy=None):
    """The optimizer as it is: the gradients it reads are already averaged
    in the backward. Kept for the reference's API."""
    _fleet_state["optimizer"] = optimizer
    return optimizer


def is_worker():
    rm = _fleet_state.get("role_maker")
    return rm.is_worker() if rm is not None else True


def is_server():
    rm = _fleet_state.get("role_maker")
    return rm.is_server() if rm is not None else False


def server_num():
    rm = _fleet_state.get("role_maker")
    return rm.server_num() if rm is not None else 0


def worker_index():
    rm = _fleet_state.get("role_maker")
    if rm is not None:
        return rm.worker_index()
    from .. import parallel_env

    return parallel_env.get_rank()


def worker_num():
    rm = _fleet_state.get("role_maker")
    if rm is not None:
        return rm.worker_num()
    from .. import parallel_env

    return parallel_env.get_world_size()


def is_first_worker():
    return worker_index() == 0
