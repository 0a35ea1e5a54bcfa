"""``fleet`` (counterpart of paddle_tpu/distributed/fleet): ``init`` builds
the hybrid topology over the process group, ``distributed_model`` shards a
model for it, plus the role makers, ``worker_index`` / ``worker_num``,
``metrics``, ``utils.recompute`` and ``HybridParallelEngine``.

``distributed_model`` chooses the form as the reference does:

- with ``hybrid_configs["use_spmd"]`` set, or in hybrid mode with no
  optimizer known (none given and no ``distributed_optimizer`` call), the
  reference's one-compilation SPMD branch: the model is returned sharded
  and unwrapped. Every parameter annotated with a ``sharding_spec`` keeps
  this rank's mp slice (an MoE bank its ep rank's experts) and the model's
  mp-aware modules insert the tensor-parallel collectives
  (``spmd.shard_model``); every gradient is averaged over the ranks that
  split the batch in the backward (``parallel.sync_gradients``); a model
  that draws hashed dropout masks (a GPT) gets one dropout stream on every
  rank and its data-parallel block of the batch's rows
  (:func:`share_dropout_stream`). A pipeline degree above 1 is then
  driven by ``pp_spmd.PipelineSpmdStep`` or ``hapi.Model.train_batch``,
  and ``hapi.Model`` takes this form at every degree;
- in data-parallel mode, ``DataParallel(model)``;
- in hybrid mode with an optimizer known, a ``HybridParallelEngine`` (the
  1F1B pipeline, ZeRO stage-1 moments over ``sharding``).

These paths are eager: the captured multi-rank step (NCCL, one card a
rank) is ROADMAP queue 1 item 7b.
"""
from __future__ import annotations

import os

from . import metrics  # noqa: F401
from . import utils  # noqa: F401
from .distributed_strategy import DistributedStrategy  # noqa: F401
from .topology import CommunicateTopology, HybridCommunicateGroup  # noqa: F401
from .hybrid_engine import HybridParallelEngine  # noqa: F401

__all__ = ["init", "is_initialized", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group",
           "get_strategy", "worker_index", "worker_num", "is_first_worker",
           "is_worker", "is_server", "server_num", "UserDefinedRoleMaker",
           "PaddleCloudRoleMaker", "Role", "DistributedStrategy",
           "CommunicateTopology", "HybridCommunicateGroup",
           "share_dropout_stream", "HybridParallelEngine"]

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
    names = ["data", "pipe", "sharding", "model"]
    dims = [int(hc.get("dp_degree", 1)), int(hc.get("pp_degree", 1)),
            int(hc.get("sharding_degree", 1)), int(hc.get("mp_degree", 1))]
    if int(hc.get("ep_degree", 1)) > 1:
        names.insert(3, "expert")
        dims.insert(3, int(hc["ep_degree"]))
    hcg = HybridCommunicateGroup(CommunicateTopology(names, dims))
    from .. import spmd

    spmd.enable(hcg)
    _fleet_state.update(initialized=True, hcg=hcg, strategy=strategy,
                        role_maker=role_maker, optimizer=None,
                        use_spmd=bool(hc.get("use_spmd", False)))


def is_initialized():
    return _fleet_state["initialized"]


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    return _fleet_state["hcg"]


def get_strategy():
    return _fleet_state["strategy"]


def distributed_model(model, criterion=None, optimizer=None):
    """``model`` for the hybrid topology, in the form the module's
    docstring sets out. The sharded form is ``model`` itself (its
    ``state_dict`` keeps its names); call it before building the
    optimizer there, since sharding replaces parameter storage."""
    hcg = _fleet_state["hcg"]
    if hcg is None:
        raise RuntimeError("call fleet.init() first")
    if getattr(model, "_fleet_distributed", False):
        return model  # a second call would average the gradients twice
    mode = hcg.get_parallel_mode()
    opt = optimizer or _fleet_state.get("optimizer")
    if not _fleet_state.get("use_spmd") and mode == "data_parallel":
        from ..parallel import DataParallel

        dp = DataParallel(model, group=hcg.get_data_parallel_group())
        share_dropout_stream(model, hcg.get_data_parallel_rank())
        model._fleet_distributed = True
        return dp
    if not _fleet_state.get("use_spmd") and mode == "hybrid_parallel" \
            and opt is not None:
        return HybridParallelEngine(model, opt, hcg,
                                    _fleet_state["strategy"], criterion)
    return _shard_in_place(model, hcg)


def _shard_in_place(model, hcg):
    """The SPMD branch: mp slices (and expert banks), gradients averaged
    over the ranks that split the batch (an expert bank's over dp, see
    ``parallel``), one dropout stream. A pipeline step takes the
    gradients over itself, so a model on a mesh with ``pp > 1`` gets no
    backward hooks."""
    from .. import spmd
    from ..parallel import broadcast_parameters, sync_gradients

    if getattr(model, "_fleet_distributed", False):
        return model
    spmd.shard_model(model, hcg)
    dp = hcg.get_data_parallel_group()
    broadcast_parameters(model, dp)
    if hcg.get_pipe_parallel_world_size() == 1:
        sync_gradients(model, hcg.get_batch_group())
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


# the meta-optimizer toggles the reference applies only through its
# static-mode passes (``distributed/passes``, ROADMAP queue 1 item 11b),
# with what a dygraph user gets instead
_PASS_ONLY = (("lars", "use paddle_tpu_torch.optimizer.Lars directly"),
              ("lamb", "use paddle_tpu_torch.optimizer.Lamb directly"),
              ("localsgd", "gradients are averaged at every step"),
              ("fp16_allreduce", "gradients are averaged in their dtype"))


class _DistributedOptimizer:
    """``distributed_optimizer``'s wrapper: ``inner_opt`` is the
    optimizer, and every other attribute (``step``, ``clear_grad``,
    ``minimize``, ...) is the optimizer's, read and written there (a write
    kept on the wrapper would leave the optimizer's own ``_opt_step`` or
    parameter list stale)."""

    def __init__(self, optimizer):
        self.__dict__["inner_opt"] = optimizer

    def __getattr__(self, k):
        return getattr(self.__dict__["inner_opt"], k)

    def __setattr__(self, k, v):
        setattr(self.__dict__["inner_opt"], k, v)


def distributed_optimizer(optimizer, strategy=None):
    """Wrap ``optimizer`` (``inner_opt``) and remember it, so a later
    ``distributed_model`` in hybrid mode builds the engine with it. The
    meta-optimizer toggles the reference honours only in static mode warn,
    as its own do."""
    strat = strategy or _fleet_state.get("strategy")
    for flag, instead in _PASS_ONLY:
        if strat is not None and getattr(strat, flag, False):
            import warnings

            warnings.warn(
                f"DistributedStrategy.{flag} is honored only by static "
                f"mode's passes; this dygraph distributed_optimizer "
                f"ignores it — {instead}", stacklevel=2)
    _fleet_state["optimizer"] = optimizer
    return _DistributedOptimizer(optimizer)


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
