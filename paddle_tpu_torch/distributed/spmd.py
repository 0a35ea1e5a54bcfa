"""Placement of a model and a batch on the hybrid mesh (counterpart of
paddle_tpu/distributed/spmd.py).

The reference compiles one program over a device mesh and places every
parameter with a ``NamedSharding`` derived from its ``sharding_spec``.
Here each rank is a process, so placing means keeping this rank's slice:
:func:`shard_model` cuts every annotated parameter down to its local shard,
as a plain tensor (not a DTensor: the kernels are bound with ``ctypes``,
``TrainStep`` captures plain tensors and ``convert`` speaks them), and
hands the mp group to the model's mp-aware modules, whose forwards then
insert the tensor-parallel collectives (``meta_parallel.mp_ops``).
:func:`shard_batch` keeps this rank's rows of a batch: its block of the
ranks that split a batch, dp x sharding x ep jointly (the reference's
``shard_batch`` splits over ``('dp', 'ep')``, and its SPMD mesh folds
``sharding`` onto ``dp``).

A ``sharding_spec`` names one mesh axis or None per dimension of the
parameter in the port's layout (a Linear weight is ``[out, in]``).
:func:`param_pspec` is the reference's rule, copied: axes the mesh lacks,
axes of degree 1 and dimensions the degree does not divide are replicated,
and ZeRO's ``"sharding"`` folds onto ``"dp"``. Only ``"mp"`` slices here:
ZeRO's parameter sharding is a runtime protocol of ``sharding.py``
(``group_sharded_parallel``), pipeline stages are cut by ``pp_spmd`` and
the engine, and expert banks by ``nn.moe`` at ``ep > 1``, so a ``"dp"``,
``"pp"`` or ``"ep"`` entry keeps the parameter whole here. A parameter may also
carry ``shard_layout = (groups, unit)``: the dimension is ``groups`` equal
blocks, each split across the ranks in whole ``unit``\\ s (the fused QKV
projection of a GPT is 3 blocks, q, k and v, split by heads).

``enable(mesh)`` / ``disable()`` / ``current_mesh()`` / ``spmd_guard``
keep the mesh :func:`shard_model` uses by default; ``fleet.init`` enables
its topology's.

:func:`serving_mesh` is the serving engine's topology: one ``("mp",)``
axis over every rank of the process group (serving has no data-parallel
axis), a :class:`ServingMesh` that :func:`shard_model` takes like a hybrid
group. Besides the mp group its collectives run on, it holds a gloo group
over the same ranks for host messages: the leader (rank 0) of a mesh
engine sends each call to its followers there (``serving.mesh``).
"""
from __future__ import annotations

import datetime

import torch

from . import collective, parallel_env

__all__ = ["enable", "disable", "enabled", "current_mesh", "spmd_guard",
           "param_pspec", "shard_model", "shard_batch", "local_shard",
           "merge_shards", "serving_mesh", "ServingMesh"]

# how long a follower of a mesh engine waits for its leader's next call
# (the control group's collective timeout): a server may idle for hours
CONTROL_TIMEOUT_S = 7 * 24 * 3600.0

_state = {"mesh": None}


def enable(mesh):
    """Make ``mesh`` (a ``fleet.HybridCommunicateGroup``) the current
    one."""
    _state["mesh"] = mesh
    return mesh


def disable():
    _state["mesh"] = None


def current_mesh():
    return _state["mesh"]


def enabled():
    return _state["mesh"] is not None


class spmd_guard:
    """``with spmd_guard(mesh):`` scopes :func:`enable`."""

    def __init__(self, mesh):
        self._mesh = mesh

    def __enter__(self):
        self._prev = current_mesh()
        enable(self._mesh)
        return self._mesh

    def __exit__(self, *exc):
        _state["mesh"] = self._prev
        return False


def _axes(mesh):
    """``{axis name: degree}`` of a hybrid group or a ``DeviceMesh``."""
    if hasattr(mesh, "get_model_parallel_world_size"):
        return {"dp": mesh.get_data_parallel_world_size(),
                "pp": mesh.get_pipe_parallel_world_size(),
                "sharding": mesh.get_sharding_parallel_world_size(),
                "ep": mesh.get_expert_parallel_world_size(),
                "mp": mesh.get_model_parallel_world_size()}
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def param_pspec(spec, mesh, shape=None):
    """The placement of a parameter with ``sharding_spec`` ``spec`` on
    ``mesh`` (a hybrid group, a ``DeviceMesh`` or ``{axis: degree}``): a
    tuple with one axis name or None per dimension (``()`` for None)."""
    if spec is None:
        return ()
    axes = _axes(mesh)
    parts = []
    for d, s in enumerate(spec):
        if s == "sharding" and "sharding" not in axes and "dp" in axes:
            s = "dp"
        if s is None or s not in axes or axes[s] <= 1:
            parts.append(None)
            continue
        if shape is not None and d < len(shape) and shape[d] % axes[s] != 0:
            parts.append(None)
            continue
        parts.append(s)
    return tuple(parts)


class ServingMesh:
    """A one-axis ``("mp",)`` mesh of ``mp`` ranks (see
    :func:`serving_mesh`): ``mp_group``, the ``collective.Group`` the
    tensor-parallel collectives run on, and ``control``, a gloo group over
    the same ranks for host messages (None for a mesh of one rank)."""

    mesh_dim_names = ("mp",)

    def __init__(self, mp_group, control=None):
        self.mp_group = mp_group
        self.control = control
        self.shape = (mp_group.nranks,)

    def get_model_parallel_group(self):
        return self.mp_group

    @property
    def rank(self):
        """This process's rank on the mesh."""
        return self.mp_group.rank


def serving_mesh(mp=None, *, model=None, n_head=None):
    """The serving engine's tensor-parallel topology,
    ``GenerationEngine(model, mesh=serving_mesh(2))``: one ``("mp",)``
    axis over the ranks of the process group. Serving has no batch axis to
    shard, so ``mp`` must be the world's size (None: the world); every rank
    calls this (it makes process groups) and then builds the same engine.
    Weights are placed by their ``sharding_spec`` (:func:`shard_model`).

    Pass the model (or its ``n_head``) to check up front that mp divides
    the attention heads: head-sharded decode splits whole heads per
    rank."""
    if n_head is None and model is not None:
        gpt = getattr(model, "gpt", model)
        heads = sorted({int(blk.attn.n_head) for blk in gpt.blocks})
        n_head = heads[0] if heads else None
    world = parallel_env.get_world_size()
    mp = world if mp is None else int(mp)
    if n_head is not None and int(n_head) % mp:
        raise ValueError(
            f"serving_mesh: mp={mp} does not divide the model's "
            f"n_head={int(n_head)} — pick an mp that divides the head "
            "count (head-sharded decode splits whole heads per shard)")
    if mp < 1 or mp > world:
        raise ValueError(f"serving_mesh: mp={mp} outside [1, {world}] "
                         "ranks of the process group")
    if mp != world:
        raise ValueError(
            f"serving_mesh: mp={mp} but the process group has {world} "
            "ranks; serving has no data-parallel axis, so start one "
            "process per rank of the mesh")
    if mp == 1:
        rank = parallel_env.get_rank()
        return ServingMesh(collective.Group([rank], 0, None, axis_name="mp"))
    ranks = list(range(world))
    group = collective.new_group(ranks)
    group.axis = "mp"
    control = collective.new_group(
        ranks, backend="gloo",
        timeout=datetime.timedelta(seconds=CONTROL_TIMEOUT_S))
    return ServingMesh(group, control)


def _mp_group(mesh):
    if hasattr(mesh, "get_model_parallel_group"):
        return mesh.get_model_parallel_group()
    return collective.split_group_mesh(mesh, "mp")


def _splits(size, n, layout):
    groups, unit = layout
    return size % (groups * unit * n) == 0


def local_shard(full, dim, rank, nranks, layout=(1, 1)):
    """Rank ``rank``'s slice of ``full`` along ``dim``: the dimension as
    ``layout[0]`` equal blocks, the ``rank``-th of ``nranks`` chunks of
    each block, concatenated."""
    groups = layout[0]
    block = full.shape[dim] // groups
    chunk = block // nranks
    parts = [full.narrow(dim, g * block + rank * chunk, chunk)
             for g in range(groups)]
    return torch.cat(parts, dim=dim).contiguous()


def merge_shards(shards, dim, layout=(1, 1)):
    """Inverse of :func:`local_shard` over every rank's slice, in rank
    order."""
    groups = layout[0]
    pieces = [torch.chunk(s, groups, dim=dim) for s in shards]
    return torch.cat([pieces[r][g] for g in range(groups)
                      for r in range(len(shards))], dim=dim)


def shard_model(model, mesh=None):
    """Keep this rank's mp slice of every parameter of ``model`` whose
    ``sharding_spec`` places it on ``"mp"`` (in place: ``p.data`` becomes
    the slice, and ``p.mp_shard = (dim, layout, rank, nranks)`` records
    it), and set ``mp_group`` on each module that declares one (an
    mp-aware module) when its parameters were sliced. A module whose
    annotated parameters cannot all be sliced (a dimension the degree does
    not divide in whole units) stays whole; one that would be sliced in
    part raises ``ValueError``. Returns ``model``."""
    mesh = mesh or current_mesh()
    if mesh is None:
        raise RuntimeError("shard_model: no mesh (call fleet.init or "
                           "spmd.enable first)")
    _shard_experts(model, mesh)
    group = _mp_group(mesh)
    n = group.nranks
    if n <= 1:
        return model
    with torch.no_grad():
        for mod in model.modules():
            own = [p for p in mod.parameters(recurse=False)
                   if getattr(p, "sharding_spec", None) is not None
                   and getattr(p, "mp_shard", None) is None]
            plan = []
            for p in own:
                pspec = param_pspec(p.sharding_spec, mesh, tuple(p.shape))
                dims = [d for d, s in enumerate(pspec) if s == "mp"]
                layout = getattr(p, "shard_layout", (1, 1))
                if dims and _splits(p.shape[dims[0]], n, layout):
                    plan.append((p, dims[0], layout))
            if plan and len(plan) != len(own):
                _partial(mod, n)
            for p, dim, layout in plan:
                p.data = local_shard(p.data, dim, group.rank, n, layout)
                p.mp_shard = (dim, layout, group.rank, n)
    for mod in model.modules():
        if not hasattr(mod, "mp_group"):
            continue
        ann = [p for p in mod.parameters()
               if getattr(p, "sharding_spec", None) is not None]
        sliced = [p for p in ann if getattr(p, "mp_shard", None)]
        if sliced and len(sliced) != len(ann):
            _partial(mod, n)
        if sliced:
            mod.mp_group = group
    return model


def _shard_experts(model, mesh):
    """At ``ep > 1``: keep this rank's ``E/ep`` experts of every bank
    annotated ``("ep", ...)`` of each module that declares ``ep_group``
    (``p.ep_shard = (0, rank, ep)``), set the module's ``ep_group`` and
    its gate's ``batch_group``, and mark each bank's gradient to be
    averaged over dp alone (``expert_grad_sync``, see ``parallel``)."""
    if not hasattr(mesh, "get_expert_parallel_group"):
        return
    g = mesh.get_expert_parallel_group()
    n = g.nranks
    if n <= 1:
        return
    dp = mesh.get_data_parallel_group()
    with torch.no_grad():
        for mod in model.modules():
            if not hasattr(mod, "ep_group") or mod.ep_group is not None:
                continue
            for p in mod.parameters(recurse=False):
                spec = getattr(p, "sharding_spec", None)
                if spec and spec[0] == "ep" and \
                        getattr(p, "ep_shard", None) is None:
                    p.data = local_shard(p.data, 0, g.rank, n)
                    p.ep_shard = (0, g.rank, n)
                    p.expert_grad_sync = (dp, n)
            mod.ep_group = g
            mod.gate.batch_group = mesh.get_batch_group()


def _partial(mod, n):
    raise ValueError(
        f"shard_model: {type(mod).__name__} would be sliced in part over "
        f"mp={n}: some of its parameters do not split in whole units")


def shard_batch(data, mesh=None, batch_axis=0):
    """This rank's rows of a batch: chunk ``r`` of ``n`` along
    ``batch_axis``, where ``n`` is the size of the ranks that split a
    batch (dp x sharding x ep) and ``r`` this rank's index among them (the
    whole batch when ``n`` does not divide it)."""
    mesh = mesh or current_mesh()
    if mesh is None:
        raise RuntimeError("shard_batch: no mesh")
    t = torch.as_tensor(data)
    group = mesh.get_batch_group() if hasattr(mesh, "get_batch_group") \
        else mesh.get_data_parallel_group()
    n = t.shape[batch_axis] if t.dim() > batch_axis else 0
    if group.nranks <= 1 or n % group.nranks:
        return t
    return t.narrow(batch_axis, group.rank * (n // group.nranks),
                    n // group.nranks)
