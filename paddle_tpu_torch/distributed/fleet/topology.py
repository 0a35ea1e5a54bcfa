"""Hybrid-parallel topology (counterpart of
paddle_tpu/distributed/fleet/topology.py).

``CommunicateTopology`` is the reference's coordinate math, copied: ranks
in row-major order over ``("data", "pipe", "sharding", "model")``.
``HybridCommunicateGroup`` builds one ``torch.distributed`` ``DeviceMesh``
over the world with the dimensions ``("dp", "pp", "sharding", "mp")`` in
that order, so mesh coordinates are topology coordinates, and returns each
dimension's group of this rank as a ``collective.Group``. Unlike the
reference's single controller, which reports rank 0's coordinates, every
process here has its own: ``get_model_parallel_rank()`` is this rank's
index in its mp group.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch.distributed as dist

from .. import collective
from .. import parallel_env

__all__ = ["CommunicateTopology", "HybridCommunicateGroup"]


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "model"),
                 dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = list(itertools.product(
            *[range(d) for d in self._dims]))
        self._coord2rank = {c: i for i, c in enumerate(self.coordinate)}
        self._rank2coord = {i: c for i, c in enumerate(self.coordinate)}

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return int(np.prod(self._dims))

    def get_rank(self, **args):
        key = tuple(args[name] for name in self._parallel_names)
        return self._coord2rank[key]

    def get_coord(self, rank):
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name, index):
        """Every rank whose coordinate on ``axis_name`` is ``index``."""
        axis = self._parallel_names.index(axis_name)
        return [r for c, r in self._coord2rank.items() if c[axis] == index]

    def get_comm_list(self, axis_name):
        """The groups of ranks that differ only along ``axis_name``."""
        axis = self._parallel_names.index(axis_name)
        other_axes = [i for i in range(len(self._dims)) if i != axis]
        comm_list = []
        for other in itertools.product(*[range(self._dims[i])
                                         for i in other_axes]):
            ranks = []
            for v in range(self._dims[axis]):
                coord = list(other)
                coord.insert(axis, v)
                ranks.append(self._coord2rank[tuple(coord)])
            comm_list.append(ranks)
        return comm_list

    def get_rank_from_stage(self, global_rank, **kwargs):
        coord = self.get_coord(global_rank)
        tf = dict(zip(self._parallel_names, coord))
        tf.update(kwargs)
        return self.get_rank(**tf)


class HybridCommunicateGroup:
    """The dp, pp, sharding and mp groups of this rank over one
    ``DeviceMesh`` (axis names: data -> "dp", pipe -> "pp", sharding ->
    "sharding", model -> "mp"). The topology's size must be the world's.
    Pipeline and expert degrees above 1 raise ``NotImplementedError``
    (ROADMAP queue 1 item 7)."""

    AXES = ("dp", "pp", "sharding", "mp")

    def __init__(self, topology: CommunicateTopology):
        self._topo = topology
        self.nranks = topology.world_size()
        self._dp_degree = topology.get_dim("data")
        self._pp_degree = topology.get_dim("pipe")
        self._sharding_degree = topology.get_dim("sharding")
        self._mp_degree = topology.get_dim("model")
        names = topology.get_hybrid_group_names()
        self._ep_degree = (topology.get_dim("expert")
                           if "expert" in names else 1)
        for what, deg in (("pipeline", self._pp_degree),
                          ("expert", self._ep_degree)):
            if deg > 1:
                raise NotImplementedError(
                    f"{what} parallelism (degree {deg}) is not ported yet "
                    "(ROADMAP queue 1 item 7)")
        world = parallel_env.get_world_size()
        if world != self.nranks:
            raise RuntimeError(
                f"the hybrid topology has {self.nranks} ranks but the world "
                f"has {world} processes")
        self.global_rank = parallel_env.get_rank()
        dims = (self._dp_degree, self._pp_degree, self._sharding_degree,
                self._mp_degree)
        if dist.is_initialized():
            from torch.distributed.device_mesh import init_device_mesh

            dev = parallel_env.device()
            self.mesh = init_device_mesh(
                dev.type if dev is not None else "cpu", dims,
                mesh_dim_names=self.AXES)
            groups = {a: collective.split_group_mesh(self.mesh, a)
                      for a in self.AXES}
        else:  # one process: every group is this process alone
            self.mesh = None
            groups = {a: collective.Group([self.global_rank], 0, None,
                                          axis_name=a)
                      for a in self.AXES}
        collective.set_axis_groups(groups)
        self._groups = groups
        coord = dict(zip(self.AXES, topology.get_coord(self.global_rank)))
        self._coord = coord

    # -- degrees -----------------------------------------------------------
    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_expert_parallel_world_size(self):
        return self._ep_degree

    # -- this rank's coordinates ---------------------------------------------
    def get_data_parallel_rank(self):
        return self._coord["dp"]

    def get_model_parallel_rank(self):
        return self._coord["mp"]

    def get_stage_id(self):
        return self._coord["pp"]

    def get_sharding_parallel_rank(self):
        return self._coord["sharding"]

    def get_expert_parallel_rank(self):
        return 0

    # -- groups --------------------------------------------------------------
    def get_data_parallel_group(self):
        return self._groups["dp"]

    def get_model_parallel_group(self):
        return self._groups["mp"]

    def get_pipe_parallel_group(self):
        return self._groups["pp"]

    def get_sharding_parallel_group(self):
        return self._groups["sharding"]

    def get_expert_parallel_group(self):
        return None

    def get_check_parallel_group(self, sharding=False):
        return collective.get_group(0)

    def get_p2p_groups(self):
        return None

    def topology(self):
        return self._topo

    def get_parallel_mode(self):
        if self._mp_degree == 1 and self._pp_degree == 1 and \
                self._sharding_degree == 1 and self._dp_degree > 1:
            return "data_parallel"
        if self._mp_degree > 1 or self._pp_degree > 1 or \
                self._sharding_degree > 1:
            return "hybrid_parallel"
        return "single"
