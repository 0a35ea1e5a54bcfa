"""Hybrid-parallel topology (counterpart of
paddle_tpu/distributed/fleet/topology.py).

``CommunicateTopology`` is the reference's coordinate math, copied: ranks
in row-major order over ``("data", "pipe", "sharding", "model")``, or
``("data", "pipe", "sharding", "expert", "model")`` with an expert
dimension (MoE expert parallelism). ``HybridCommunicateGroup`` builds one
``torch.distributed`` ``DeviceMesh`` over the world with the dimensions
``("dp", "pp", "sharding", "mp")`` (``"ep"`` before ``"mp"`` when the
topology has an expert dimension) in that order, so mesh coordinates are
topology coordinates, and returns each dimension's group of this rank as a
``collective.Group``. Unlike the reference's single controller, which
reports rank 0's coordinates, every process here has its own:
``get_model_parallel_rank()`` is this rank's index in its mp group.

It also makes the joint groups the port's data paths reduce over, named
by tuples of axes in ``collective``'s table: ``("dp", "sharding")`` (the
ZeRO ranks are data-parallel ranks too), ``("dp", "ep")`` (the expert
ranks are data-parallel for the dense trunk) and ``("dp", "sharding",
"ep")``, the ranks that split a batch (``get_batch_group()``).
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
    """The dp, pp, sharding, ep and mp groups of this rank over one
    ``DeviceMesh`` (axis names: data -> "dp", pipe -> "pp", sharding ->
    "sharding", expert -> "ep", model -> "mp"), and the joint groups of
    the module's docstring. The topology's size must be the world's."""

    AXIS_MAP = {"data": "dp", "pipe": "pp", "sharding": "sharding",
                "expert": "ep", "model": "mp"}
    JOINT = (("dp", "sharding"), ("dp", "ep"), ("dp", "sharding", "ep"))

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
        self.axes = tuple(self.AXIS_MAP[n] for n in names)
        self._topo_name = dict(zip(self.axes, names))
        world = parallel_env.get_world_size()
        if world != self.nranks:
            raise RuntimeError(
                f"the hybrid topology has {self.nranks} ranks but the world "
                f"has {world} processes")
        self.global_rank = parallel_env.get_rank()
        dims = tuple(topology.get_dim(n) for n in names)
        if dist.is_initialized():
            from torch.distributed.device_mesh import init_device_mesh

            dev = parallel_env.device()
            self.mesh = init_device_mesh(
                dev.type if dev is not None else "cpu", dims,
                mesh_dim_names=self.axes)
            groups = {a: collective.split_group_mesh(self.mesh, a)
                      for a in self.axes}
        else:  # one process: every group is this process alone
            self.mesh = None
            groups = {a: collective.Group([self.global_rank], 0, None,
                                          axis_name=a)
                      for a in self.axes}
        if "ep" not in groups:
            groups["ep"] = collective.Group([self.global_rank], 0, None,
                                            axis_name="ep")
        for joint in self.JOINT:
            groups[joint] = self._joint_group(joint, groups)
        collective.set_axis_groups(groups)
        self._groups = groups
        coord = dict(zip(self.axes, topology.get_coord(self.global_rank)))
        coord.setdefault("ep", 0)
        self._coord = coord

    def _joint_group(self, joint, groups):
        """The group of ranks that differ only along the axes ``joint``
        (every rank makes every such group, in one order, as torch
        requires); a single axis's group when only one of them is above
        degree 1, and a group of this rank alone when none is."""
        live = [a for a in joint if a in self.axes
                and self._topo.get_dim(self._topo_name[a]) > 1]
        if len(live) <= 1:
            return groups[live[0]] if live else collective.Group(
                [self.global_rank], 0, None, axis_name="x".join(joint))
        idx = [self.axes.index(a) for a in live]
        buckets = {}
        for r in range(self.nranks):
            c = self._topo.get_coord(r)
            key = tuple(v for i, v in enumerate(c) if i not in idx)
            buckets.setdefault(key, []).append(r)
        mine = None
        for key in sorted(buckets):
            g = collective.new_group(buckets[key])
            if self.global_rank in g.ranks:
                mine = g
        mine.axis = "x".join(live)
        return mine

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
        return self._coord["ep"]

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
        return self._groups["ep"]

    def get_batch_group(self):
        """The ranks that split a batch between them: dp x sharding x ep
        (a group of this rank alone when all three are 1)."""
        return self._groups[("dp", "sharding", "ep")]

    def get_check_parallel_group(self, sharding=False):
        return collective.get_group(0)

    def get_p2p_groups(self):
        return None

    def topology(self):
        return self._topo

    def get_parallel_mode(self):
        if self._mp_degree == 1 and self._pp_degree == 1 and \
                self._sharding_degree == 1 and self._ep_degree == 1 and \
                self._dp_degree > 1:
            return "data_parallel"
        if self._mp_degree > 1 or self._pp_degree > 1 or \
                self._sharding_degree > 1 or self._ep_degree > 1:
            return "hybrid_parallel"
        return "single"
