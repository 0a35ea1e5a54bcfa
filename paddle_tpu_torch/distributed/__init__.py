"""Distributed training of the port (counterpart of paddle_tpu/distributed),
one process per rank over ``torch.distributed``: the process group
(``parallel_env``), the collectives (``collective``), data parallelism
(``parallel.DataParallel``), the rendezvous store (``store.TCPStore``),
``fleet`` (the hybrid topology, ``distributed_model``, metrics,
``utils.recompute``), the tensor-parallel layers (``meta_parallel``) and
the placement of a model on the mesh (``spmd``), pipeline parallelism
(``pp_spmd``, ``fleet.HybridParallelEngine``, ``meta_parallel.pp_layers``)
and ZeRO (``sharding``); expert parallelism is ``nn.moe``'s over the fleet's
expert group. The steps are eager: the captured multi-rank step waits for
ROADMAP queue 1 item 7b."""
from . import collective  # noqa: F401
from . import fleet  # noqa: F401
from . import meta_parallel  # noqa: F401
from . import spmd  # noqa: F401
from .collective import (Group, ReduceOp, all_gather, all_reduce,  # noqa: F401
                         all_to_all, alltoall, broadcast, get_group,
                         new_group, recv, reduce, reduce_scatter, scatter,
                         send, wait)
from .parallel import DataParallel  # noqa: F401
from .parallel_env import (ParallelEnv, barrier, get_rank,  # noqa: F401
                           get_world_size, init_parallel_env, is_initialized)
from .sharding import (group_sharded_parallel,  # noqa: F401
                       save_group_sharded_model)
