"""``DistributedStrategy`` (counterpart of
paddle_tpu/distributed/fleet/distributed_strategy.py): plain attributes.
Toggles this port does not implement warn when they are turned on."""
from __future__ import annotations

import warnings

__all__ = ["DistributedStrategy"]

_INERT_TOGGLES = {
    "dgc": "deep gradient compression is not implemented",
    "a_sync": "the asynchronous parameter-server mode is not ported",
    "heter_ccl_mode": "heterogeneous collectives are not supported",
}


class DistributedStrategy:
    def __init__(self):
        self.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1, "sharding_degree": 1,
                               "ep_degree": 1}
        self.amp = False
        self.amp_configs = {"init_loss_scaling": 32768.0,
                            "use_pure_fp16": False, "use_bf16": True}
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {"tensor_parallel_degree": 1}
        self.sharding = False
        self.sharding_configs = {"stage": 1, "offload": False}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.lamb = False
        self.lamb_configs = {"lamb_weight_decay": 0.01}
        self.lars = False
        self.lars_configs = {"lars_coeff": 0.001,
                             "lars_weight_decay": 0.0005}
        self.dgc = False
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 4, "begin_step": 1}
        self.fp16_allreduce = False
        self.fp16_allreduce_configs = {"dtype": "float16"}
        self.find_unused_parameters = False
        self.gradient_scale_configs = {"scale_strategy": "avg"}
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.without_graph_optimization = True
        self.heter_ccl_mode = False
        self.a_sync = False
        self.a_sync_configs = {}

    def __setattr__(self, key, value):
        if value and key in _INERT_TOGGLES:
            warnings.warn(
                f"DistributedStrategy.{key} has no effect in this build: "
                f"{_INERT_TOGGLES[key]}", stacklevel=2)
        object.__setattr__(self, key, value)

    def __repr__(self):
        keys = ["hybrid_configs", "amp", "recompute", "sharding", "pipeline"]
        body = ", ".join(f"{k}={getattr(self, k)!r}" for k in keys)
        return f"DistributedStrategy({body})"
