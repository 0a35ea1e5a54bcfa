"""Mixture-of-Experts at fixed shapes (counterpart of paddle_tpu/nn/moe).

Top-k routing with capacity-factor token dropping gives dispatch and
combine masks whose shapes do not depend on the routing, the expert FFN
banks are stacked ``[E, ...]``, and ``metrics`` publishes the expert load
on audit calls.
"""
from . import metrics  # noqa: F401
from .gate import (MoEConfigError, TopKGate, moe_capacity,  # noqa: F401
                   validate_moe_config)
from .layer import MoEMLP  # noqa: F401

__all__ = ["MoEConfigError", "TopKGate", "MoEMLP", "moe_capacity",
           "validate_moe_config", "metrics"]
