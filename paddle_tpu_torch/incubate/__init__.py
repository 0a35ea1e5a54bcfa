"""Incubating modules of the port (counterpart of paddle_tpu/incubate/):
the checkpoint engine, and ``incubate.nn``'s fused transformer layers and
``memory_efficient_attention``."""
from . import checkpoint, nn  # noqa: F401

__all__ = ["checkpoint", "nn"]
