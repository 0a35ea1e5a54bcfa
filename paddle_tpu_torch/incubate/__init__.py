"""Incubating modules of the port (counterpart of paddle_tpu/incubate/):
the checkpoint engine."""
from . import checkpoint  # noqa: F401

__all__ = ["checkpoint"]
