"""Test support for the port (counterpart of paddle_tpu/testing/):
``faults`` is the deterministic fault-injection harness."""
from . import faults  # noqa: F401
