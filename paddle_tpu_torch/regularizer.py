"""``paddle_tpu_torch.regularizer`` (counterpart of paddle_tpu/regularizer.py):
the optimizer's decay classes under the reference's top-level name."""
from .optimizer.regularizer import L1Decay, L2Decay  # noqa: F401

__all__ = ["L1Decay", "L2Decay"]
