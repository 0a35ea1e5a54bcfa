"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference; this package re-implements
it slice by slice on PyTorch for an NVIDIA H100, with every Pallas kernel
of a ported path rewritten by hand for Hopper. Module paths mirror
``paddle_tpu/`` so each module's counterpart is easy to find.

Slice 1 is serving: ``serving.GenerationServer`` ->
``ContinuousBatchScheduler`` -> ``GenerationEngine`` ->
``models.gpt.GPTModel``, whose paged decode step
runs the CUDA paged-attention kernel in ``csrc/paged_attention.cu``.

Entry points run on CUDA unless the caller passes ``device="cpu"``; on a
machine without a GPU they raise instead of falling back to the CPU.

``enable_static()`` switches to declarative mode: ``static`` records torch
calls into a Program that ``static.Executor`` runs as one CUDA graph per
feed signature, and ``inference`` serves what ``static`` and ``jit``
save.
"""
import torch

# the reference runs float32 matmuls at full precision
# (paddle_tpu/__init__.py sets jax_default_matmul_precision="highest"),
# so TF32 stays off for matmuls and convolutions alike
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .device import resolve_device  # noqa: E402
from .framework import (disable_static, enable_static,  # noqa: E402
                        in_dygraph_mode, in_dynamic_mode)
from . import inference, static  # noqa: E402

__all__ = ["resolve_device", "enable_static", "disable_static",
           "in_dynamic_mode", "in_dygraph_mode", "static", "inference"]
