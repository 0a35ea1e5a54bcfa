"""Device resolution (counterpart of paddle_tpu/device.py and core/place.py).

The port's entry points run on the GPU. ``device=None`` means "the current
CUDA device"; without a GPU that is an error naming the way out
(``device="cpu"``), never a quiet move to the CPU.
"""
from __future__ import annotations

import contextlib
import gc
import threading

import torch


def resolve_device(device=None) -> torch.device:
    """The ``torch.device`` an entry point should run on.

    ``None`` resolves to the current CUDA device and raises ``RuntimeError``
    when CUDA is unavailable. An explicit ``"cuda"``/``"cuda:N"`` raises the
    same way; ``"cpu"`` is always accepted (the tests run there)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; paddle_tpu_torch runs on the "
                "GPU by default — pass device=\"cpu\" to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is "
                "available; pass device=\"cpu\" to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} "
                         "(expected cuda or cpu)")
    return dev


# One CUDA graph capture at a time in a process: torch registers its
# default CUDA generator with every graph it captures, and two captures at
# once (two engines' first steps on two server threads, as a
# ReplicaSupervisor's replicas take them) corrupt that registry, so that
# freeing the graphs aborts the process. A capture beside another
# thread's replays or eager work is safe. Reentrant: a capture may call
# code that takes it again.
capture_lock = threading.RLock()


@contextlib.contextmanager
def collector_paused():
    """Hold Python's cyclic garbage collector off for the block: wrap a
    CUDA graph's capture in it. Engines and steps sit in reference cycles
    (a step body bound to its owner), so the collector frees their CUDA
    graphs whenever it runs; a graph destroyed while another is being
    captured invalidates that capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()
