"""``device.collector_paused``, the guard around every CUDA graph capture
of the port (``jit.TrainStep``, ``serving.engine.StepGraph``): Python's
cyclic collector stays off inside it, so no CUDA graph left in a
reference cycle is destroyed while another graph is being captured (that
invalidates the capture: the recompute-policy card tests failed so), and
the collector's state before the block comes back after it, on an error
too. The captures themselves run on the card (``tests/test_torch_cuda.py``).
"""
import gc

import pytest
import torch

from paddle_tpu_torch.device import collector_paused

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)


@pytest.mark.parametrize("enabled", [True, False])
def test_collector_paused_holds_the_collector_off_and_restores_it(enabled):
    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        with collector_paused():
            assert not gc.isenabled()
        assert gc.isenabled() == enabled
        with pytest.raises(RuntimeError), collector_paused():
            raise RuntimeError("a failed capture")
        assert gc.isenabled() == enabled
    finally:
        (gc.enable if was else gc.disable)()
