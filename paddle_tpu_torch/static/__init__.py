"""paddle_tpu_torch.static — declarative (static-graph) mode (counterpart
of paddle_tpu/static). See program.py for the recorder and executor.py for
how a Program runs: one CUDA graph per (program, feed signature, fetch
set) on the card."""
import torch

from . import nn  # noqa: F401
from .executor import Executor  # noqa: F401
from .io import (load, load_inference_model, load_program,  # noqa: F401
                 save, save_inference_model)
from .program import (Program, Scope, Variable, data,  # noqa: F401
                      default_main_program, default_startup_program,
                      global_scope, name_scope, program_guard, scope_guard)

__all__ = ["Executor", "Program", "Variable", "Scope", "InputSpec", "data",
           "default_main_program", "default_startup_program",
           "global_scope", "name_scope", "program_guard", "scope_guard",
           "save_inference_model", "load_inference_model", "save", "load",
           "load_program", "append_backward", "cpu_places", "cuda_places",
           "nn"]


class InputSpec:
    """``paddle.static.InputSpec``: a feed's shape (None or -1 for a
    dynamic dimension), dtype and name."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = list(shape)
        self.dtype = dtype
        self.name = name

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(list(tensor.shape), tensor.dtype, name)


def cpu_places(device_count=None):
    return [torch.device("cpu")] * (device_count or 1)


def cuda_places(device_ids=None):
    ids = device_ids if device_ids is not None else \
        range(torch.cuda.device_count())
    return [torch.device("cuda", i) for i in ids]


def append_backward(loss, parameter_list=None, no_grad_set=None):
    """Record a backward request: the Executor computes the gradients of
    ``loss`` and keeps each in the scope as ``<parameter name>@GRAD``.
    Returns ``[(parameter, None)]`` as the reference does."""
    prog = loss.program or default_main_program()
    params = parameter_list or [v for v, _ in prog.params
                                if not v.stop_gradient]
    prog.backward_req = (loss, params)
    return [(p, None) for p in params]
