"""paddle_tpu_torch.inference — the deployment API (counterpart of
paddle_tpu/inference): ``Config`` -> ``create_predictor`` -> input and
output handles -> ``run``.

A Predictor loads the pair ``static.save_inference_model`` and
``jit.save`` write (a ``torch.export`` graph with a dynamic batch
dimension and its parameters), puts the parameters on its device once,
and on the card runs each input signature as one CUDA graph
(``jit.TrainStep``: the first run of a signature is eager, the second
captures, the later ones copy the inputs in and replay). ``Config``
defaults to the current CUDA device; ``disable_gpu()`` asks for the CPU,
and without a GPU ``create_predictor`` raises unless it was asked.

The knobs that tune the reference's analysis passes (``switch_ir_optim``,
``enable_memory_optim``, ``enable_tensorrt_engine``, ...) are accepted
and do nothing here: each warns once a process, under its own name.
``enable_dist_inference`` takes a degree of 1 on one card; the sharded
form comes with the distributed slice (ROADMAP queue 1 item 7b).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..static.program import unrecorded

__all__ = ["Config", "Predictor", "Tensor", "create_predictor",
           "create_generation_engine", "PrecisionType", "PlaceType",
           "get_version"]

VERSION = "0.17.0"


def get_version():
    return VERSION


class PrecisionType:
    Float32 = 0
    Half = 1
    Bfloat16 = 2
    Int8 = 3


class PlaceType:
    CPU = 0
    GPU = 1
    TPU = 2
    CUSTOM = 3


class Config:
    """``paddle.inference.Config``: ``Config(prog_file, params_file)`` or
    ``Config(prefix)``, the prefix of a ``.pdmodel``/``.pdiparams``
    pair."""

    _warned_noops: set = set()

    def __init__(self, prog_file=None, params_file=None):
        self._prefix, self._params_path = None, params_file
        if prog_file is not None:
            self.set_model(prog_file, params_file)
        self._device = "cuda"
        self._device_id = 0
        self._ir_optim = True
        self._precision = PrecisionType.Float32
        self._dist_degree = 1

    def set_model(self, prog_file, params_file=None):
        self._prefix = prog_file[:-8] if prog_file.endswith(".pdmodel") \
            else prog_file
        self._params_path = params_file

    def model_dir(self):
        return self._prefix

    # -- device ------------------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0,
                       precision=PrecisionType.Float32):
        self._device, self._device_id = "cuda", device_id
        self._precision = precision

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self):
        return self._device == "cuda"

    def gpu_device_id(self):
        return self._device_id

    def _torch_device(self):
        from ..static.executor import place_device

        if self._device == "cpu":
            return place_device("cpu")
        return place_device(f"cuda:{self._device_id}")

    # -- knobs of the reference's analysis passes ----------------------------
    @classmethod
    def _noop_warning(cls, knob):
        if knob in cls._warned_noops:
            return
        cls._warned_noops.add(knob)
        warnings.warn(
            f"paddle_tpu_torch.inference.Config.{knob}() is accepted for "
            "API compatibility but has NO effect on this backend: the "
            "exported graph runs as it is, captured as one CUDA graph per "
            "input signature on the card.", UserWarning, stacklevel=3)

    def set_cpu_math_library_num_threads(self, n):
        self._noop_warning("set_cpu_math_library_num_threads")

    def switch_ir_optim(self, flag=True):
        self._noop_warning("switch_ir_optim")
        self._ir_optim = flag

    def ir_optim(self):
        return self._ir_optim

    def enable_memory_optim(self):
        self._noop_warning("enable_memory_optim")

    def switch_use_feed_fetch_ops(self, flag):
        self._noop_warning("switch_use_feed_fetch_ops")

    def switch_specify_input_names(self, flag=True):
        self._noop_warning("switch_specify_input_names")

    def enable_mkldnn(self):
        self._noop_warning("enable_mkldnn")

    def enable_tensorrt_engine(self, *args, **kwargs):
        self._noop_warning("enable_tensorrt_engine")

    def enable_dist_inference(self, degree=None):
        """``None`` or 1: this card alone. A larger degree shards the batch
        over cards, which comes with the distributed slice (ROADMAP queue
        1 item 7b)."""
        n = 1 if degree is None else int(degree)
        if n != 1:
            raise NotImplementedError(
                f"enable_dist_inference({degree}): inference sharded over "
                f"{n} cards comes with the port's distributed slice "
                "(ROADMAP queue 1 item 7b); one card takes degree 1")
        self._dist_degree = 1

    def dist_inference_degree(self):
        return self._dist_degree

    def summary(self):
        return (f"Config(prefix={self._prefix}, device={self._device}, "
                f"ir_optim={self._ir_optim})")


class Tensor:
    """An input or output handle (reference ZeroCopyTensor)."""

    def __init__(self, name, predictor, is_input):
        self._name, self._pred, self._is_input = name, predictor, is_input

    def name(self):
        return self._name

    def copy_from_cpu(self, data):
        if not self._is_input:
            raise RuntimeError("copy_from_cpu on an output handle")
        self._pred._inputs[self._name] = np.asarray(data)

    def copy_to_cpu(self):
        if self._is_input:
            return self._pred._inputs[self._name]
        return self._pred._outputs[self._name]

    def shape(self):
        store = self._pred._inputs if self._is_input else self._pred._outputs
        a = store.get(self._name)
        return list(a.shape) if a is not None else []

    def reshape(self, shape):
        pass  # shapes come with copy_from_cpu


class Predictor:
    """``paddle.inference.Predictor`` over an exported artifact."""

    def __init__(self, config: Config):
        from ..jit import TrainStep
        from ..static.executor import _Held
        from ..static.io import load_artifact

        self._config = config
        self._device = config._torch_device()
        self._module, self._params, meta = load_artifact(
            config._prefix, self._device, config._params_path)
        self._feed_names = list(meta.get("feed_names") or [])
        self._fetch_names = list(meta.get("fetch_names") or [])
        self._inputs: dict[str, np.ndarray] = {}
        self._outputs: dict[str, np.ndarray] = {}
        self._graph = None
        if self._device.type == "cuda":
            self._graph = TrainStep(
                self._forward, [_Held(self._params, [], self._device)], [])

    def _forward(self, *feeds):
        with torch.no_grad():
            return self._module(tuple(self._params), *feeds)

    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names) or [
            f"out{i}" for i in range(len(self._outputs))]

    def get_input_handle(self, name):
        return Tensor(name, self, is_input=True)

    def get_output_handle(self, name):
        return Tensor(name, self, is_input=False)

    @unrecorded
    def run(self, inputs=None):
        """Run on the staged inputs; with ``inputs`` (arrays in input-name
        order, the reference's ``Run(inputs, &outputs)``) stage those and
        return the outputs as numpy arrays, else return True."""
        from ..static.executor import _to_host

        if inputs is not None:
            for n, a in zip(self._feed_names, inputs):
                self._inputs[n] = np.asarray(a)
        feeds = [torch.from_numpy(np.array(self._inputs[n]))
                 for n in self._feed_names]
        if self._graph is not None:
            outs = self._graph(*feeds)
        else:
            outs = self._forward(*feeds)
        outs = [_to_host(o) for o in outs]
        names = self._fetch_names or [f"out{i}" for i in range(len(outs))]
        self._outputs = dict(zip(names, outs))
        return outs if inputs is not None else True

    def clone(self):
        return Predictor(self._config)

    def try_shrink_memory(self):
        pass


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


def create_generation_engine(model, **engine_options):
    """A live decoder model (GPT) in ``serving.GenerationEngine``: the
    paged KV cache and the decode step captured as a CUDA graph.
    ``engine_options`` go to the engine (``max_batch_size``, ``buckets``,
    ``max_seq_len``, ``block_size``, ``num_blocks``, ``mesh``, ``device``,
    ...)."""
    from ..serving import GenerationEngine

    return GenerationEngine(model, **engine_options)
