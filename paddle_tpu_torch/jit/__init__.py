"""The whole training step as one CUDA graph (counterpart of paddle_tpu/jit's
``TrainStep``, which traces forward, backward and the optimizer into one
XLA program).

On a CUDA model, per input signature (each tensor argument's shape and
dtype, each other argument's value):

1. the first call runs ``step_fn`` eagerly on a side stream: it makes the
   optimizers' slots and device scalars, as the reference's ``_build``
   does, and is the warm-up that capture needs;
2. the next call copies its arguments into static buffers, captures
   ``step_fn`` into a CUDA graph (``torch.cuda.graph``; capture records the
   step and does not run it), then replays it;
3. every later call copies its arguments into the static buffers, writes
   each optimizer's ``get_lr()`` and ``_opt_step + 1`` into its device
   scalars (copies, not kernels), replays the graph, advances
   ``_opt_step`` by one, and returns a copy of the outputs: the next
   replay overwrites the graph's own.

What runs at capture and nothing later: ``step_fn``'s Python. Its tensor
work is recorded; its Python state (a scheduler stepped inside it, a list
appended to, a print) runs once, at capture, as under the reference's
trace. Step a scheduler between calls instead: the rate it gives is read
before every replay, so it takes effect there (the reference bakes the
first rate into its program, ROADMAP.md queue 3). A ``step_fn`` that waits
for the host (``float(loss)``, ``.item()``, a Python branch on a tensor)
cannot be captured. The first call of each signature runs under torch's
sync debug mode ("error"), so such a read raises there, before anything is
captured (a failed capture would leave the stream unusable for the rest of
the process): the call raises and names the cause, the step stops at the
read, and it is never run eagerly in the graph's place. An
``nn.Embedding(sparse=True)`` takes the dense gradient path in the step's
eager call and under its capture (a row-wise update needs its row count
on the host), and on the CPU alike, as the reference's traced step does;
where the reference falls back silently, building the step records a
``kernel_fallback`` event naming the modules. An eager loop (``step_fn``
called directly) keeps the sparse rows and lazy updates. A step whose
models communicate through a gloo process group on CUDA tensors is
refused when it is built: a gloo collective waits on the host, which a
CUDA graph cannot capture (NCCL, one card per rank, can).

Graphs are kept per signature and share one memory pool; a capture holds
``device.capture_lock`` (one capture at a time in a process). The signature
also covers the storage of every parameter, buffer, gradient, optimizer
slot and scalar: a restore that rebinds storage (``p.data = ...``, a slot
replaced) makes the next call capture again instead of replaying stale
addresses; an in-place restore (``set_state_dict``, ``load_state_dict``,
``incubate.checkpoint.restore_training_state``) keeps the graphs. The
``mutate_signature`` fault point fires at this check (``mode=aval``
perturbs a recorded argument shape, so the check captures again;
``mode=scalar`` finds nothing pinned and does nothing). Every
``torch.Generator`` on the card held by a module of the models (a GPT's
dropout stream) is registered with each graph, so each replay draws new
masks and the generator's state between calls is its true state. Before
each replay torch writes the seed and the offset of every generator the
step drew from into the graph's copies of them: two ``fill_`` kernels
launched from the host a replay (BERT's dropout stream); a step that
draws nothing (ResNet, GPT without dropout) launches none.

Counters (registry scope ``jit``): ``train_step_captures``,
``train_step_replays``, ``train_step_eager``. The kernel wrappers'
``kernels`` counters count eager launches only (a wrapper called while a
graph captures records its kernel and counts nothing, and a replay
launches from the card): the card's own tally
(``ops.flash_attention.device_launches``) counts every launch. On the CPU
the step runs eagerly every call, the same update code.
"""
from __future__ import annotations

import contextlib
import itertools

import numpy as np
import torch

from ..device import capture_lock, collector_paused
from ..profiler import explainer as _explain
from ..profiler import registry as _registry
from ..testing import faults as _faults

__all__ = ["TrainStep", "save", "load", "TranslatedLayer"]

_counters = _registry.scoped_counters("jit", {
    "train_step_captures": 0, "train_step_replays": 0,
    "train_step_eager": 0})


_REFUSED = ("TrainStep: step_fn could not be captured as a CUDA graph "
            "({}). A step that waits for the host (float(loss), .item(), a "
            "Python branch on a tensor, printing one) cannot be replayed; "
            "TrainStep does not run it eagerly instead: move the read out "
            "of step_fn, onto the returned outputs")


def _as_tensor(a):
    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a


def _aval(a):
    if isinstance(a, torch.Tensor):
        return (tuple(a.shape), a.dtype)
    return ("value", a)


def _detached(out):
    if isinstance(out, torch.Tensor):
        return out.detach().clone()
    if isinstance(out, (tuple, list)):
        return type(out)(_detached(o) for o in out)
    return out


class _Graph:
    """One captured step: its signature, static inputs, graph, outputs."""

    def __init__(self, avals, static, graph, out):
        self.avals, self.static, self.graph, self.out = \
            avals, static, graph, out


class TrainStep:
    """``step = TrainStep(step_fn, models, optimizers)``; ``loss =
    step(tokens, labels)``.

    ``step_fn`` runs ordinary eager code: forward, ``loss.backward()``,
    ``opt.step()``, ``opt.clear_grad()``, and returns the loss (or a tuple
    of tensors). Arguments that are numpy arrays or tensors elsewhere go to
    the device of the first model's first parameter (or buffer). Each call
    must advance every optimizer's step count exactly once (one
    ``opt.step()``): a ``step_fn`` that steps an optimizer twice, or not at
    all, raises ``RuntimeError``. (The
    reference's ``TrainStep`` advances the count once itself and once more
    inside ``opt.step()``, so its Adam bias correction runs at t = 2, 4, 6,
    ...; the port follows the eager loop instead.)"""

    def __init__(self, fn, models, optimizers):
        self._fn = fn
        self._models = list(models) if isinstance(models, (list, tuple)) \
            else [models]
        self._opts = list(optimizers) if isinstance(optimizers,
                                                    (list, tuple)) \
            else [optimizers]
        first = self._models[0]
        self._device = next(itertools.chain(first.parameters(),
                                            first.buffers())).device
        if self._device.type == "cuda":
            self._refuse_gloo()
        named = [(name or type(mod).__name__, mod) for m in self._models
                 for name, mod in m.named_modules()
                 if isinstance(mod, torch.nn.Embedding) and mod.sparse]
        self._sparse = [mod for _, mod in named]
        if named:
            _explain.record(
                "kernel_fallback", op="nn.Embedding(sparse=True)",
                why="a sparse gradient's row-wise update needs its row count "
                    "on the host, which a CUDA graph cannot read: TrainStep "
                    "takes the dense gradient path",
                modules=[n for n, _ in named])
        self._graphs: dict = {}   # signature -> _Graph
        self._warm: set = set()   # signatures that ran their eager call
        self._storage = None      # the storage the graphs were taken over
        self._pool = None         # the graphs' shared memory pool
        self._side = None

    def _refuse_gloo(self):
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            return
        groups = [g for m in self._models for mod in m.modules()
                  for g in (getattr(mod, "mp_group", None),
                            getattr(getattr(mod, "_grad_sync", None),
                                    "group", None))
                  if g is not None]
        if dist.get_world_size() > 1:
            groups.append(None)  # the default group
        for g in groups:
            pg = None if g is None else g.process_group
            if (g is None or g.nranks > 1) and \
                    dist.get_backend(pg) == "gloo":
                raise ValueError(
                    "TrainStep: the models' process group uses the gloo "
                    "backend on CUDA tensors; a gloo collective blocks the "
                    "host and cannot be captured in a CUDA graph, and "
                    "TrainStep does not run the step eagerly instead. Use "
                    "NCCL (one card per rank), or call step_fn in an eager "
                    "loop")

    @contextlib.contextmanager
    def _dense_embeddings(self):
        """The sparse embeddings take the dense gradient path meanwhile."""
        for mod in self._sparse:
            mod.sparse = False
        try:
            yield
        finally:
            for mod in self._sparse:
                mod.sparse = True

    @property
    def step_fn(self):
        """The wrapped ``step_fn``: called directly, one eager step."""
        return self._fn

    # -- helpers --------------------------------------------------------------
    def _checked(self, run):
        before = [o._opt_step for o in self._opts]
        out = run()
        for o, s in zip(self._opts, before):
            if o._opt_step != s + 1:
                raise RuntimeError(
                    f"TrainStep: an optimizer's step count went from {s} to "
                    f"{o._opt_step} in one call; step_fn must call "
                    "opt.step() exactly once")
        return out

    def _eager(self, args):
        _counters["train_step_eager"] += 1
        args = [a.to(self._device, non_blocking=True)
                if isinstance(a, torch.Tensor) else a for a in args]
        return self._checked(lambda: self._fn(*args))

    def _generators(self):
        gens = {}
        for m in self._models:
            for mod in m.modules():
                for v in vars(mod).values():
                    if isinstance(v, torch.Generator) and \
                            v.device.type == "cuda":
                        gens[id(v)] = v
        return list(gens.values())

    def _storage_key(self):
        """Where every tensor the graph reads or writes lives."""
        ptrs = []
        for m in self._models:
            for t in m.parameters():
                ptrs.append(t.data_ptr())
                ptrs.append(t.grad.data_ptr() if t.grad is not None else 0)
            ptrs.extend(t.data_ptr() for t in m.buffers())
        for o in self._opts:
            ptrs.extend(p.data_ptr() for p in o._parameter_list
                        if p is not None)
            ptrs.append(o._scalars.data_ptr())
            for name in sorted(o._accumulators):
                store = o._accumulators[name]
                ptrs.extend(store[i].data_ptr() for i in sorted(store))
        return tuple(ptrs)

    @staticmethod
    def _stage(static, a):
        if a.device.type == "cpu" and not a.is_pinned():
            a = a.pin_memory()
        static.copy_(a, non_blocking=True)

    # -- the call -------------------------------------------------------------
    def __call__(self, *args):
        args = [_as_tensor(a) for a in args]
        if self._device.type != "cuda":
            with self._dense_embeddings():
                return self._eager(args)
        avals = tuple(_aval(a) for a in args)
        if avals not in self._warm:
            out = self._warm_up(args)
            self._warm.add(avals)
            return out
        for o in self._opts:
            o._ensure_accumulators()
        storage = self._storage_key()
        if storage != self._storage:
            # graphs over other addresses must never replay again; their
            # pool goes with them, so the next capture takes a new one
            self._graphs.clear()
            self._pool = None
            self._storage = storage
        graph = self._graphs.get(avals)
        if graph is not None and _faults.ACTIVE and \
                _faults.fire("mutate_signature"):
            self._perturb(graph)
        if graph is None or graph.avals != avals:
            graph = self._graphs[avals] = self._capture(args, avals)
        return self._replay(graph, args)

    def _warm_up(self, args):
        """The eager call of a new signature, on a side stream (the
        warm-up torch's whole-network capture asks for), under sync debug
        mode "error": a step that waits for the host raises here, where
        nothing is being captured."""
        if self._side is None:
            self._side = torch.cuda.Stream(self._device)
        main = torch.cuda.current_stream(self._device)
        self._side.wait_stream(main)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(self._side), self._dense_embeddings():
                out = self._eager(args)
        except RuntimeError as e:
            if "synchronizing CUDA operation" not in str(e):
                raise
            raise RuntimeError(_REFUSED.format(
                f"its first call waited for the card and stopped there: "
                f"{e}")) from e
        finally:
            torch.cuda.set_sync_debug_mode(mode)
            main.wait_stream(self._side)
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(main)
        return out

    def _perturb(self, graph):
        if _faults.spec().get("mutate_signature", {}).get(
                "mode", "scalar") != "aval":
            return  # nothing is pinned in a CUDA graph's signature
        for j, av in enumerate(graph.avals):
            if av[0] != "value":
                bad = (tuple(d + 1 for d in av[0]) or (1,), av[1])
                graph.avals = graph.avals[:j] + (bad,) + graph.avals[j + 1:]
                return

    def _capture(self, args, avals):
        static = [torch.empty(a.shape, dtype=a.dtype, device=self._device)
                  if isinstance(a, torch.Tensor) else a for a in args]
        for s, a in zip(static, args):
            if isinstance(a, torch.Tensor):
                self._stage(s, a)
        graph = torch.cuda.CUDAGraph()
        for gen in self._generators():
            graph.register_generator_state(gen)
        steps = [o._opt_step for o in self._opts]
        try:
            with capture_lock, collector_paused(), \
                    torch.cuda.graph(graph, pool=self._pool), \
                    self._dense_embeddings():
                out = self._checked(lambda: self._fn(*static))
        except Exception as e:
            if "step count" in str(e):
                raise
            raise RuntimeError(_REFUSED.format(
                f"{type(e).__name__}: {e}")) from e
        finally:
            for o, s in zip(self._opts, steps):
                o._opt_step = s
        self._pool = graph.pool()
        _counters["train_step_captures"] += 1
        return _Graph(avals, static, graph, out)

    def _replay(self, graph, args):
        for s, a in zip(graph.static, args):
            if isinstance(a, torch.Tensor):
                self._stage(s, a)
        for o in self._opts:
            o._write_scalars(o.get_lr(), o._opt_step + 1)
        graph.graph.replay()
        for o in self._opts:
            o._opt_step += 1
        _counters["train_step_replays"] += 1
        return _detached(graph.out)


# -- save / load: the inference artifact --------------------------------------

class _LayerForward(torch.nn.Module):
    """``layer``'s forward with its state passed in (what ``save``
    exports); the layer is held outside the module's own state."""

    def __init__(self, layer, names):
        super().__init__()
        self._layer, self._names = (layer,), names

    def forward(self, params, *args):
        out = torch.func.functional_call(
            self._layer[0], dict(zip(self._names, params)), args)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def save(layer, path, input_spec=None, **configs):
    """``paddle.jit.save``: ``layer``'s forward exported with
    ``torch.export`` (a ``Dim`` for each None/-1 of ``input_spec``, so one
    artifact serves any batch) in ``path.pdmodel``, its parameters and
    buffers as numpy arrays in ``path.pdiparams``: the pair
    ``paddle_tpu_torch.inference`` and :func:`load` read (the format of
    ``static.save_inference_model``)."""
    from ..static.io import _write_artifact, export_artifact
    from ..static.program import convert_dtype, recording_suspended

    if input_spec is None:
        raise ValueError("jit.save requires input_spec")
    with recording_suspended():
        state = dict(layer.named_parameters())
        state.update(layer.named_buffers())
        names = list(state)
        params = [state[n].detach() for n in names]
        device = params[0].device if params else torch.device("cpu")
        shapes = [[-1 if s is None else int(s) for s in spec.shape]
                  for spec in input_spec]
        dtypes = [convert_dtype(getattr(spec, "dtype", "float32"))
                  for spec in input_spec]
        exported = export_artifact(_LayerForward(layer, names), params,
                                   shapes, dtypes, device)
        _write_artifact(path, exported, params, {
            "names": names,
            "feed_names": [getattr(s, "name", None) or f"x{i}"
                           for i, s in enumerate(input_spec)],
            "kind": "jit_save", "device": str(device)})


class TranslatedLayer(torch.nn.Module):
    """What :func:`load` returns (reference translated_layer.py): calling
    it runs the exported forward over the loaded parameters."""

    def __init__(self, module, params):
        super().__init__()
        self._module, self._params = module, params
        self.device = params[0].device if params else torch.device("cpu")

    def forward(self, *args):
        args = [torch.as_tensor(a).to(self.device) for a in args]
        with torch.no_grad():
            outs = self._module(tuple(self._params), *args)
        return outs[0] if len(outs) == 1 else tuple(outs)


def load(path, device=None, **configs):
    """Load a :func:`save` (or ``static.save_inference_model``) artifact
    as a :class:`TranslatedLayer` on ``device`` (the current CUDA device
    unless ``"cpu"`` is asked for)."""
    from ..static.executor import place_device
    from ..static.io import load_artifact

    module, params, _ = load_artifact(path, place_device(device))
    return TranslatedLayer(module, params)
