"""Static-graph save and load (counterpart of paddle_tpu/static/io.py).

Two kinds of file pair share the reference's suffixes:

- ``save`` / ``load`` / ``load_program``: a training Program (its record,
  its ``minimize`` requests with their optimizers' settings) in
  ``<prefix>.pdmodel``, its parameters by name in ``.pdparams`` and each
  optimizer's state in ``.pdopt``, so that a run loads and continues.
  The record pickles the functions it calls by reference, as the
  reference's cloudpickle does: load only files from a source you trust.
- ``save_inference_model`` / ``load_inference_model``: the forward from
  the feeds to the fetches, exported with ``torch.export`` with a
  ``torch.export.Dim`` for each dynamic feed dimension, so that one
  artifact serves any batch (the reference exports StableHLO with
  symbolic batch dimensions, ``io.py:140-187``). The parameters are inputs
  of the exported graph and live in ``.pdiparams``: numpy arrays in the
  reference's pickle keys (``arrays``, ``feed_names``, ``fetch_names``,
  ``kind``), plus ``dtypes`` and ``device``.

Either ``.pdmodel`` starts with a header of this package; a file of the
reference (its cloudpickled Program, its StableHLO) or of anything else is
refused with the format named. The exported graph is tied to the device
it was exported on: a model's constants are there, and each dispatcher's
route was chosen there (``flash_attention`` on CPU tensors is the plain
attention, on CUDA tensors K1). So an artifact loads only on a device of
the type it was exported on; another is refused, naming the fix (export
it again there), and is never moved with the route it had.
"""
from __future__ import annotations

import copy
import io as _io
import os
import pickle

import numpy as np
import torch
from torch import nn

from . import program as prog_mod
from .executor import Replay, _to_host, place_device
from .program import (OpRecord, Program, SymDim, Variable, global_scope,
                      resolve_alias)

__all__ = ["save_inference_model", "load_inference_model", "save", "load",
           "load_program", "export_artifact", "load_artifact"]

PROGRAM_MAGIC = b"#PADDLE_TPU_TORCH_PROGRAM_V1\n"
EXPORT_MAGIC = b"#PADDLE_TPU_TORCH_EXPORT_V1\n"
_REFERENCE_MAGIC = b"#PADDLE_TPU_PROGRAM_V1\n"


def _read_model(path, magic, what):
    with open(path, "rb") as f:
        blob = f.read()
    if blob.startswith(magic):
        return blob[len(magic):]
    if blob.startswith(_REFERENCE_MAGIC):
        found = "a training Program of paddle_tpu (the JAX package)"
    elif blob.startswith(PROGRAM_MAGIC):
        found = "a training Program of paddle_tpu_torch (static.save)"
    elif blob.startswith(EXPORT_MAGIC):
        found = ("an inference artifact of paddle_tpu_torch "
                 "(save_inference_model / jit.save)")
    else:
        found = ("not a paddle_tpu_torch file (a StableHLO artifact of "
                 "paddle_tpu, the JAX package, or a PaddlePaddle "
                 "ProgramDesc?)")
    raise ValueError(f"{path} is {found}; {what} reads only "
                     f"paddle_tpu_torch's {magic.strip().decode()} format")


# -- training Programs --------------------------------------------------------

class _VarRef:
    __slots__ = ("vid",)

    def __init__(self, vid):
        self.vid = vid


class _SymRef:
    __slots__ = ("vid", "a", "b")

    def __init__(self, vid, a, b):
        self.vid, self.a, self.b = vid, a, b


def _optimizer_settings(opt, program):
    """A copy of ``opt`` without tensors: its settings and schedule. It
    binds to the loaded Program's parameters by name."""
    blank = copy.copy(opt)
    for k, v in list(vars(blank).items()):
        if isinstance(v, torch.Tensor):
            setattr(blank, k, None)
    blank._parameter_list, blank._parameter_names = [], []
    blank._accumulators, blank._cache, blank._scalars = {}, {}, None
    ids = {id(init): pv.name for pv, init in program.params}
    scope_ids = {id(global_scope().vars.get(pv.name)): pv.name
                 for pv, _ in program.params}
    blank._static_param_names = None if opt._static_unbound else [
        ids.get(id(p)) or scope_ids.get(id(p)) for p in opt._parameter_list]
    blank._static_unbound = True
    return blank


def _encode_program(program):
    vars_ = {}

    def enc(x):
        if isinstance(x, Variable):
            x = resolve_alias(x)
            vars_[x.vid] = (x.name, tuple(x._ma.shape), tuple(x._mb.shape),
                            x._ma.dtype, x.is_param, x.stop_gradient)
            return _VarRef(x.vid)
        if isinstance(x, SymDim):
            return _SymRef(x.vid, x._a, x._b)
        if isinstance(x, torch.Tensor):
            return x.detach().cpu()
        return x

    def enc_ops(ops):
        out = []
        for op in ops:
            sub = None
            if op.sub:
                sub = {k: (prog_mod._map(enc, v) if k == "holders" else
                           (enc_ops(v[0]), prog_mod._map(enc, v[1])))
                       for k, v in op.sub.items()}
            out.append((op.kind, op.fn, prog_mod._map(enc, op.args),
                        prog_mod._map(enc, op.kwargs),
                        prog_mod._map(enc, op.out), op.inplace, sub))
        return out

    record = {
        "ops": enc_ops(program.ops),
        "params": [enc(pv) for pv, _ in program.params],
        "feeds": {n: enc(v) for n, v in program.feed_vars.items()},
        "minimize": [(_optimizer_settings(opt, program), enc(loss))
                     for opt, loss in program.minimize_reqs],
        "backward": None if program.backward_req is None else (
            enc(program.backward_req[0]),
            [enc(p) for p in program.backward_req[1]]),
    }
    for v in program.vars.values():
        enc(v)
    record["vars"] = vars_
    return record


def _decode_program(record):
    prog = Program()
    made = {}

    def dec(x):
        if isinstance(x, _VarRef):
            if x.vid not in made:
                name, sa, sb, dtype, is_param, stop = record["vars"][x.vid]
                v = Variable(torch.empty(sa, dtype=dtype, device="meta"),
                             torch.empty(sb, dtype=dtype, device="meta"),
                             name=name, is_param=is_param,
                             trainable=not stop)
                v.__dict__["stop_gradient"] = stop
                made[x.vid] = prog._add_var(v)
            return made[x.vid]
        if isinstance(x, _SymRef):
            if x.vid not in made:
                made[x.vid] = SymDim(x.a, x.b)
            return made[x.vid]
        return x

    def dec_ops(ops):
        out = []
        for kind, fn, args, kwargs, outs, inplace, sub in ops:
            if sub:
                sub = {k: (prog_mod._map(dec, v) if k == "holders" else
                           (dec_ops(v[0]), prog_mod._map(dec, v[1])))
                       for k, v in sub.items()}
            out.append(OpRecord(kind, fn, prog_mod._map(dec, args),
                                prog_mod._map(dec, kwargs),
                                prog_mod._map(dec, outs), inplace, sub))
        return out

    for vid in record["vars"]:
        dec(_VarRef(vid))
    prog.ops = dec_ops(record["ops"])
    prog._targets = [prog.ops]
    prog.params = [(dec(r), None) for r in record["params"]]
    prog.feed_vars = {n: dec(r) for n, r in record["feeds"].items()}
    prog.minimize_reqs = [(opt, dec(r)) for opt, r in record["minimize"]]
    if record["backward"] is not None:
        loss, params = record["backward"]
        prog.backward_req = (dec(loss), [dec(p) for p in params])
    return prog


@prog_mod.unrecorded
def save(program, path_prefix, scope=None):
    """``paddle.static.save``: the Program in ``.pdmodel``, its parameters
    in ``.pdparams`` and its optimizers' state in ``.pdopt``."""
    scope = scope or global_scope()
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    with open(path_prefix + ".pdmodel", "wb") as f:
        f.write(PROGRAM_MAGIC)
        pickle.dump(_encode_program(program), f, protocol=4)
    params = {pv.name: _to_host(scope.vars[pv.name])
              for pv, _ in program.params if pv.name in scope.vars}
    with open(path_prefix + ".pdparams", "wb") as f:
        pickle.dump(params, f, protocol=4)
    opt_state = {}
    for i, (opt, _) in enumerate(program.minimize_reqs):
        opt_state[f"@opt{i}"] = {
            k: (_to_host(v) if isinstance(v, torch.Tensor) else v)
            for k, v in opt.state_dict().items()}
    with open(path_prefix + ".pdopt", "wb") as f:
        pickle.dump(opt_state, f, protocol=4)


@prog_mod.unrecorded
def load(program, path_prefix, executor=None, var_list=None, scope=None):
    """``paddle.static.load``: the parameters (and, unless ``var_list`` is
    given, the optimizers' state) of ``path_prefix`` into the scope. A
    tensor already in the scope is overwritten in place, so the captured
    steps over it stay valid."""
    scope = scope or global_scope()
    device = executor.device if executor is not None else None
    with open(path_prefix + ".pdparams", "rb") as f:
        arrays = pickle.load(f)
    trainable = {pv.name: not pv.stop_gradient for pv, _ in program.params}
    with torch.no_grad():
        for name, arr in arrays.items():
            value = torch.from_numpy(np.asarray(arr))
            old = scope.find_var(name)
            if old is not None and old.shape == value.shape:
                old.copy_(value)
                continue
            value = value.to(device or "cpu")
            if trainable.get(name, False):
                value = nn.Parameter(value)
            scope.set(name, value)
    if var_list is None and os.path.exists(path_prefix + ".pdopt"):
        with open(path_prefix + ".pdopt", "rb") as f:
            opt_state = pickle.load(f)
        for i, (opt, _) in enumerate(program.minimize_reqs):
            if f"@opt{i}" in opt_state:
                opt._static_pending_state = opt_state[f"@opt{i}"]


@prog_mod.unrecorded
def load_program(path_prefix, scope=None, load_state=True):
    """Read a Program written by :func:`save`; with ``load_state`` its
    parameters and optimizer state go into the scope, so that
    ``Executor.run`` continues the run. Unpickling runs code: only for
    files from a trusted source."""
    blob = _read_model(path_prefix + ".pdmodel", PROGRAM_MAGIC,
                       "static.load_program")
    program = _decode_program(pickle.loads(blob))
    if load_state:
        load(program, path_prefix, scope=scope)
        scope = scope or global_scope()
        program.params = [(pv, scope.find_var(pv.name))
                          for pv, _ in program.params]
    return program


# -- inference artifacts ------------------------------------------------------

def _dims(shapes, shared):
    """``dynamic_shapes`` entries: a ``Dim`` for each -1, one shared by
    every leading -1 when ``shared``."""
    from torch.export import Dim

    batch = Dim("batch", min=1)
    specs = []
    for i, shape in enumerate(shapes):
        spec = {}
        for d, s in enumerate(shape):
            if s == -1:
                spec[d] = batch if shared and d == 0 else \
                    Dim(f"f{i}_d{d}", min=1)
        specs.append(spec or None)
    return specs


def export_artifact(module, params, feed_shapes, feed_dtypes, device):
    """``module(params, *feeds)`` exported with a ``Dim`` for each -1 of
    ``feed_shapes``: independent dimensions first, one leading batch
    dimension shared by the feeds when the module ties them."""
    examples = tuple(torch.zeros([2 if s == -1 else s for s in shape],
                                 dtype=dt, device=device)
                     for shape, dt in zip(feed_shapes, feed_dtypes))
    args = (tuple(params), *examples)
    errors = []
    for shared in (False, True):
        dyn = (tuple(None for _ in params),
               tuple(_dims(feed_shapes, shared)))
        try:
            with prog_mod.recording_suspended(), torch.no_grad():
                return torch.export.export(module, args, dynamic_shapes=dyn,
                                           strict=False)
        except Exception as e:  # a constraint the next form may meet
            errors.append(e)
    raise errors[-1]


def _write_artifact(path_prefix, exported, params, extra):
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    # the example inputs hold the parameters: they live in .pdiparams
    exported.example_inputs = None
    buf = _io.BytesIO()
    torch.export.save(exported, buf)
    with open(path_prefix + ".pdmodel", "wb") as f:
        f.write(EXPORT_MAGIC + buf.getvalue())
    meta = {"arrays": [_to_host(p) for p in params],
            "dtypes": [str(p.dtype).split(".")[-1] for p in params]}
    meta.update(extra)
    with open(path_prefix + ".pdiparams", "wb") as f:
        pickle.dump(meta, f, protocol=4)


def load_artifact(path_prefix, device, params_path=None):
    """``(callable(params, *feeds), params on device, meta)`` of an
    artifact written by ``save_inference_model`` or ``jit.save``."""
    blob = _read_model(path_prefix + ".pdmodel", EXPORT_MAGIC,
                       "an inference load")
    with open(params_path or path_prefix + ".pdiparams", "rb") as f:
        meta = pickle.load(f)
    saved = torch.device(meta.get("device", "cpu"))
    if saved.type != device.type:
        raise ValueError(
            f"{path_prefix}.pdmodel was exported on {saved.type} and is "
            f"loaded on {device.type}: its graph holds the routes taken "
            f"on {saved.type} (flash_attention's plain attention on the "
            "CPU, K1 on CUDA), so it is not moved. Export it again on "
            f"{device.type} (save_inference_model with an Executor there, "
            f"jit.save of the layer there), or load it on {saved.type}")
    exported = torch.export.load(_io.BytesIO(blob))
    dtypes = meta.get("dtypes") or [None] * len(meta["arrays"])
    params = [torch.from_numpy(np.asarray(a)).to(
        device, dtype=getattr(torch, d) if d else None)
        for a, d in zip(meta["arrays"], dtypes)]
    return exported.module(), params, meta


class _ProgramForward(nn.Module):
    """A Program's forward from its feeds to ``fetch_vars``, its
    parameters passed in: what ``save_inference_model`` exports."""

    def __init__(self, program, feed_vars, fetch_vars, device):
        super().__init__()
        self.program, self.device = program, device
        self.feed_vars, self.fetch_vars = feed_vars, fetch_vars
        self.replay = Replay(program, device)

    def forward(self, params, *feeds):
        env = {pv.vid: p for (pv, _), p in zip(self.program.params, params)}
        for fv, t in zip(self.feed_vars, feeds):
            env[fv.vid] = t
        self.replay.run(self.program.ops, env)
        return tuple(env[v.vid] for v in self.fetch_vars)


@prog_mod.unrecorded
def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         program=None, **kwargs):
    """``paddle.static.save_inference_model``: the forward from
    ``feed_vars`` to ``fetch_vars`` over the scope's parameters (run the
    startup program or the Program once first), exported on the
    executor's device (the parameters' where no executor is given)."""
    program = program or prog_mod.default_main_program()
    scope = global_scope()
    feed_vars = list(feed_vars) if isinstance(feed_vars, (list, tuple)) \
        else [feed_vars]
    fetch_vars = list(fetch_vars) if isinstance(fetch_vars, (list, tuple)) \
        else [fetch_vars]
    fetch_vars = [resolve_alias(v) for v in fetch_vars]
    params = []
    for pv, init in program.params:
        value = scope.find_var(pv.name)
        params.append((value if value is not None else init).detach())
    if executor is not None:
        device = executor.device
    elif params:
        device = params[0].device
    else:
        device = place_device(None)
    params = [p.to(device) for p in params]
    module = _ProgramForward(program, feed_vars, fetch_vars, device)
    exported = export_artifact(module, params,
                               [v.static_shape for v in feed_vars],
                               [v._ma.dtype for v in feed_vars], device)
    _write_artifact(path_prefix, exported, params, {
        "feed_names": [v.name for v in feed_vars],
        "fetch_names": [v.name for v in fetch_vars],
        "kind": "static_inference", "device": str(device)})


class LoadedInferenceProgram:
    """What ``load_inference_model`` returns as its program:
    ``run(feed)`` gives the fetches as numpy arrays, and
    ``Executor.run(program, feed, fetch_list)`` takes it too."""

    def __init__(self, module, params, feed_names, fetch_names):
        self._module, self._params = module, params
        self.feed_names, self.fetch_names = feed_names, fetch_names
        self.device = params[0].device if params else torch.device("cpu")

    @prog_mod.unrecorded
    def run(self, feed, fetch_list=None):
        feeds = [torch.as_tensor(feed[n]).to(self.device)
                 for n in self.feed_names]
        with torch.no_grad():
            outs = self._module(tuple(self._params), *feeds)
        outs = [_to_host(o) for o in outs]
        if fetch_list:
            names = [f if isinstance(f, str) else f.name for f in fetch_list]
            outs = [outs[self.fetch_names.index(n)] for n in names]
        return outs


@prog_mod.unrecorded
def load_inference_model(path_prefix, executor=None, **kwargs):
    """``paddle.static.load_inference_model``: ``[program, feed names,
    fetch names]``, the program on the executor's device (the current
    CUDA device when none is given)."""
    device = executor.device if executor is not None else place_device(None)
    module, params, meta = load_artifact(path_prefix, device)
    prog = LoadedInferenceProgram(module, params, meta.get("feed_names", []),
                                  meta.get("fetch_names", []))
    return [prog, prog.feed_names, prog.fetch_names]
