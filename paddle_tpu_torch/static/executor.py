"""The static-graph Executor (counterpart of paddle_tpu/static/executor.py).

``Executor.run`` replays a Program's record with real tensors: one
``_CompiledStep`` per (program, feed signature, fetch set), cached as the
reference caches one XLA executable per signature (``executor.py:620-
637``). On a CUDA Executor the step (the forward; for a program with a
``minimize`` request also the backward, the clip and the update) runs
through ``jit.TrainStep``: the first run of a signature runs eagerly on a
side stream, the second captures it into one CUDA graph, and every later
run copies the feeds into the graph's static inputs, writes each
optimizer's learning rate and step count into its device scalars and
replays the graph. On a CPU Executor (``Executor("cpu")``,
``static.cpu_places()``) every run replays the record eagerly.

A Program holding ``static.nn.cond`` or ``while_loop`` decides its branch
on the host, which a CUDA graph cannot: on the card it runs uncaptured,
counted as ``static.uncaptured_runs`` with an ``explainer`` event naming
the reason.

The parameters live in the Scope (``global_scope()`` unless ``scope=`` is
given), on the Executor's device. A parameter promoted from a model's
``nn.Parameter`` is that parameter itself where the devices agree, so a
static training run trains the model. The optimizers keep their own
state, as they do eagerly; ``static.save`` writes it beside the
parameters.

The reference's pass-driven modes (AMP O2, gradient merge, sharding,
LocalSGD, fp16 allreduce, the program-level clip and
``FLAGS_check_nan_inf``'s per-op replay) come with
``distributed/passes`` (ROADMAP queue 1 item 11b): a Program asking for
one raises.

Counters (registry scope ``static``): ``compiles`` (new steps),
``graph_runs``, ``uncaptured_runs``, ``eager_runs`` (CPU). Captures are
``jit``'s ``train_step_captures``.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

from ..device import resolve_device
from ..profiler import explainer as _explain
from ..profiler import registry as _registry
from . import program as prog_mod
from .program import DEVICE, SymDim, Variable, global_scope, resolve_alias

__all__ = ["Executor", "place_device"]

_counters = _registry.scoped_counters("static", {
    "compiles": 0, "graph_runs": 0, "uncaptured_runs": 0, "eager_runs": 0})

_PASS_ATTRS = ("amp_o2_dtype", "grad_merge_k", "sharding_degree",
               "localsgd_k", "fp16_allreduce_dtype", "grad_clip_norm")
_COUNTS = ("grad_merge_k", "sharding_degree", "localsgd_k")  # 1 is off

_ITEM_11B = ("is a pass-driven mode of the reference's Executor; it comes "
             "to the port with distributed/passes (ROADMAP queue 1 item "
             "11b) and is never ignored")


def place_device(place=None):
    """The ``torch.device`` of a place: None (the current CUDA device; raises
    without one), a ``torch.device``, or a name such as ``"cpu"``,
    ``"gpu"``, ``"gpu:0"`` or ``"cuda:0"``."""
    if isinstance(place, str):
        place = place.replace("gpu", "cuda")
    return resolve_device(place)


def refuse_passes(program):
    """Raise if ``program`` asks for a mode of the reference's passes."""
    for attr in _PASS_ATTRS:
        value = getattr(program, attr, None)
        off = value is None or value is False or (
            attr in _COUNTS and value == 1)
        if not off:
            raise NotImplementedError(f"Program.{attr}={value!r} {_ITEM_11B}")
    if os.environ.get("FLAGS_check_nan_inf", "0").lower() not in (
            "", "0", "false"):
        raise NotImplementedError(f"FLAGS_check_nan_inf's per-op replay "
                                  f"{_ITEM_11B}")


def _resolve_fetch(program, fetch_list):
    out = []
    for f in fetch_list or []:
        if isinstance(f, Variable):
            out.append(resolve_alias(f))
        elif isinstance(f, str):
            out.append(resolve_alias(program.vars[f]))
        else:
            raise TypeError(f"bad fetch entry {f!r}")
    return out


def _walk(ops):
    for op in ops:
        yield op
        if op.sub:
            for key in ("true", "false", "cond", "body"):
                if key in op.sub:
                    yield from _walk(op.sub[key][0])


class Replay:
    """Runs a Program's record on real tensors on ``device``: the
    constants the record holds are moved there once."""

    def __init__(self, program, device):
        self.program, self.device = program, device
        self.consts, self.generators = {}, {}
        for op in _walk(program.ops):
            blocks = [v[1] for k, v in (op.sub or {}).items()
                      if k != "holders"]
            for x in prog_mod._leaves((op.args, op.kwargs, blocks)):
                if isinstance(x, torch.Generator):
                    self.generators[id(x)] = x
                elif isinstance(x, torch.Tensor) and \
                        not isinstance(x, Variable) and \
                        id(x) not in self.consts:
                    self.consts[id(x)] = x.to(device)
        self.control_flow = any(op.kind != "call" for op in _walk(
            program.ops))

    def lookup(self, env, x):
        if isinstance(x, (Variable, SymDim)):
            try:
                return env[x.vid]
            except KeyError:
                raise RuntimeError(
                    f"{x!r} is read before the Program computes it (a feed "
                    "that was not fed?)") from None
        if isinstance(x, torch.Tensor):
            return self.consts[id(x)]
        if isinstance(x, torch.device) and x == DEVICE:
            return self.device
        return x

    def run(self, ops, env):
        for op in ops:
            if op.kind == "cond":
                self._cond(op, env)
            elif op.kind == "while":
                self._while(op, env)
            else:
                args, kwargs = prog_mod._map(
                    lambda x: self.lookup(env, x), (op.args, op.kwargs))
                res = op.fn(*args, **kwargs)
                vals = [args[0]] if op.inplace else pytree.tree_flatten(res)[0]
                for leaf, v in zip(op.out, vals):
                    if isinstance(leaf, (Variable, SymDim)):
                        env[leaf.vid] = v

    def _outputs(self, env, outs):
        return [self.lookup(env, o) for o in outs]

    def _cond(self, op, env):
        pred = self.lookup(env, op.args[0])
        take = bool(pred.reshape(()).item()) if isinstance(
            pred, torch.Tensor) else bool(pred)
        ops, outs = op.sub["true" if take else "false"]
        self.run(ops, env)
        for leaf, v in zip(op.out, self._outputs(env, outs)):
            env[leaf.vid] = v

    def _while(self, op, env):
        holders = op.sub["holders"]
        vals = [self.lookup(env, a) for a in op.args]
        cond_ops, (cond_out,) = op.sub["cond"]
        body_ops, body_outs = op.sub["body"]
        while True:
            for h, v in zip(holders, vals):
                env[h.vid] = v
            self.run(cond_ops, env)
            if not bool(self.lookup(env, cond_out).reshape(()).item()):
                break
            self.run(body_ops, env)
            vals = self._outputs(env, body_outs)
        for leaf, v in zip(op.out, vals):
            env[leaf.vid] = v


class _Held(nn.Module):
    """The tensors a captured step reads and writes, and the generators it
    draws from, where ``jit.TrainStep`` looks for them (a step over no
    tensor holds an empty one on ``device``, where TrainStep places it)."""

    def __init__(self, tensors, generators, device):
        super().__init__()
        for i, t in enumerate(tensors):
            if isinstance(t, nn.Parameter):
                self.register_parameter(f"p{i}", t)
            else:
                self.register_buffer(f"b{i}", t)
        if not tensors:
            self.register_buffer("b", torch.empty(0, device=device))
        for i, g in enumerate(generators):
            setattr(self, f"g{i}", g)


def _bind_optimizer(opt, program, params):
    """Point a static-mode optimizer at the scope's tensors: every
    trainable program parameter when it was made without ``parameters``,
    the named ones for one loaded by ``static.load_program``, else the
    program parameters among its own. State loaded by ``static.load`` is
    restored once it is bound."""
    names = getattr(opt, "_static_param_names", None)
    if names is not None:
        by_name = {pv.name: (pv, t) for pv, t in params}
        chosen = [by_name[n] for n in names if n in by_name]
    elif opt._static_unbound:
        chosen = [(pv, t) for pv, t in params if not pv.stop_gradient]
    else:
        by_param = {id(init): (pv, t) for (pv, t), (_, init) in
                    zip(params, program.params)}
        chosen = [by_param.get(id(p), (None, p))
                  for p in opt._parameter_list]
    opt._parameter_list = [t for _, t in chosen]
    opt._parameter_names = [pv.name if pv is not None else None
                            for pv, _ in chosen]
    pending = opt.__dict__.pop("_static_pending_state", None)
    if pending is not None:
        opt.set_state_dict(pending)


class _CompiledStep:
    def __init__(self, program, feed_names, fetch_vars, scope, device):
        refuse_passes(program)
        self.program, self.scope, self.device = program, scope, device
        self.feed_vars = [program.feed_vars[n] for n in feed_names]
        self.feed_names = list(feed_names)
        self.fetch_vars = fetch_vars
        self.param_vars = [pv for pv, _ in program.params]
        self.train = bool(program.minimize_reqs) or \
            program.backward_req is not None
        self.opts = [opt for opt, _ in program.minimize_reqs]
        self.replay = Replay(program, device)
        self._graph = None
        self._held = None
        self._told = False
        _counters["compiles"] += 1

    def _step(self, *feeds):
        env = {pv.vid: self.scope.vars[pv.name] for pv in self.param_vars}
        for fv, t in zip(self.feed_vars, feeds):
            env[fv.vid] = t
        with torch.set_grad_enabled(self.train):
            self.replay.run(self.program.ops, env)
            reqs = self.program.minimize_reqs
            for i, (opt, loss) in enumerate(reqs):
                env[resolve_alias(loss).vid].backward(
                    retain_graph=i < len(reqs) - 1)
                opt.step()
                opt.clear_grad()
            if self.program.backward_req is not None and not reqs:
                self._backward(env)
        return tuple(env[v.vid] for v in self.fetch_vars)

    def _backward(self, env):
        loss, params = self.program.backward_req
        tensors = [self.scope.vars[p.name] for p in params]
        grads = torch.autograd.grad(env[resolve_alias(loss).vid], tensors,
                                    allow_unused=True)
        for p, g in zip(params, grads):
            if g is not None:
                self.scope.set(p.name + "@GRAD", g.detach().clone())

    def _bind(self):
        """Bind the optimizers to the scope's tensors, and on the card
        build the captured step over them (again when the scope's tensors
        were replaced)."""
        params = [(pv, self.scope.vars[pv.name]) for pv in self.param_vars]
        held = [id(t) for _, t in params]
        if held == self._held:
            return
        self._held = held
        for opt in self.opts:
            _bind_optimizer(opt, self.program, params)
        if self.device.type == "cuda" and not self.replay.control_flow:
            from ..jit import TrainStep

            module = _Held([t for _, t in params],
                           list(self.replay.generators.values()), self.device)
            self._graph = TrainStep(self._step, [module], self.opts)

    def run(self, feed):
        self._bind()
        feeds = []
        for fv, name in zip(self.feed_vars, self.feed_names):
            a = feed[name]
            t = a if isinstance(a, torch.Tensor) else \
                torch.from_numpy(np.array(a))
            feeds.append(t.to(fv._ma.dtype))
        if self._graph is not None:
            _counters["graph_runs"] += 1
            return self._graph(*feeds)
        if self.device.type == "cuda":
            if not self._told:
                self._told = True
                _explain.record(
                    "static_uncaptured", op="Executor.run",
                    why="the Program holds static.nn.cond / while_loop, "
                        "whose branch is decided on the host; a CUDA graph "
                        "cannot take it, so the run is not captured")
            _counters["uncaptured_runs"] += 1
        else:
            _counters["eager_runs"] += 1
        feeds = [t.to(self.device, non_blocking=True) for t in feeds]
        # a fetch may be a scope tensor a later run updates in place
        return tuple(o.detach().clone() for o in self._step(*feeds))


def _to_host(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _initial(pv, init, device):
    """A parameter's value in the scope: a model's own parameter where it
    is on ``device``, else a copy there."""
    if isinstance(init, nn.Parameter) and init.device == device:
        return init
    value = init.detach().to(device).clone()
    if pv.stop_gradient:
        return value
    return nn.Parameter(value, requires_grad=True)


class Executor:
    """``Executor(place)``: ``place`` None runs on the current CUDA device
    (and raises without one); ``"cpu"`` or ``static.cpu_places()[0]`` on
    the CPU."""

    def __init__(self, place=None):
        self.place = place
        self.device = place_device(place)
        self._cache: dict = {}

    @prog_mod.unrecorded
    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, **kwargs):
        program = program or prog_mod.default_main_program()
        feed = feed or {}
        scope = scope or global_scope()
        if not isinstance(program, prog_mod.Program):
            # load_inference_model's program
            return program.run(feed, fetch_list)

        if program is prog_mod.default_startup_program() or (
                not program.ops and program.params and not fetch_list):
            for pv, init in prog_mod.default_main_program().params:
                if scope.find_var(pv.name) is None:
                    scope.set(pv.name, _initial(pv, init, self.device))
            for pv, init in program.params:
                scope.set(pv.name, _initial(pv, init, self.device))
            return []

        for pv, init in program.params:
            value = scope.find_var(pv.name)
            if value is None or value.device != self.device:
                if value is None and init is None:
                    raise RuntimeError(f"parameter {pv.name} has no value: "
                                       "load the Program's state first")
                scope.set(pv.name, _initial(
                    pv, init if value is None else value, self.device))

        if not program.ops and not fetch_list:
            return []  # nothing to run (a startup Program of static.nn)
        fetch_vars = _resolve_fetch(program, fetch_list)
        sig = (id(program), program._version, len(program.ops), id(scope),
               tuple(sorted((n, tuple(np.shape(a)), str(getattr(
                   a, "dtype", type(a)))) for n, a in feed.items())),
               tuple(v.vid for v in fetch_vars))
        step = self._cache.get(sig)
        if step is None:
            names = [n for n in program.feed_vars if n in feed]
            step = self._cache[sig] = _CompiledStep(
                program, names, fetch_vars, scope, self.device)
        outs = step.run(feed)
        if return_numpy:
            return [_to_host(o) for o in outs]
        return list(outs)

    def close(self):
        self._cache.clear()
