"""Pipeline parallelism (counterpart of paddle_tpu/distributed/pp_spmd.py):
``PipelineSpmdStep``, the GPipe step, and the stage runtime it shares with
``fleet.HybridParallelEngine``'s 1F1B schedule.

The reference is one controller: it stacks the trunk ``[L, ...]``, shards
it over ``'pp'`` and lets GSPMD move the activations. Here each pipeline
rank is a process and holds only its stage's trunk blocks, as plain
per-layer parameters (rank ``s`` of the pipe group holds blocks
``[s L/pp, (s+1) L/pp)``; the others' are freed). Every non-trunk
parameter (embeddings, final norm, a tied head, a ``SharedLayerDesc``) is
kept on every stage, and its gradient is summed over the pipe group before
the update, so the tied word embedding's two uses, on the first and the
last stage, give one gradient and both copies stay bitwise equal (the
reference's psum over ``'pp'``). Activations and their gradients cross
stage boundaries as point-to-point transfers over the ``"pp"`` group
(``collective.p2p``, each tick's sends and receives posted together); the
schedule is an explicit loop over microbatches with
``torch.autograd.backward`` on each stage's saved outputs. The steps are
eager: the captured multi-rank step is ROADMAP queue 1 item 7b.

Stage slicing follows the reference's three protocols, most specific
first: ``model.pipeline_parts(pp)`` (``GPTForPretraining``), a
``PipelineLayer`` (``segment_for_pipeline``), or the longest uniform
``nn.ModuleList`` of a model with ``.embeddings`` and ``.ln_f``.

The loss is the mean over microbatches of the last stage's criterion (the
mean of log-softmax cross-entropy without one), averaged over the ranks
that split the batch. Gradients are averaged over those ranks (dp x
sharding). Public state is the reference's: ``state_dict()``,
``export_optimizer_state()`` give the whole model's canonical per-layer
names and the optimizer's ``"<slot>/p<i>"`` keys by position in the
model's parameter list; ``sync_params_to_model()`` makes the model whole
on every rank, ``release()`` also gives the optimizer back every
parameter and slot.

Gauges (``profiler.registry``): ``pp.stages``, ``pp.microbatches``,
``pp.trunk_layers``, ``pp.stage_param_bytes``, ``pp.permute_bytes_per_step``
(the bytes this rank sent across a boundary in the last step) and
``pp.max_live_inputs`` (the most microbatches whose forward had run and
backward had not, on this stage, in the last step).
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..profiler import registry as _registry
from . import collective
from .meta_parallel.pp_layers import (PipelineLayer, PipelineStageError,
                                      refuse)

__all__ = ["PipelineSpmdStep", "PipelineStageError"]

_counters = _registry.scoped_counters("pp", {"steps_built": 0})


def _find_block_stack(model):
    """``(name, ModuleList)``: the longest ModuleList of at least two
    modules with equal state names and shapes (the transformer trunk)."""
    best = None
    for name, sub in model.named_modules():
        if isinstance(sub, nn.ModuleList) and len(sub) >= 2:
            sigs = [(tuple(b.state_dict().keys()),
                     tuple(tuple(t.shape) for t in b.state_dict().values()))
                    for b in sub]
            if all(s == sigs[0] for s in sigs) and (
                    best is None or len(sub) > len(best[1])):
                best = (name, sub)
    return best


def _default_loss(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long().unsqueeze(-1)).mean()


def unwrap(model, optimizer):
    """The model and optimizer a pipeline restructures: the model behind a
    ``group_sharded_parallel`` facade, and the optimizer behind a
    ``fleet.distributed_optimizer`` wrapper. A ``GroupShardedOptimizer`` is
    kept: it reduces and updates its own blocks."""
    from .fleet import _DistributedOptimizer
    from .sharding import _GroupShardedModel

    if isinstance(model, _GroupShardedModel):
        model = model._layers
    if isinstance(optimizer, _DistributedOptimizer):
        optimizer = optimizer.inner_opt
    return model, optimizer


def model_parts(model, pp, criterion, op="pp_spmd", generic=False):
    """``(embed, trunk blocks, head, criterion)`` by the module's three
    protocols. Refuses a model none of them fits (``no_uniform_trunk``)
    and a trunk ``pp`` does not divide (``stage_indivisible``). With
    ``generic`` at ``pp = 1``, a model no protocol fits is one stage of its
    own: ``(model, [], identity, criterion)``, the criterion required."""
    if hasattr(model, "pipeline_parts"):
        embed, trunk, head = model.pipeline_parts(pp)
    elif isinstance(model, PipelineLayer):
        pre, trunk, post = model.segment_for_pipeline(pp)
        criterion = criterion or model._loss_fn

        def embed(toks):
            x = toks
            for e in pre:
                x = model._apply(e, x)
            return x

        def head(x):
            for e in post:
                x = model._apply(e, x)
            return x
    else:
        stack = _find_block_stack(model)
        gpt = getattr(model, "gpt", model)
        if stack is None or not hasattr(gpt, "embeddings"):
            if generic and pp == 1:
                if criterion is None:
                    raise ValueError(
                        f"{op} in generic mode (no uniform block stack) "
                        "needs a criterion(out, labels)")
                return model, [], (lambda x: x), criterion
            raise refuse(
                op, "no_uniform_trunk",
                f"{op}: pipeline parallelism requires a uniform block "
                "stack (e.g. GPT blocks in a ModuleList) with known "
                "embed/head slicing, pipeline_parts(pp) (models/gpt.py), "
                "or a PipelineLayer built from LayerDescs; at pp=1 the "
                "HybridParallelEngine takes any model (generic mode)")

        def head(x):
            x = gpt.ln_f(x)
            return x @ gpt.embeddings.word_embeddings.weight.t()

        embed, trunk = gpt.embeddings, list(stack[1])
    if len(trunk) % pp != 0:
        raise refuse(
            op, "stage_indivisible",
            f"trunk has {len(trunk)} layers, not divisible by pp={pp}: "
            "every stage must own an equal layer slice of the trunk",
            n_layers=len(trunk), pp=pp)
    return embed, trunk, head, criterion


class StageRunner:
    """One rank's share of a pipeline over ``hcg``'s pipe group (see the
    module's docstring). ``parts``: ``(embed, blocks, head, criterion)``
    with the trunk ``blocks`` cut into equal stages, or, with
    ``groups``, an explicit split (``fleet.HybridParallelEngine``'s
    heterogeneous pipeline: ``embed`` then ``groups[s]`` on stage ``s``,
    every parameter kept on every stage)."""

    def __init__(self, model, optimizer, hcg, parts, groups=None):
        from .sharding import GroupShardedOptimizer

        self.model = model
        self.hcg = hcg
        self.pp = hcg.get_pipe_parallel_world_size()
        self.stage = hcg.get_stage_id()
        self.group = hcg.get_pipe_parallel_group()
        self.first = self.stage == 0
        self.last = self.stage == self.pp - 1
        self.embed, blocks, self.head, self.criterion = parts
        self.all_params = list(model.parameters())
        owner = {}
        if groups is not None:
            self.my_blocks = list(groups[self.stage])
            self.n_layers = 0
        else:
            self.n_layers = len(blocks)
            Ls = self.n_layers // self.pp
            self.my_blocks = blocks[self.stage * Ls:(self.stage + 1) * Ls]
            for j, blk in enumerate(blocks):
                for p in blk.parameters():
                    owner[id(p)] = j // Ls
        self.trunk_owner = owner
        zero = optimizer if isinstance(optimizer, GroupShardedOptimizer) \
            else None
        opt = zero.inner_opt if zero is not None else optimizer
        listed = [p for p in opt._parameter_list if p is not None]
        seen = {id(p) for p in self.all_params}
        self.all_params += [p for p in listed if id(p) not in seen]
        self.other_ids = {id(p) for p in self.all_params
                          if id(p) not in owner}
        self.owned = {id(p) for p in self.all_params
                      if owner.get(id(p), self.stage) == self.stage}
        self._shapes = {}
        with torch.no_grad():
            for p in self.all_params:
                if id(p) not in self.owned:
                    self._shapes[id(p)] = tuple(p.shape)
                    p.data = p.data.new_empty(0)
        self.optimizer, self.zero = opt, zero
        self.full_list = list(opt._parameter_list)
        self.full_names = list(opt._parameter_names)
        opt._parameter_list = [p if p is not None and id(p) in self.owned
                               else None for p in self.full_list]
        for store in opt._accumulators.values():  # another stage's slots
            for i in [i for i in store if opt._parameter_list[i] is None]:
                del store[i]
        if zero is not None:
            zero.restrict(self.owned)
        self._boundary = {}
        self.stage_param_bytes = sum(
            p.numel() * p.element_size() for p in self.all_params
            if id(p) in self.owned)

    # -- one step -------------------------------------------------------------
    def _stage_forward(self, tok, x_in):
        x = self.embed(tok) if self.first else x_in
        for blk in self.my_blocks:
            x = blk(x)
        return x

    def _loss(self, x, lab):
        out = self.head(x)
        if self.criterion is None:
            return _default_loss(out, lab)
        return self.criterion(out, lab)

    def _scope(self):
        """A ZeRO optimizer's forward scope (its gathered tables), for
        running the model's parts without calling the model."""
        return self.zero.forward_scope() if self.zero is not None \
            else contextlib.nullcontext()

    def _boundary_of(self, tok):
        """Shape and dtype of the activation crossing a stage boundary
        (every stage holds the embedding, so each works it out alone)."""
        key = tuple(tok.shape)
        if key not in self._boundary:
            with torch.no_grad(), self._scope():
                x = self.embed(tok)
            self._boundary[key] = (tuple(x.shape), x.dtype, x.device)
        return self._boundary[key]

    @staticmethod
    def slots(kind, pp, M):
        """The ticks of a schedule: ``(forward index, backward index)``
        functions of the stage, or None for a tick without that phase.
        ``"1f1b"``: stage ``s`` runs the forward of microbatch ``i`` at tick
        ``i + s`` and its backward at ``i + 2(pp-1) - s`` (pp-1 warm-up
        ticks, M steady ones, pp-1 drain ticks). ``"gpipe"``: every
        forward, then every backward."""
        if kind == "1f1b":
            for t in range(M + 2 * (pp - 1)):
                yield ((lambda s, t=t: t - s) if t < M + pp - 1 else None,
                       (lambda s, t=t: t - 2 * (pp - 1) + s)
                       if t >= pp - 1 else None)
        else:
            for t in range(M + pp - 1):
                yield (lambda s, t=t: t - s), None
            for t in range(M + pp - 1):
                yield None, (lambda s, t=t: t - (pp - 1 - s))

    def run(self, tokens, labels, M, kind="gpipe", scale=None):
        """The schedule over ``M`` microbatches of this rank's rows: the
        gradients of ``scale * mean_i loss_i`` accumulate on this stage's
        parameters; returns the mean loss (float32, the last stage's,
        given to every stage). Each tick's sends and receives are one
        exchange; a ZeRO optimizer's forward scope holds over the whole
        schedule."""
        tok_mb = tokens.chunk(M, 0)
        lab_mb = labels.chunk(M, 0)
        s, pp = self.stage, self.pp
        seed = (1.0 if scale is None else float(scale)) / M
        shape, dtype, dev = self._boundary_of(tok_mb[0]) if pp > 1 \
            else (None, None, None)
        inputs, outputs, fwd_in, grad_in, losses = {}, {}, {}, {}, []
        self.live_max, self.sent = 0, 0

        def valid(i):
            return 0 <= i < M

        def forward(i):
            x_in = None
            if not self.first:
                x_in = fwd_in.pop(i).requires_grad_(True)
                inputs[i] = x_in
            x = self._stage_forward(tok_mb[i], x_in)
            if self.last:
                loss = self._loss(x, lab_mb[i])
                losses.append(loss.detach().float())
                x = loss
            elif tuple(x.shape) != shape:
                raise ValueError(
                    f"pipeline stage {s} maps {shape} -> {tuple(x.shape)}; "
                    "every stage must map the shared boundary shape A -> A")
            outputs[i] = x
            self.live_max = max(self.live_max, len(outputs))

        def backward(i):
            out = outputs.pop(i)
            if self.last:
                torch.autograd.backward(out * seed)
            else:
                torch.autograd.backward(out, grad_in.pop(i))
            x_in = inputs.pop(i, None)
            return None if x_in is None else x_in.grad

        def exchange(sends, recvs):
            collective.p2p(sends, recvs, self.group)
            self.sent += sum(t.numel() * t.element_size() for t, _ in sends)

        with self._scope():
            for f, b in self.slots(kind, pp, M):
                if f is not None:
                    i = f(s)
                    if valid(i):
                        forward(i)
                    sends, recvs = [], []
                    if valid(i) and not self.last:
                        sends.append((outputs[i].detach(), s + 1))
                    if not self.first and valid(f(s - 1)):
                        buf = torch.empty(shape, dtype=dtype, device=dev)
                        fwd_in[f(s - 1)] = buf
                        recvs.append((buf, s - 1))
                    exchange(sends, recvs)
                if b is not None:
                    i = b(s)
                    dx = backward(i) if valid(i) else None
                    sends, recvs = [], []
                    if dx is not None and not self.first:
                        sends.append((dx, s - 1))
                    if not self.last and valid(b(s + 1)):
                        buf = torch.empty(shape, dtype=dtype, device=dev)
                        grad_in[b(s + 1)] = buf
                        recvs.append((buf, s + 1))
                    exchange(sends, recvs)
        if self.last:
            loss = torch.stack(losses).mean()
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=tokens.device if dev is None else dev)
        if pp > 1:
            collective.all_reduce(loss, group=self.group)
        batch = self.hcg.get_batch_group()
        if batch.nranks > 1:
            collective.all_reduce(loss, collective.ReduceOp.AVG, group=batch)
        return loss

    # -- gradients ------------------------------------------------------------
    def _holder(self, i):
        p = self.optimizer._parameter_list[i]
        if self.zero is not None:
            return self.zero.grad_holder(i, create=True)
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        return p.grad

    def reduce_grads(self):
        """Sum the non-trunk parameters' gradients over the pipe group,
        then (without ZeRO, which reduces its own) average every gradient
        over the ranks that split the batch."""
        plist = self.optimizer._parameter_list
        idx = [i for i, p in enumerate(plist)
               if p is not None and p.requires_grad]
        if self.pp > 1:
            for i in idx:
                if id(plist[i]) in self.other_ids:
                    collective.all_reduce(self._holder(i), group=self.group)
        if self.zero is None:
            batch = self.hcg.get_batch_group()
            if batch.nranks > 1:
                for i in idx:
                    if plist[i].grad is not None:
                        collective.all_reduce(
                            plist[i].grad, collective.ReduceOp.AVG,
                            group=batch)

    def grads(self):
        """``[(position, gradient holder)]`` of this rank's parameters."""
        plist = self.optimizer._parameter_list
        out = []
        for i, p in enumerate(plist):
            if p is None or not p.requires_grad:
                continue
            g = self.zero.grad_holder(i) if self.zero is not None \
                else p.grad
            if g is not None:
                out.append((i, g))
        return out

    def step(self):
        (self.zero or self.optimizer).step()

    def clear_grad(self):
        (self.zero or self.optimizer).clear_grad()

    # -- state ----------------------------------------------------------------
    def _mp_merged(self, local, shard_of):
        """``{key: tensor}`` with every mp slice gathered whole:
        ``shard_of(key)`` gives the parameter whose ``mp_shard`` the entry
        follows (None for an entry that is not a slice)."""
        from . import spmd

        mp = self.hcg.get_model_parallel_group()
        if mp.nranks <= 1:
            return local
        out = {}
        for key in sorted(local):
            t = local[key]
            p = shard_of(key)
            if isinstance(t, torch.Tensor) and p is not None and \
                    getattr(p, "mp_shard", None) is not None:
                dim, layout, _, _ = p.mp_shard
                parts = []
                collective.all_gather(parts, t.contiguous(), group=mp)
                t = spmd.merge_shards(parts, dim, layout)
            out[key] = t
        return out

    def _pp_union(self, local):
        if self.pp <= 1:
            return local
        import torch.distributed as dist

        got = [None] * self.pp
        dist.all_gather_object(got, local, group=self.group.pg)
        out = {}
        for part in got:
            for k, v in part.items():
                out.setdefault(k, v)
        return out

    def full_state(self):
        """The whole model's ``state_dict()`` (port layout, host tensors);
        every rank of the pipe and mp groups calls it."""
        mine = {}
        params = dict(self.model.named_parameters())
        zpos = {} if self.zero is None else {
            id(p): i for i, p in enumerate(self.zero.params)
            if p is not None}
        for name, t in self.model.state_dict().items():
            p = params.get(name)
            if p is not None and id(p) not in self.owned:
                continue
            if p is not None and id(p) in self.other_ids and \
                    not self.first:
                continue
            if self.zero is not None and p is not None:
                i = zpos.get(id(p))
                if i is not None:
                    t = self.zero.full_parameter(i)
            mine[name] = t.detach()
        mine = self._mp_merged(mine, params.get)
        return self._pp_union({k: v.cpu() for k, v in mine.items()})

    def optimizer_state(self):
        """The optimizer's whole state, canonical keys (module
        docstring); every rank of the pipe, mp and sharding groups calls
        it."""
        local = self.zero.state_dict() if self.zero is not None \
            else self.optimizer.state_dict()
        plist = self.full_list
        keep = {}
        for k, v in local.items():
            if isinstance(v, torch.Tensor):
                i = int(k.rpartition("/p")[2])
                if id(plist[i]) in self.other_ids and not self.first:
                    continue
            keep[k] = v

        def shard_of(k):
            return plist[int(k.rpartition("/p")[2])] if "/p" in k else None

        keep = self._mp_merged(keep, shard_of)
        return self._pp_union({k: (v.detach().cpu() if isinstance(
            v, torch.Tensor) else v) for k, v in keep.items()})

    def sync_params_to_model(self):
        """Give every rank every stage's trunk blocks (broadcast from each
        block's stage): the model is whole on every rank after it."""
        if self.pp <= 1:
            return
        with torch.no_grad():
            for p in self.all_params:
                st = self.trunk_owner.get(id(p))
                if st is None:
                    continue
                if id(p) not in self.owned and p.numel() == 0:
                    p.data = p.data.new_empty(self._shapes[id(p)])
                collective.broadcast(p.data, src=st, group=self.group)

    def restore_optimizer(self):
        """Give the optimizer back the whole parameter list, with every
        parameter's slots (gathered from the stages that held them)."""
        state = self.optimizer_state()
        self.sync_params_to_model()
        opt = self.optimizer
        opt._parameter_list = list(self.full_list)
        opt._parameter_names = list(self.full_names)
        if self.zero is not None:
            self.zero.restrict(None)
            self.zero.set_state_dict(state)
        else:
            opt._accumulators = {}
            opt.set_state_dict({k: v.to(self.full_list[int(
                k.rpartition("/p")[2])].device) if isinstance(
                v, torch.Tensor) else v for k, v in state.items()})


def publish_gauges(runner, M):
    _registry.gauge_set("pp.stages", runner.pp)
    _registry.gauge_set("pp.microbatches", M)
    _registry.gauge_set("pp.trunk_layers", runner.n_layers)
    _registry.gauge_set("pp.stage_param_bytes", runner.stage_param_bytes)


class PipelineSpmdStep:
    """dp x mp x pp training step, GPipe.

    Usage (``fleet.init`` with ``pp_degree > 1`` first; every rank runs
    the same code)::

        step = PipelineSpmdStep(model, opt, criterion=crit,
                                accumulate_steps=M)
        for _ in range(n):
            loss = step.train_batch([tokens, labels])

    ``tokens`` / ``labels`` are the whole batch (each rank keeps its rows
    of dp x sharding, as ``spmd.shard_batch`` does) or, already cut,
    this rank's rows. The constructor restructures training state: this
    rank keeps only its stage's trunk blocks and the optimizer updates only
    this rank's parameters (``release()`` undoes it). ``accumulate_steps``
    None reads ``strategy.pipeline_configs`` and defaults to ``pp``; an
    explicit ``M < pp`` is honoured. ``optimizer`` may be a
    ``distributed_optimizer`` wrapper or ``group_sharded_parallel``'s
    ``GroupShardedOptimizer`` (with its facade model), which keeps its
    level. ``unroll_ticks`` and ``recompute`` are the reference's arguments
    (XLA unrolling, rematerialisation) and change nothing here: the
    schedule is one eager loop, and a GPT block recomputes as its config
    says."""

    def __init__(self, model, optimizer, criterion=None, hcg=None,
                 accumulate_steps=None, mesh=None, recompute=None,
                 unroll_ticks=None):
        from . import fleet as _fleet

        model, optimizer = unwrap(model, optimizer)
        self.model, self.optimizer = model, optimizer
        hcg = hcg or mesh or _fleet.get_hybrid_communicate_group()
        if hcg is None or hcg.get_pipe_parallel_world_size() <= 1:
            raise RuntimeError(
                "PipelineSpmdStep: no pp-folded mesh installed — "
                "fleet.init with hybrid_configs pp_degree>1 first")
        self.hcg = self.mesh = hcg
        self.pp = hcg.get_pipe_parallel_world_size()
        if accumulate_steps is None:
            strat = _fleet.get_strategy()
            if strat is not None:
                accumulate_steps = strat.pipeline_configs.get(
                    "accumulate_steps")
        self.M = max(self.pp, 1) if accumulate_steps is None \
            else int(accumulate_steps)
        if self.M < 1:
            raise refuse("pp_spmd", "bad_accumulate_steps",
                         f"accumulate_steps={accumulate_steps} must be >= 1",
                         accumulate_steps=self.M)
        if hcg.get_model_parallel_world_size() > 1:
            _fleet._shard_in_place(model, hcg)
        embed, blocks, head, crit = model_parts(model, self.pp, criterion)
        self.n_layers = len(blocks)
        self.Ls = self.n_layers // self.pp
        self.criterion = crit
        self.runner = StageRunner(model, optimizer, hcg,
                                  (embed, blocks, head, crit))
        self._steps = 0
        _counters["steps_built"] += 1
        publish_gauges(self.runner, self.M)

    def train_batch(self, data, optimizer=None, lr_scheduler=None,
                    scaler=None):
        """One pipelined step over ``[tokens, labels]``; returns the loss
        (a float32 tensor, the same on every rank)."""
        from . import spmd

        toks = torch.as_tensor(data[0])
        labels = torch.as_tensor(data[1])
        dev = next((p.device for p in self.runner.all_params
                    if p.numel()), toks.device)
        toks = spmd.shard_batch(toks, self.hcg).to(dev)
        labels = spmd.shard_batch(labels, self.hcg).to(dev)
        B = int(toks.shape[0])
        if B % self.M != 0:
            raise refuse(
                "pp_spmd", "batch_indivisible",
                f"batch size {B} is not divisible by "
                f"accumulate_steps={self.M}: the microbatch split needs "
                "B % M == 0", batch=B, microbatches=self.M)
        self.runner.clear_grad()
        loss = self.runner.run(toks, labels, self.M, "gpipe")
        self.runner.reduce_grads()
        self.runner.step()
        self.runner.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        self._steps += 1
        _registry.gauge_set("pp.permute_bytes_per_step", self.runner.sent)
        _registry.gauge_set("pp.max_live_inputs", self.runner.live_max)
        return loss

    __call__ = train_batch

    def state_dict(self):
        """The whole model's state (port layout, host tensors): every
        rank calls it."""
        return self.runner.full_state()

    def sync_params_to_model(self):
        """Make the model whole on every rank (every stage's blocks)."""
        self.runner.sync_params_to_model()

    def export_optimizer_state(self):
        """The optimizer's state in the canonical per-layer layout (the
        keys a dense run writes); every rank calls it."""
        return self.runner.optimizer_state()

    def release(self):
        """Retire the step: the model whole on every rank, the optimizer
        over every parameter again with every slot, so a dense path (or a
        new step) continues from here."""
        self.runner.restore_optimizer()
