"""Hybrid-parallel training engine, dp x pp x sharding x mp (counterpart of
paddle_tpu/distributed/fleet/hybrid_engine.py).

``HybridParallelEngine(model, optimizer, hcg, strategy, criterion,
stage_layers)`` and ``engine.train_batch([tokens, labels], scaler=None)``,
as in the reference. Each rank is a process (``distributed.pp_spmd``'s
stage runtime): rank ``s`` of the pipe group holds its stage's blocks, and
the microbatch schedule is 1F1B, the reference's three phases: ``pp - 1``
forward-only warm-up ticks, ``M`` steady ticks of one forward and one
backward each, and ``pp - 1`` backward-only drain ticks (stage ``s`` runs
the forward of microbatch ``i`` at tick ``i + s`` and its backward at
``i + 2(pp - 1) - s``), so at most ``2(pp - 1 - s) + 1 <= 2 pp - 1``
microbatches are in flight on stage ``s``; ``live_inputs_max`` and the
``pp.max_live_inputs`` gauge give the most the last step held. Unlike the
reference, a stage keeps each in-flight microbatch's autograd graph
instead of recomputing its forward in the backward, so each stage runs its
forward once per microbatch.

Stage slicing: an explicit ``stage_layers`` split (``pp > 1``: one group of
sublayers per stage, the first group starting with the token embedding;
every stage maps one boundary shape ``A -> A``; the criterion supplies the
head and the loss; every parameter is kept on every stage and its
gradient summed over the pipe group), a ``PipelineLayer``, a model with
``pipeline_parts`` or a uniform block stack, or, at ``pp = 1``, any model
with a criterion (the generic mode). ``accumulate_steps`` is
``max(strategy.pipeline_configs["accumulate_steps"], pp)``.

ZeRO: with ``sharding_degree > 1`` the optimizer's moments are sharded over
the sharding group (stage 1, ``sharding.GroupShardedOptimizer`` at
``"os"``; a parameter no dimension of which the degree divides keeps its
state whole, with the reference's warning); an optimizer from
``group_sharded_parallel`` keeps its level and ``offload``. Gradients are
averaged over dp x sharding.

``train_batch(scaler=)``: the loss seeds the backward scaled by the
``GradScaler``'s scale; the gradients are unscaled, one non-finite value on
any rank skips the update on every rank, and the scaler's state machine
(the reference's) runs on the host: ``sync_scaler()`` returns it.
``sync_params_to_model()`` makes the model whole on every rank and
``state_dict()`` returns the whole model's state.
"""
from __future__ import annotations

import torch

from ...profiler import registry as _registry
from .. import collective

__all__ = ["HybridParallelEngine"]


class HybridParallelEngine:
    """See the module's docstring. Usage::

        engine = HybridParallelEngine(model, optimizer, hcg, strategy,
                                      criterion)
        loss = engine.train_batch([tokens, labels])
    """

    def __init__(self, model, optimizer, hcg, strategy=None, criterion=None,
                 stage_layers=None):
        from ..pp_spmd import unwrap

        self.model = model
        self.optimizer = unwrap(model, optimizer)[1]
        self.hcg = hcg
        self.strategy = strategy
        self.criterion = criterion
        self.pp = hcg.get_pipe_parallel_world_size()
        self._stage_layers = stage_layers if self.pp > 1 else None
        self.accumulate_steps = max(
            (strategy.pipeline_configs.get("accumulate_steps", 1)
             if strategy else 1), self.pp)
        self._scaler = None
        self._built = False
        self._checked = False
        self.live_inputs_max = 0

    # -- build ------------------------------------------------------------
    def _build(self):
        from .. import fleet
        from ..pp_spmd import StageRunner, model_parts, publish_gauges, unwrap
        from ..sharding import GroupShardedOptimizer

        model = unwrap(self.model, None)[0]
        sync = getattr(model, "_grad_sync", None)
        if sync is not None:  # the engine reduces the gradients itself
            sync.remove()
            model._grad_sync = None
        if self.hcg.get_model_parallel_world_size() > 1:
            fleet._shard_in_place(model, self.hcg)
        opt = self.optimizer
        groups = None
        if self._stage_layers is not None:
            parts, groups = self._het_parts(model)
        else:
            parts = model_parts(model, self.pp, self.criterion,
                                op="HybridParallelEngine", generic=True)
        if self.hcg.get_sharding_parallel_world_size() > 1 and \
                not isinstance(opt, GroupShardedOptimizer):
            opt = GroupShardedOptimizer(
                opt, "os", self.hcg.get_sharding_parallel_group(),
                self.hcg.get_data_parallel_group(), model=model)
        self.optimizer = opt
        self._groups = groups
        self.runner = StageRunner(model, opt, self.hcg, parts, groups)
        publish_gauges(self.runner, self.accumulate_steps)
        self._built = True

    def _het_parts(self, model):
        sl = self._stage_layers
        if len(sl) != self.pp:
            raise ValueError(
                f"stage_layers has {len(sl)} groups; pp_degree is "
                f"{self.pp} — provide exactly one sublayer group per "
                "pipeline stage")
        if not sl[0]:
            raise ValueError("stage_layers[0] must start with the "
                             "token-embedding sublayer")
        if self.criterion is None:
            raise ValueError(
                "heterogeneous pipeline (stage_layers) needs a "
                "criterion(out, labels) providing the head + loss")
        if self.hcg.get_model_parallel_world_size() > 1:
            raise ValueError(
                "heterogeneous pipeline does not compose with mp>1: use "
                "the uniform-trunk or PipelineLayer path for mp")
        covered = {id(p) for g in sl for lay in g
                   for p in lay.parameters()}
        if isinstance(self.criterion, torch.nn.Module):
            covered |= {id(p) for p in self.criterion.parameters()}
        missing = [name for name, p in model.named_parameters()
                   if id(p) not in covered and p.requires_grad]
        if missing:
            raise ValueError(
                "stage_layers does not cover these trainable model "
                f"params (they would be silently frozen): {missing}; "
                "add the owning sublayers to a stage group, or mark "
                "the params stop_gradient if freezing is intended")
        embed = sl[0][0]
        groups = [list(sl[0][1:])] + [list(g) for g in sl[1:]]
        return (embed, [], lambda x: x, self.criterion), groups

    def _check_het(self, tok):
        """Every stage maps the boundary shape ``A -> A`` (each rank holds
        every group, so each checks all of them alike before any
        transfer)."""
        if self._checked or self._stage_layers is None:
            return
        self._checked = True
        with torch.no_grad():
            a = self.runner.embed(tok)
            for s, g in enumerate(self._groups):
                x = a
                for lay in g:
                    x = lay(x)
                if (tuple(x.shape), x.dtype) != (tuple(a.shape), a.dtype):
                    raise ValueError(
                        f"heterogeneous pipeline stage {s} maps "
                        f"{tuple(a.shape)}/{a.dtype} -> {tuple(x.shape)}/"
                        f"{x.dtype}; every stage must map the shared "
                        "boundary shape A -> A (put the head projection "
                        "in the criterion)")

    # -- the step -----------------------------------------------------------
    def train_batch(self, data, optimizer=None, lr_scheduler=None,
                    scaler=None):
        from .. import spmd

        use_scaler = scaler is not None and scaler.is_enable()
        if not self._built:
            self._scaler = scaler if use_scaler else None
            self._build()
        elif use_scaler != (self._scaler is not None):
            raise RuntimeError(
                "train_batch scaler presence changed after the step was "
                "compiled; pass the scaler from the first call on")
        runner = self.runner
        dev = next((p.device for p in runner.all_params if p.numel()),
                   torch.device("cpu"))
        toks = spmd.shard_batch(torch.as_tensor(data[0]), self.hcg).to(dev)
        labels = spmd.shard_batch(torch.as_tensor(data[1]),
                                  self.hcg).to(dev)
        M = self.accumulate_steps
        if toks.shape[0] % M:
            raise ValueError(
                f"batch rows {toks.shape[0]} on this rank are not "
                f"divisible by accumulate_steps={M}")
        self._check_het(toks.chunk(M, 0)[0])
        runner.clear_grad()
        scale = self._scaler._scale if self._scaler is not None else None
        loss = runner.run(toks, labels, M, "1f1b", scale=scale)
        runner.reduce_grads()
        if self._scaler is None or not self._unscale_found_inf():
            runner.step()
        if self._scaler is not None:
            self._scaler.update()
        runner.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        self.live_inputs_max = runner.live_max
        _registry.gauge_set("pp.max_live_inputs", runner.live_max)
        _registry.gauge_set("pp.permute_bytes_per_step", runner.sent)
        return loss

    __call__ = train_batch

    @torch.no_grad()
    def _unscale_found_inf(self):
        """Unscale this rank's gradients; whether any rank found a
        non-finite value (every rank then skips the update)."""
        sc = self._scaler
        runner = self.runner
        bad = None
        holders = runner.grads()
        for _, g in holders:
            u = g.float() / sc._scale
            g.copy_(u.to(g.dtype))
            b = (~torch.isfinite(u)).any()
            bad = b if bad is None else bad | b
        flag = torch.zeros((), dtype=torch.float32,
                           device=holders[0][1].device if holders
                           else "cpu")
        if bad is not None:
            flag.fill_(float(bad))
        collective.all_reduce(flag, collective.ReduceOp.MAX,
                              group=collective.get_group(0))
        sc._found_inf = bool(flag.item())
        return sc._found_inf

    def sync_scaler(self):
        """The ``GradScaler`` (its state lives on the host already)."""
        return self._scaler

    def sync_params_to_model(self):
        """Make the model whole on every rank (every stage's blocks)."""
        if self._built:
            self.runner.sync_params_to_model()

    def state_dict(self):
        """The whole model's ``state_dict()`` (port layout, host tensors);
        every rank calls it."""
        if not self._built:
            return {k: v.detach().cpu()
                    for k, v in self.model.state_dict().items()}
        return self.runner.full_state()
