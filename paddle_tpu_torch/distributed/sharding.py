"""ZeRO group sharding (counterpart of paddle_tpu/distributed/sharding.py).

The reference marks parameters and lets GSPMD place the optimizer state,
the gradients and the parameters over its ``'sharding'`` mesh axis. Here
each sharding rank is a process, so ZeRO is the runtime protocol of the
original design (Paddle's ``group_sharded_stage{2,3}``), written on the
port's ``collective`` module so that its counters count every gather and
scatter. Each parameter is cut along its first dimension that the degree
``n`` divides (its local shape: an mp slice is cut again); a parameter with
no such dimension keeps its whole state on every rank, with the
reference's warning. Rank ``r`` owns block ``r`` of that dimension.

- ``os`` (stage 1): the optimizer updates only this rank's block of each
  parameter, so every slot (moments, master weights) is ``1/n`` of it;
  gradients are averaged over the sharding group (and dp) whole, and the
  updated blocks are all-gathered into the parameters.
- ``os_g`` (stage 2): as ``os``, and each gradient is reduce-scattered as
  soon as the backward has accumulated it (a post-accumulate-grad hook), so
  a rank keeps only its block of every gradient.
- ``p_g_os`` (stage 3): as ``os_g``, and every parameter of ``ndim >= 2``
  is held as its block alone. A module's blocks are all-gathered before its
  forward and freed after it; the backward gathers them again where an
  operation saved one (a saved-tensor hook keeps a token in place of the
  whole weight), and the gradient of the gathered weight is
  reduce-scattered into the block's. An ``nn.Embedding``'s table may be
  read outside its module (a tied LM head), so it is held gathered for the
  whole forward of the model.
- ``offload=True``: the optimizer's slots and the master update live in
  host memory; each step copies this rank's gradient blocks to the host,
  updates there, and copies the blocks back.

``group_sharded_parallel`` returns ``(model, optimizer, scaler)``: a facade
over the model whose ``state_dict`` keeps the model's names and gives whole
tensors, and a :class:`GroupShardedOptimizer` (``step``, ``clear_grad``,
``state_dict`` in the canonical per-parameter layout). A model that
``fleet.distributed_model`` gave gradient hooks loses them: the sharded
optimizer reduces the gradients itself. ``HybridParallelEngine`` uses the
same optimizer for ZeRO stage 1 over ``sharding_degree``; it and
``PipelineSpmdStep`` keep one that ``group_sharded_parallel`` made, at its
level.
"""
from __future__ import annotations

import contextlib
import os
import warnings
import weakref

import torch
from torch import nn

from . import collective

__all__ = ["group_sharded_parallel", "save_group_sharded_model",
           "GroupShardedOptimizer"]

LEVELS = ("os", "os_g", "p_g_os")


def _shard_dim(shape, n):
    """The first dimension of ``shape`` that ``n`` divides, or None."""
    for d, size in enumerate(shape):
        if size % n == 0:
            return d
    return None


def _block(t, dim, rank, n):
    c = t.shape[dim] // n
    return t.narrow(dim, rank * c, c)


class _Gather(torch.autograd.Function):
    """A block all-gathered along ``dim`` over ``group``; the backward
    reduce-scatters (averages) the whole weight's gradient back into the
    block's."""

    @staticmethod
    def forward(ctx, block, dim, group):
        ctx.dim, ctx.group = dim, group
        return collective.all_gather_axis(block.detach(), group, dim)

    @staticmethod
    def backward(ctx, grad):
        out = collective.reduce_scatter_axis(grad.contiguous(), ctx.group,
                                             ctx.dim)
        return out / ctx.group.nranks, None, None


class GroupShardedOptimizer:
    """The sharded optimizer of the module's docstring over ``optimizer``
    (any of the port's, built over the whole model's parameters), the
    sharding ``group`` and the data-parallel ``dp_group`` (gradients are
    averaged over both). ``step()`` expects gradients as the backward left
    them, summed over this rank's share of the batch."""

    def __init__(self, optimizer, level="os", group=None, dp_group=None,
                 offload=False, model=None):
        if level not in LEVELS:
            raise ValueError(
                f"group_sharded_parallel: unknown level {level!r} "
                "(expected 'os', 'os_g' or 'p_g_os')")
        self.inner_opt = optimizer
        self.level = level
        self.offload = bool(offload)
        self.group = group
        self.dp_group = dp_group
        self.n = group.nranks if group is not None else 1
        self.rank = group.rank if group is not None else 0
        self.params = list(optimizer._parameter_list)
        self.dims, self.views = [], []
        self._grad_blocks = {}
        self._hooks = []
        self._zero3 = {}  # id(param) -> dim, parameters held as a block
        self._persistent = []  # (module, name, param) gathered per model
        self._live = {}  # storage of a gathered weight -> its block
        self._scopes = []
        for i, p in enumerate(self.params):
            dim = None if (p is None or self.n == 1) else \
                _shard_dim(p.shape, self.n)
            if p is not None and self.n > 1 and dim is None:
                warnings.warn(
                    f"ZeRO: no dim of {tuple(p.shape)} divides "
                    f"sharding_degree={self.n}; optimizer state for this "
                    "param stays replicated", stacklevel=3)
            self.dims.append(dim)
        if level == "p_g_os" and self.n > 1:
            self._shard_parameters(model)
        for i, p in enumerate(self.params):
            self.views.append(self._view(i, p))
            if level in ("os_g", "p_g_os") and p is not None and \
                    p.requires_grad and self.dims[i] is not None and \
                    id(p) not in self._zero3:
                self._hooks.append(p.register_post_accumulate_grad_hook(
                    self._scatter_hook(i)))
        self._host = None
        if self.offload:
            self._host = [None if v is None else
                          v.detach().to("cpu").requires_grad_(True)
                          for v in self.views]

    # -- layout ------------------------------------------------------------
    def _view(self, i, p):
        """What the inner optimizer updates for parameter ``i``: this
        rank's block of it (a view), the parameter itself when its state
        is replicated or it is held as a block."""
        if p is None or not p.requires_grad:
            return None
        dim = self.dims[i]
        if dim is None or id(p) in self._zero3:
            return p
        return _block(p.detach(), dim, self.rank, self.n).requires_grad_(
            True)

    def _shard_parameters(self, model):
        """Stage 3: keep this rank's block of every parameter of ``ndim
        >= 2`` and gather it around each forward (module docstring)."""
        if model is None:
            raise ValueError("p_g_os needs the model")
        owner = {}
        for mod in model.modules():
            for name, p in mod.named_parameters(recurse=False):
                owner.setdefault(id(p), []).append((mod, name))
        with torch.no_grad():
            for i, p in enumerate(self.params):
                if p is None or p.dim() < 2 or self.dims[i] is None:
                    continue
                self._zero3[id(p)] = self.dims[i]
                p.zero_full_shape = tuple(p.shape)
                p.zero_shard = (self.dims[i], self.rank, self.n)
                p.data = _block(p.data, self.dims[i], self.rank,
                                self.n).contiguous()
        per_module = {}
        for pid in self._zero3:
            for mod, name in owner.get(pid, ()):
                p = mod._parameters[name]
                if isinstance(mod, nn.Embedding):
                    self._persistent.append((mod, name, p))
                else:
                    per_module.setdefault(mod, []).append((name, p))
        for mod, entries in per_module.items():
            mod.register_forward_pre_hook(self._pre_hook(entries))
            mod.register_forward_hook(self._post_hook(entries))
        model.register_forward_pre_hook(
            lambda m, a: self._enter_scope())
        model.register_forward_hook(
            lambda m, a, o: self._exit_scope())

    def _gathered(self, p):
        full = _Gather.apply(p, self._zero3[id(p)], self.group)
        self._live[full.untyped_storage().data_ptr()] = p
        return full

    def _release(self, full):
        self._live.pop(full.untyped_storage().data_ptr(), None)

    def _pre_hook(self, entries):
        def hook(mod, args):
            for name, p in entries:
                mod._parameters[name] = self._gathered(p)
        return hook

    def _post_hook(self, entries):
        def hook(mod, args, out):
            for name, p in entries:
                self._release(mod._parameters[name])
                mod._parameters[name] = p
        return hook

    def _pack(self, t):
        """Saved-tensor hook: a gathered weight (or a view of one) is
        saved as a token that :meth:`_unpack` gathers again."""
        if not self._zero3 or t.dim() == 0:
            return t
        key = t.untyped_storage().data_ptr()
        hit = self._live.get(key)
        if hit is None:
            return t
        return ("zero3", hit, tuple(t.shape), tuple(t.stride()),
                t.storage_offset())

    def _unpack(self, x):
        if not (isinstance(x, tuple) and x and x[0] == "zero3"):
            return x
        _, p, shape, stride, offset = x
        with torch.no_grad():
            full = collective.all_gather_axis(p.detach(), self.group,
                                              self._zero3[id(p)])
        return full.as_strided(shape, stride, offset)

    def _enter_scope(self):
        """Around the model's forward: gather the persistent tables and
        save gathered weights as tokens."""
        saved = []
        for mod, name, p in self._persistent:
            full = self._gathered(p)
            mod._parameters[name] = full
            saved.append((mod, name, p))
        ctx = torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                       self._unpack)
        ctx.__enter__()
        self._scopes.append((ctx, saved))

    def _exit_scope(self):
        ctx, saved = self._scopes.pop()
        ctx.__exit__(None, None, None)
        for mod, name, p in saved:
            self._release(mod._parameters[name])
            mod._parameters[name] = p

    @contextlib.contextmanager
    def forward_scope(self):
        """The model's forward scope for a caller that runs its parts
        without calling the model (a pipeline stage)."""
        if not self._zero3:
            yield
            return
        self._enter_scope()
        try:
            yield
        finally:
            self._exit_scope()

    # -- gradients ---------------------------------------------------------
    def _scatter_hook(self, i):
        # a weak reference: the autograd engine holds the hook where the
        # cycle collector cannot see it, so a strong one would keep this
        # optimizer (and its slots) alive for as long as the parameter
        ref = weakref.ref(self)

        def hook(p):
            zero = ref()
            if zero is None:
                return
            g = p.grad
            p.grad = None
            block = collective.reduce_scatter_axis(
                g.contiguous(), zero.group, zero.dims[i]) / zero.n
            have = zero._grad_blocks.get(i)
            zero._grad_blocks[i] = block if have is None else have + block
        return hook

    def grad_holder(self, i, create=False):
        """The tensor holding parameter ``i``'s gradient as this rank keeps
        it (its block at os_g / p_g_os, else the whole gradient), or None;
        ``create``: zeros of that shape where the backward left none (a
        parameter this pipeline stage did not use)."""
        p = self.params[i]
        if i in self._grad_blocks:
            return self._grad_blocks[i]
        if p is None or p.grad is not None or not create:
            return None if p is None else p.grad
        if self.level == "os" or self.dims[i] is None or id(p) in self._zero3:
            p.grad = torch.zeros_like(p)
            return p.grad
        self._grad_blocks[i] = torch.zeros_like(
            _block(p.detach(), self.dims[i], self.rank, self.n))
        return self._grad_blocks[i]

    def restrict(self, keep):
        """Update only the parameters whose ids are in ``keep`` (a
        pipeline stage's); None: every parameter again."""
        for i, p in enumerate(self.params):
            if keep is not None and (p is None or id(p) not in keep):
                self.views[i] = None
                if self._host is not None:
                    self._host[i] = None
            elif self.views[i] is None and p is not None:
                self.views[i] = self._view(i, p)
                if self._host is not None and self.views[i] is not None:
                    self._host[i] = self.views[i].detach().to(
                        "cpu").requires_grad_(True)

    def _reduced_grads(self):
        """This rank's gradient block of every parameter, averaged over
        the sharding group and dp."""
        out = {}
        for i, p in enumerate(self.params):
            v = self.views[i]
            if v is None:
                continue
            dim = self.dims[i]
            if i in self._grad_blocks:
                g = self._grad_blocks.pop(i)
            elif p.grad is None:
                continue
            elif id(p) in self._zero3:
                g = p.grad  # _Gather's backward scattered it already
            else:
                g = p.grad
                if dim is not None or self.n > 1:
                    collective.all_reduce(g, collective.ReduceOp.AVG,
                                          group=self.group)
                if dim is not None:
                    g = _block(g, dim, self.rank, self.n)
            if self.dp_group is not None and self.dp_group.nranks > 1:
                g = g.contiguous()
                collective.all_reduce(g, collective.ReduceOp.AVG,
                                      group=self.dp_group)
            out[i] = g
        return out

    # -- the step ------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        grads = self._reduced_grads()
        opt = self.inner_opt
        targets = self._host if self.offload else self.views
        for i, g in grads.items():
            t = targets[i]
            t.grad = g.to(t.device, t.dtype) if t is not self.params[i] \
                or self.offload else g
        saved = opt._parameter_list
        opt._parameter_list = list(targets)
        try:
            opt.step()
        finally:
            opt._parameter_list = saved
        for i in grads:
            if self.offload:
                self.views[i].copy_(self._host[i])
                self._host[i].grad = None
            elif targets[i] is not self.params[i]:
                targets[i].grad = None
        self._gather_params(grads)

    def _gather_params(self, updated):
        for i in updated:
            p, dim = self.params[i], self.dims[i]
            if dim is None or id(p) in self._zero3:
                continue
            full = collective.all_gather_axis(
                self.views[i].detach().contiguous(), self.group, dim)
            p.data.copy_(full)

    def clear_grad(self, set_to_zero=False):
        for p in self.params:
            if p is not None:
                p.grad = None
        self._grad_blocks.clear()

    clear_gradients = clear_grad

    def __getattr__(self, k):
        return getattr(self.__dict__["inner_opt"], k)

    # -- state ---------------------------------------------------------------
    def state_dict(self):
        """The whole optimizer state in the canonical per-parameter layout
        (``"<slot>/p<i>"`` by position in the model's parameter list): every
        block all-gathered over the sharding group. Every rank calls it."""
        sd = {}
        for key, v in self.inner_opt.state_dict().items():
            if isinstance(v, torch.Tensor):
                i = int(key.rpartition("/p")[2])
                dim = self.dims[i]
                if dim is not None and self.n > 1:
                    v = collective.all_gather_axis(
                        v.detach().to(self.params[i].device).contiguous(),
                        self.group, dim)
            sd[key] = v
        return sd

    def set_state_dict(self, state_dict):
        """Restore from :meth:`state_dict` (whole slots): each rank keeps
        its blocks."""
        local = {}
        for key, v in state_dict.items():
            if isinstance(v, torch.Tensor) and "/p" in key:
                i = int(key.rpartition("/p")[2])
                if self.dims[i] is not None and self.n > 1:
                    v = _block(v, self.dims[i], self.rank, self.n)
            local[key] = v
        saved = self.inner_opt._parameter_list
        self.inner_opt._parameter_list = list(
            self._host if self.offload else self.views)
        try:
            self.inner_opt.set_state_dict(local)
        finally:
            self.inner_opt._parameter_list = saved

    def held_bytes(self):
        """``{"params", "grads", "optimizer"}``: bytes of the tensors this
        rank holds on the parameters' device (the optimizer's slots on the
        host under offload count 0)."""
        dev = next(p.device for p in self.params if p is not None)

        def nbytes(t):
            return t.numel() * t.element_size() if t.device == dev else 0

        params = sum(nbytes(p.data) for p in self.params if p is not None)
        grads = sum(nbytes(self.grad_holder(i)) for i in
                    range(len(self.params))
                    if self.grad_holder(i) is not None)
        opt = sum(nbytes(t) for store in
                  self.inner_opt._accumulators.values()
                  for t in store.values())
        return {"params": params, "grads": grads, "optimizer": opt}

    def full_parameter(self, i):
        """Parameter ``i`` whole (gathered when it is held as a block)."""
        p = self.params[i]
        if id(p) not in self._zero3:
            return p.detach()
        return collective.all_gather_axis(p.detach(), self.group,
                                          self._zero3[id(p)])


class _GroupShardedModel(nn.Module):
    """The facade ``group_sharded_parallel`` returns: its forward is the
    model's, its ``state_dict`` the model's names with whole tensors
    (parameters held as blocks all-gathered: every rank calls it), and any
    other attribute resolves on the model."""

    def __init__(self, layer, level, optimizer):
        super().__init__()
        self._layers = layer
        self._level = level
        self.__dict__["_zero"] = optimizer

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def state_dict(self, *a, **k):
        sd = self._layers.state_dict(*a, **k)
        zero = self.__dict__["_zero"]
        pos = {id(p): i for i, p in enumerate(zero.params)
               if p is not None}
        params = dict(self._layers.named_parameters())
        out = {}
        for name, t in sd.items():
            p = params.get(name)
            held = p is not None and id(p) in zero._zero3
            out[name] = zero.full_parameter(pos[id(p)]) if held else t
        return out

    def set_state_dict(self, sd, *a, **k):
        zero = self.__dict__["_zero"]
        own = dict(self._layers.named_parameters())
        local = {}
        for name, v in sd.items():
            p = own.get(name)
            if p is not None and id(p) in zero._zero3:
                dim, rank, n = p.zero_shard
                v = _block(torch.as_tensor(v), dim, rank, n)
            local[name] = v
        return self._layers.load_state_dict(local, *a, **k)

    load_state_dict = set_state_dict

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["_layers"], name)


def _fleet_groups(group, dp_group):
    from . import fleet

    hcg = fleet.get_hybrid_communicate_group()
    if group is None:
        group = hcg.get_sharding_parallel_group() if hcg is not None \
            else collective.get_group(0)
    if dp_group is None and hcg is not None:
        dp_group = hcg.get_data_parallel_group()
    return group, dp_group


def group_sharded_parallel(model, optimizer, level="os_g", scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """``paddle.distributed.sharding.group_sharded_parallel``: ZeRO at
    ``level`` (``"os"``, ``"os_g"`` or ``"p_g_os"``) over ``group``
    (default: the fleet's sharding group, else the world), gradients also
    averaged over ``dp_group`` (default: the fleet's dp group). Returns
    ``(model, optimizer, scaler)`` as the reference does.

    ``buffer_max_size`` / ``segment_size`` (bucket tuning) change nothing
    here; ``sync_buffers`` is met by construction (every rank starts from
    the same buffers). ``sync_comm`` and ``exclude_layer`` raise, as the
    reference's do."""
    if level not in LEVELS:
        raise ValueError(
            f"group_sharded_parallel: unknown level {level!r} "
            "(expected 'os', 'os_g' or 'p_g_os')")
    if sync_comm:
        raise NotImplementedError(
            "group_sharded_parallel(sync_comm=True) is not supported: every "
            "gather and scatter here completes before the call that "
            "issues it returns; remove the flag")
    if exclude_layer:
        raise NotImplementedError(
            "group_sharded_parallel(exclude_layer=...) is not supported: "
            "every parameter of the optimizer is sharded")
    inner = getattr(optimizer, "inner_opt", optimizer)
    if isinstance(inner, GroupShardedOptimizer):
        inner = inner.inner_opt
    sync = getattr(model, "_grad_sync", None)
    if sync is not None:  # the sharded optimizer reduces the gradients
        sync.remove()
        model._grad_sync = None
    group, dp_group = _fleet_groups(group, dp_group)
    zero = GroupShardedOptimizer(inner, level, group, dp_group, offload,
                                 model=model)
    return _GroupShardedModel(model, level, zero), zero, scaler


def save_group_sharded_model(model, output, optimizer=None):
    """Write ``output/model.pdparams`` (the whole model, the reference's
    names and layout) and, with ``optimizer``, ``output/model.pdopt`` (its
    whole state, the reference's keys), as ``framework.save`` pickles the
    reference reads. A collective: every sharding rank calls it, and rank 0
    of the world writes."""
    from .. import convert, framework
    from . import parallel_env

    inner = model._layers if isinstance(model, _GroupShardedModel) \
        else model
    state = convert.state_to_paddle_tpu(inner, model.state_dict())
    opt_state = None if optimizer is None else \
        convert.optimizer_state_to_paddle_tpu(optimizer, inner)
    if parallel_env.get_rank() == 0:
        os.makedirs(output, exist_ok=True)
        framework.save(state, os.path.join(output, "model.pdparams"))
        if opt_state is not None:
            framework.save(opt_state, os.path.join(output, "model.pdopt"))
