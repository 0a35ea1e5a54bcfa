"""Carry weights and optimizer state between the JAX package and the port.

``state_from_paddle_tpu`` turns a ``paddle_tpu`` model's ``state_dict()`` —
as ``{name: numpy array}``, or the path of a ``paddle_tpu.framework.save``
pickle of it — into ``{name: torch.Tensor}`` named like the port's modules;
``load_paddle_tpu_state`` checks it against a port model and copies it in.
``optimizer_state_from_paddle_tpu`` does the same for an optimizer's state.
The other way, ``state_to_paddle_tpu`` and ``optimizer_state_to_paddle_tpu``
give a port model's and optimizer's state in the reference's names and
layout (what ``incubate.checkpoint`` writes).

Name mapping: the reference's layer names are the port's module names, so
names map one to one (GPT, BERT, ERNIE, the transformer and fused layers);
a wrapper's trunk prefix (``gpt.``, ``bert.``, ``ernie.``: the reference's
``GPTForPretraining``, ``BertForPretraining`` and
``ErnieForSequenceClassification`` save their trunk under it) is accepted
either way. Layout: the reference's Linear stores its weight ``[in, out]``,
torch's ``[out, in]``, so every 2-D weight of a Linear is transposed; a
fused layer's packed ``qkv_proj`` is one Linear whose output columns are
``[3, heads, head_dim]`` in both packages, so the transpose is all it
takes. The recurrent layers' weights (``weight_ih_l0 [gates * H, in]``,
...) are stored alike in both packages and are not Linear weights, so they
are carried as they are. A tied weight (BERT's LM head shares the word
embeddings') is one parameter listed once, under the embeddings' name, in
both packages.

A model sharded for tensor parallelism (``fleet.distributed_model``:
parameters carrying ``mp_shard``) takes a full reference state as this
rank's slices (``state_from_paddle_tpu``), and
``merged_state_to_paddle_tpu`` gathers every rank's slices back into the
full reference state (a collective: every mp rank calls it). An MoE
model at expert parallelism (banks carrying ``ep_shard``) takes this ep
rank's experts of a full reference state the same way, and
``merged_state_to_paddle_tpu`` gathers the ``[E, ...]`` banks back over the
fleet's ep group. A pipeline step, an engine and ZeRO give their whole
state themselves (``PipelineSpmdStep.state_dict`` /
``export_optimizer_state``, ``HybridParallelEngine.state_dict``,
``save_group_sharded_model``); :func:`slice_stage_state`,
:func:`slice_expert_state` and :func:`slice_zero_state` cut a whole
reference state into one rank's part for those forms, and
:func:`merge_stage_states` puts stages' parts back together.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch
from torch import nn


def _leaf(v):
    """A numpy array from one state entry: an array, a torch tensor, a
    tensor-like with ``.numpy()``, or a ``framework.save`` tensor record.
    bf16 values (torch's or ``ml_dtypes``') are widened to float32, which
    is exact."""
    if isinstance(v, dict) and v.get("__tensor__"):
        v = v["data"]
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        v = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    elif hasattr(v, "numpy") and not isinstance(v, np.ndarray):
        v = v.numpy()
    a = np.asarray(v)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


# the trunk prefixes of the reference's model wrappers
_TRUNK_PREFIXES = ("gpt.", "bert.", "ernie.")


def _own_name(name, own):
    """``name`` as ``own`` (a state dict's keys) spells it: with a trunk
    prefix added or removed where only that form exists."""
    if name in own:
        return name
    for prefix in _TRUNK_PREFIXES:
        if name.startswith(prefix) and name[len(prefix):] in own:
            return name[len(prefix):]
        if prefix + name in own:
            return prefix + name
    return name


def _linear_weight_names(model):
    return {f"{name}.weight" for name, mod in model.named_modules()
            if isinstance(mod, nn.Linear)}


def state_from_paddle_tpu(np_state, model):
    """``{name: tensor}`` for ``model`` from a reference state.

    ``np_state``: a dict of name -> array (or a path to a
    ``paddle_tpu.framework.save`` pickle of one). Names may carry a
    reference wrapper's trunk prefix (``gpt.``, ``bert.``, ``ernie.``)
    where ``model`` has none, or lack it where ``model`` has it. Linear
    weights are transposed to ``[out, in]`` and every array is cast to the
    dtype and moved to the device of the parameter it fills. Raises
    ``KeyError`` for a missing or an extra name and ``ValueError`` for a
    shape mismatch."""
    if isinstance(np_state, (str, os.PathLike)):
        # only for checkpoints written by paddle_tpu.framework.save:
        # unpickling runs code, so never point this at foreign files
        with open(np_state, "rb") as f:
            np_state = pickle.load(f)
    if not isinstance(np_state, dict):
        raise TypeError(f"expected a dict of name -> array, got "
                        f"{type(np_state).__name__}")
    own = dict(model.state_dict())
    src = {}
    for name, value in np_state.items():
        src[_own_name(name, own)] = value
    missing = sorted(set(own) - set(src))
    extra = sorted(set(src) - set(own))
    if missing or extra:
        raise KeyError(f"state does not match the model: missing {missing[:5]}"
                       f"{' ...' if len(missing) > 5 else ''}, extra "
                       f"{extra[:5]}{' ...' if len(extra) > 5 else ''}")
    linear = _linear_weight_names(model)
    shards = _mp_shards(model)
    experts = {name: p.ep_shard for name, p in model.named_parameters()
               if getattr(p, "ep_shard", None) is not None}
    out = {}
    for name, target in own.items():
        arr = _leaf(src[name])
        if name in linear:
            arr = arr.T
        if name in shards:
            dim, layout, rank, n = shards[name]
            arr = _local_shard(torch.from_numpy(np.array(arr)), dim, rank, n,
                               layout).numpy()
        if name in experts:
            dim, rank, n = experts[name]
            arr = _local_shard(torch.from_numpy(np.array(arr)), dim, rank,
                               n).numpy()
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"shape mismatch for {name!r}: model holds "
                             f"{tuple(target.shape)}, state gives "
                             f"{tuple(arr.shape)}"
                             + (" (after the [in, out] -> [out, in] "
                                "transpose)" if name in linear else ""))
        out[name] = torch.from_numpy(np.array(arr, order="C")).to(
            device=target.device, dtype=target.dtype)
    return out


def _mp_shards(model):
    """``{state name: (dim, layout, rank, nranks)}`` of the parameters
    ``spmd.shard_model`` sliced."""
    return {name: p.mp_shard for name, p in model.named_parameters()
            if getattr(p, "mp_shard", None) is not None}


def _local_shard(*args):
    from .distributed.spmd import local_shard

    return local_shard(*args)


def merged_state_to_paddle_tpu(model, group=None):
    """:func:`state_to_paddle_tpu` of the whole model from a sharded one:
    every sliced parameter all-gathered over the mp ``group`` (default: the
    fleet's) and put back together. Every rank of the group must call it;
    each gets the full state, as host tensors."""
    from .distributed import collective, spmd
    from .distributed.meta_parallel.mp_ops import mp_group

    group = mp_group(group)
    shards = _mp_shards(model)
    experts = {name: p.ep_shard for name, p in model.named_parameters()
               if getattr(p, "ep_shard", None) is not None}
    full = {}
    for name, t in model.state_dict().items():
        t = t.detach()
        if name in shards:
            dim, layout, _, _ = shards[name]
            parts = []
            collective.all_gather(parts, t.contiguous(), group=group)
            t = spmd.merge_shards(parts, dim, layout)
        if name in experts:
            t = collective.all_gather_axis(t.contiguous(), "ep",
                                           experts[name][0])
        full[name] = t.cpu()
    linear = _linear_weight_names(model)
    return {name: t.t() if name in linear else t
            for name, t in full.items()}


def slice_stage_state(np_state, model, pp, stage):
    """The entries of a whole reference state that pipeline stage
    ``stage`` of ``pp`` holds: its blocks of the trunk
    (``model.pipeline_parts`` / the uniform block stack) and every other
    entry (each stage keeps the embeddings, the final norm and the head)."""
    from .distributed.pp_spmd import model_parts

    _, blocks, _, _ = model_parts(model, pp, None)
    Ls = len(blocks) // pp
    names = {id(p): n for n, p in model.named_parameters()}
    foreign = {names[id(p)] for j, b in enumerate(blocks)
               if j // Ls != stage for p in b.parameters()}
    own = dict(model.state_dict())
    return {k: v for k, v in np_state.items()
            if _own_name(k, own) not in foreign}


def merge_stage_states(parts):
    """One state from the stages' parts (each entry from the first part
    that holds it)."""
    out = {}
    for part in parts:
        for k, v in part.items():
            out.setdefault(k, v)
    return out


def slice_expert_state(np_state, model, ep, rank):
    """A whole reference state with every expert bank (``w1``, ``b1``,
    ``w2``, ``b2`` of an ``MoEMLP``) cut to expert rank ``rank``'s
    ``E/ep`` experts; other entries as they are."""
    from .nn.moe import MoEMLP

    banks = {f"{n}.{b}" for n, m in model.named_modules()
             if isinstance(m, MoEMLP) for b in ("w1", "b1", "w2", "b2")}
    own = dict(model.state_dict())
    out = {}
    for k, v in np_state.items():
        if _own_name(k, own) in banks:
            a = _leaf(v)
            c = a.shape[0] // ep
            v = a[rank * c:(rank + 1) * c]
        out[k] = v
    return out


def slice_zero_state(np_opt_state, optimizer, n, rank):
    """A whole optimizer state (``"<slot>/p<i>"``) cut to ZeRO rank
    ``rank`` of ``n``: each slot's block along its parameter's first
    dimension ``n`` divides (the port's layout, as
    ``sharding.GroupShardedOptimizer`` cuts it)."""
    from .distributed.sharding import _shard_dim

    params = optimizer._parameter_list
    out = {}
    for k, v in np_opt_state.items():
        if isinstance(v, (torch.Tensor, np.ndarray)) and "/p" in k:
            t = torch.as_tensor(np.asarray(_leaf(v)))
            d = _shard_dim(tuple(params[int(k.rpartition("/p")[2])].shape),
                           n)
            if d is not None:
                c = t.shape[d] // n
                t = t.narrow(d, rank * c, c)
            v = t
        out[k] = v
    return out


def load_paddle_tpu_state(model, np_state):
    """Copy a reference state into ``model`` in place (see
    :func:`state_from_paddle_tpu`); returns ``model``."""
    model.load_state_dict(state_from_paddle_tpu(np_state, model), strict=True)
    return model


def _linear_weight_ids(model):
    return {id(mod.weight) for mod in model.modules()
            if isinstance(mod, nn.Linear)}


def optimizer_state_from_paddle_tpu(np_opt_state, optimizer, model):
    """A state dict for ``optimizer.set_state_dict`` from the reference's
    ``state_dict()`` of the same optimizer class (slots as arrays or
    tensor-likes): any of SGD, Momentum, Lars, Adam, AdamW, Adamax,
    Adagrad, Adadelta, RMSProp and Lamb.

    Slot ``"<acc>/p<i>"`` belongs to parameter ``i`` of ``optimizer``, which
    must list the parameters in the reference's order. Every parameter
    that takes gradients needs every slot the optimizer keeps for it
    (``optimizer._slots``: Adam's ``moment1`` and ``moment2``, and
    ``master_weight`` where it keeps one; Momentum's ``velocity``; ...),
    each cast to that slot's dtype. Slots of a Linear weight of ``model``
    are transposed from ``[in, out]`` to ``[out, in]`` as the weight itself
    is; ``model`` says which parameters those are, since a square weight
    cannot be told by its shape.
    ``_opt_step`` and ``LR_Scheduler`` are carried as they are. Raises
    ``KeyError`` for a missing or an extra slot and ``ValueError`` for a
    mis-shaped one."""
    params = optimizer._parameter_list
    linear = _linear_weight_ids(model)
    want = {}
    for i, p in enumerate(params):
        if p is None or not p.requires_grad:
            continue
        want.update({f"{name}/p{i}": (i, dtype)
                     for name, dtype, _ in optimizer._slots(p)})
    given = {k for k in np_opt_state if k not in ("_opt_step",
                                                   "LR_Scheduler")}
    missing, extra = sorted(set(want) - given), sorted(given - set(want))
    if missing or extra:
        raise KeyError(f"optimizer state does not match: missing "
                       f"{missing[:5]}{' ...' if len(missing) > 5 else ''}, "
                       f"extra {extra[:5]}{' ...' if len(extra) > 5 else ''}")
    out = {"_opt_step": int(np_opt_state.get("_opt_step", 0))}
    if "LR_Scheduler" in np_opt_state:
        out["LR_Scheduler"] = dict(np_opt_state["LR_Scheduler"])
    for key, (i, dtype) in want.items():
        p = params[i]
        arr = _leaf(np_opt_state[key])
        if id(p) in linear:
            arr = arr.T
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"shape mismatch for slot {key!r}: parameter "
                             f"{i} is {tuple(p.shape)}, state gives "
                             f"{tuple(arr.shape)}"
                             + (" (after the [in, out] -> [out, in] "
                                "transpose)" if id(p) in linear else ""))
        out[key] = torch.from_numpy(np.array(arr, np.float32, order="C")).to(
            device=p.device, dtype=dtype)
    return out


def state_to_paddle_tpu(model, state=None):
    """``model``'s state in the reference's names and layout: its
    ``state_dict()`` (or ``state``, a whole state in the port's layout
    under ``model``'s names, as a pipeline step or a ZeRO facade gathers
    it) with every Linear weight transposed to ``[in, out]`` (found by
    module type: a square weight cannot be told by its shape). The
    tensors alias the given ones (Linear weights as transposed views);
    ``framework.save`` snapshots them."""
    linear = _linear_weight_names(model)
    state = model.state_dict() if state is None else state
    return {name: t.t() if name in linear else t
            for name, t in state.items()}


def optimizer_state_to_paddle_tpu(optimizer, model, state=None,
                                  params=None):
    """``optimizer.state_dict()`` (or ``state``, a whole optimizer state
    in the port's layout) in the reference's layout: the slots of a Linear
    weight of ``model`` transposed to ``[in, out]`` as the weight is; slot
    ``"<accumulator>/p<i>"`` belongs to ``params[i]`` (default: the
    optimizer's parameter list). Keys (``"<accumulator>/p<i>"``,
    ``_opt_step``, ``LR_Scheduler``) are the reference's already, for
    every optimizer of the port."""
    params = optimizer._parameter_list if params is None else params
    linear = _linear_weight_ids(model)
    out = {}
    state = optimizer.state_dict() if state is None else state
    for key, value in state.items():
        if isinstance(value, torch.Tensor):
            i = int(key.rpartition("/p")[2])
            if id(params[i]) in linear:
                value = value.t()
        elif isinstance(value, dict):
            value = dict(value)
        out[key] = value
    return out


def static_scope_from_paddle_tpu(ref_vars, ref_program, program, scope=None,
                                 device="cpu"):
    """Fill the port's scope with a static Program's parameters from the
    reference's: ``ref_vars`` is the reference's scope as ``{name: numpy
    array}`` (``paddle_tpu.static.global_scope().vars`` after its startup
    run), ``ref_program`` and ``program`` the same Program recorded by
    each package. Parameters match by their position in
    ``program.params``, not by name: ``static.nn``'s auto names come from
    a process-wide counter in each package. Layouts agree (``static.nn.fc``
    keeps the reference's ``[in, out]``). A Program recorded from a model
    reads the model's own parameters: carry those with
    :func:`load_paddle_tpu_state` before recording. Returns the scope."""
    from .static import global_scope
    from .static.program import recording_suspended

    scope = scope or global_scope()
    with recording_suspended():
        _fill_scope(ref_vars, ref_program, program, scope, device)
    return scope


def _fill_scope(ref_vars, ref_program, program, scope, device):
    if len(ref_program.params) != len(program.params):
        raise ValueError(f"the reference Program has "
                         f"{len(ref_program.params)} parameters, this one "
                         f"{len(program.params)}")
    for (rv, _), (pv, _) in zip(ref_program.params, program.params):
        arr = np.array(ref_vars[rv.name])
        if list(arr.shape) != pv.static_shape:
            raise ValueError(f"{rv.name} {tuple(arr.shape)} does not fit "
                             f"{pv.name} {tuple(pv.static_shape)}")
        value = torch.from_numpy(arr).to(device)
        scope.set(pv.name, value if pv.stop_gradient
                  else nn.Parameter(value))


def static_scope_to_paddle_tpu(program, ref_program, scope=None):
    """The inverse of :func:`static_scope_from_paddle_tpu`: ``{reference
    name: numpy array}`` of the port's scope, matched by position."""
    from .static import global_scope
    from .static.program import recording_suspended

    scope = scope or global_scope()
    with recording_suspended():
        return {rv.name: _leaf(scope.vars[pv.name]) for (rv, _), (pv, _)
                in zip(ref_program.params, program.params)}
