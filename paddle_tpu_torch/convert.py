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
names map one to one; a ``gpt.`` prefix (the reference's
``GPTForPretraining`` saves its trunk under it) is accepted either way.
Layout: the reference's Linear stores its weight ``[in, out]``, torch's
``[out, in]``, so every 2-D weight of a Linear is transposed.
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


def _linear_weight_names(model):
    return {f"{name}.weight" for name, mod in model.named_modules()
            if isinstance(mod, nn.Linear)}


def state_from_paddle_tpu(np_state, model):
    """``{name: tensor}`` for ``model`` from a reference state.

    ``np_state``: a dict of name -> array (or a path to a
    ``paddle_tpu.framework.save`` pickle of one). Names may carry the
    reference wrapper's ``gpt.`` prefix where ``model`` has none, or lack it
    where ``model`` (a ``GPTForPretraining``) has it. Linear weights are
    transposed to ``[out, in]`` and every array is cast to the dtype and
    moved to the device of the parameter it fills. Raises ``KeyError`` for
    a missing or an extra name and ``ValueError`` for a shape mismatch."""
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
        if name not in own and name.startswith("gpt.") \
                and name[len("gpt."):] in own:
            name = name[len("gpt."):]
        elif name not in own and "gpt." + name in own:
            name = "gpt." + name
        src[name] = value
    missing = sorted(set(own) - set(src))
    extra = sorted(set(src) - set(own))
    if missing or extra:
        raise KeyError(f"state does not match the model: missing {missing[:5]}"
                       f"{' ...' if len(missing) > 5 else ''}, extra "
                       f"{extra[:5]}{' ...' if len(extra) > 5 else ''}")
    linear = _linear_weight_names(model)
    out = {}
    for name, target in own.items():
        arr = _leaf(src[name])
        if name in linear:
            arr = arr.T
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"shape mismatch for {name!r}: model holds "
                             f"{tuple(target.shape)}, state gives "
                             f"{tuple(arr.shape)}"
                             + (" (after the [in, out] -> [out, in] "
                                "transpose)" if name in linear else ""))
        out[name] = torch.from_numpy(np.array(arr, order="C")).to(
            device=target.device, dtype=target.dtype)
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


def state_to_paddle_tpu(model):
    """``model``'s state in the reference's names and layout: its
    ``state_dict()`` with every Linear weight transposed to ``[in, out]``
    (found by module type: a square weight cannot be told by its shape).
    The tensors alias the live ones (Linear weights as transposed views);
    ``framework.save`` snapshots them."""
    linear = _linear_weight_names(model)
    return {name: t.t() if name in linear else t
            for name, t in model.state_dict().items()}


def optimizer_state_to_paddle_tpu(optimizer, model):
    """``optimizer.state_dict()`` in the reference's layout: the slots of a
    Linear weight of ``model`` transposed to ``[in, out]`` as the weight
    is. Keys (``"<accumulator>/p<i>"``, ``_opt_step``, ``LR_Scheduler``)
    are the reference's already, for every optimizer of the port."""
    params = optimizer._parameter_list
    linear = _linear_weight_ids(model)
    out = {}
    for key, value in optimizer.state_dict().items():
        if isinstance(value, torch.Tensor):
            i = int(key.rpartition("/p")[2])
            if id(params[i]) in linear:
                value = value.t()
        elif isinstance(value, dict):
            value = dict(value)
        out[key] = value
    return out
