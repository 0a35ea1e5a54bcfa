"""``paddle.static.nn`` (counterpart of paddle_tpu/static/nn.py): ``fc``,
``embedding`` and ``batch_norm``, which make parameters of the main
Program with the reference's initializers and auto names (``fc_w_N``,
``fc_b_N``, ... from one process-wide counter), and the control flow
``cond`` and ``while_loop``.

The reference turns ``cond`` / ``while_loop`` into XLA control flow and
finds the Variables a branch closes over by reading its closure cells. The
port records each branch (and a loop's condition and body) as a block of
its own: the callables are called once while recording, so every Variable
they touch, closed over or global, is an input of the block. The Executor
runs the block the predicate picks, under autograd, so gradients flow
through the branch taken and through every iteration of a loop. The
choice is made on the host: such a Program runs uncaptured on the card.

The static collectives (``c_allreduce_sum`` / ``max`` / ``min`` / ``prod``,
``c_broadcast``, ``c_concat``, ``c_split``) are each one recorded call
(``framework.static_leaf``) over the group resolved when it was recorded
(default: the world), run by the Executor with the port's ``collective``
module. Each rank holds its own shard, the reference's row block of the
group's global array: ``c_allreduce_*`` give every rank the reduction over
the group (``prod`` multiplies, as the reference's ``all_gather(...)
.prod`` does), ``c_broadcast`` gives every rank ``root``'s shard (``root``
a global rank of the group or an in-group index, else ``ValueError``),
``c_concat`` all-gathers along the last dimension and ``c_split`` keeps
this rank's slice of it (a last dimension the group size does not divide
raises). A group of one rank is the identity.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as TF
from torch.utils import _pytree as pytree

from .. import framework
from ..nn import functional as F
from ..nn.initializer import Constant, ParamAttr, XavierUniform
from . import program as prog_mod
from .program import OpRecord, Variable, convert_dtype, resolve_alias

__all__ = ["fc", "embedding", "batch_norm", "cond", "while_loop",
           "c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
           "c_allreduce_prod", "c_broadcast", "c_concat", "c_split"]

# process-wide, as the reference's ``unique_name.generate``: parameters
# live in the global scope by name
_param_counter = itertools.count()


def _make_param(shape, dtype, attr=None, is_bias=False, name_hint="w"):
    attr = ParamAttr._to_attr(attr)
    init = attr.initializer or (Constant(0.0) if is_bias else XavierUniform())
    value = torch.empty([int(s) for s in shape], dtype=convert_dtype(dtype))
    with torch.no_grad():
        init(value)
    name = attr.name or f"{name_hint}_{next(_param_counter)}"
    return prog_mod.default_main_program()._add_param(
        name, value, trainable=attr.trainable)


def _static_dims(x, dims, what):
    if any(isinstance(d, prog_mod.SymDim) for d in dims):
        raise ValueError(f"static.nn.{what}: the dimensions it sizes its "
                         "parameter from must be static")
    return [int(d) for d in dims]


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """``activation(flatten(x) @ W + b)`` with ``W`` ``[in, size]`` (the
    reference's layout), XavierUniform, and ``b`` zeros."""
    in_dim = int(np.prod(_static_dims(x, x.shape[num_flatten_dims:], "fc")))
    w = _make_param([in_dim, size], "float32", weight_attr, name_hint="fc_w")
    flat = torch.flatten(x, num_flatten_dims) \
        if x.ndim > num_flatten_dims + 1 else x
    out = torch.matmul(flat, w)
    if bias_attr is not False:
        b = _make_param([size], "float32", bias_attr, is_bias=True,
                        name_hint="fc_b")
        out = out + b
    if activation:
        out = getattr(F, activation)(out)
    return out


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32"):
    """A lookup of ``input`` in a ``size`` table (XavierUniform); the
    ``padding_idx`` rows look up zeros, as the reference's."""
    w = _make_param(list(size), dtype, param_attr, name_hint="emb_w")
    out = TF.embedding(input, w)
    if padding_idx is not None:
        out = out.masked_fill((input == padding_idx).unsqueeze(-1), 0.0)
    return out


def batch_norm(input, epsilon=1e-5, momentum=0.9, param_attr=None,
               bias_attr=None, data_layout="NCHW", is_test=False, name=None):
    """``nn.functional.batch_norm`` over new scale (ones), bias (zeros) and
    running mean (zeros) and variance (ones), the last two not trained."""
    C = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    C = _static_dims(input, [C], "batch_norm")[0]
    scale = _make_param([C], "float32", param_attr or ParamAttr(
        initializer=Constant(1.0)), name_hint="bn_scale")
    bias = _make_param([C], "float32", bias_attr, is_bias=True,
                       name_hint="bn_bias")
    mean = _make_param([C], "float32", ParamAttr(
        initializer=Constant(0.0), trainable=False), name_hint="bn_mean")
    var = _make_param([C], "float32", ParamAttr(
        initializer=Constant(1.0), trainable=False), name_hint="bn_var")
    return F.batch_norm(input, mean, var, scale, bias, training=not is_test,
                        momentum=momentum, epsilon=epsilon,
                        data_format=data_layout)


# -- control flow -------------------------------------------------------------

def _metas(x):
    if isinstance(x, Variable):
        x = resolve_alias(x)
        return x._ma, x._mb
    m = torch.empty_like(torch.as_tensor(x), device="meta")
    return m, m


def _record_block(prog, fn, *args):
    """Call ``fn(*args)`` recording into a block of its own: ``(ops, flat
    outputs, their structure)``."""
    with prog._recording_into([]) as ops:
        out = fn(*args)
    flat, spec = pytree.tree_flatten(out)
    return ops, [resolve_alias(o) for o in flat], spec


def _same_kind(where, got, want):
    for g, w in zip(got, want):
        ga, wa = _metas(g)[0], _metas(w)[0]
        if ga.shape != wa.shape or ga.dtype != wa.dtype:
            raise ValueError(f"{where}: {tuple(ga.shape)} {ga.dtype} where "
                             f"{tuple(wa.shape)} {wa.dtype} is expected")


def cond(pred, true_fn=None, false_fn=None, name=None, return_names=None):
    """``true_fn()`` if ``pred`` else ``false_fn()``: both are recorded, and
    the Executor runs the one ``pred`` picks. A Python bool picks at once."""
    if not isinstance(pred, Variable):
        fn = true_fn if pred else false_fn
        return fn() if fn is not None else None
    prog = prog_mod.default_main_program()
    none = (lambda: None)
    t_ops, t_out, spec = _record_block(prog, true_fn or none)
    f_ops, f_out, f_spec = _record_block(prog, false_fn or none)
    if spec != f_spec:
        raise ValueError("static.nn.cond: true_fn and false_fn return "
                         f"different structures ({spec} vs {f_spec})")
    _same_kind("static.nn.cond: false_fn returns", f_out, t_out)
    outs = [prog._new_var(*_metas(o)) for o in t_out]
    prog._append(OpRecord("cond", None, (resolve_alias(pred),), {}, outs,
                          sub={"true": (t_ops, t_out),
                               "false": (f_ops, f_out)}))
    return pytree.tree_unflatten(outs, spec)


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """``while cond_fn(*vars): vars = body_fn(*vars)``; returns the final
    ``loop_vars`` as a list. Each loop variable keeps its shape and dtype;
    the callables may use any Variable of the Program."""
    prog = prog_mod.default_main_program()
    loop_vars = list(loop_vars)
    holders = [prog._new_var(*_metas(v)) for v in loop_vars]
    c_ops, c_out, _ = _record_block(prog, cond_fn, *holders)
    if len(c_out) != 1 or not isinstance(c_out[0], Variable):
        raise TypeError("static.nn.while_loop: cond_fn must return one "
                        "boolean Variable")
    b_ops, b_out, _ = _record_block(prog, _as_list(body_fn), *holders)
    if len(b_out) != len(loop_vars):
        raise ValueError(f"static.nn.while_loop: body_fn returns "
                         f"{len(b_out)} values for {len(loop_vars)} "
                         "loop_vars")
    _same_kind("static.nn.while_loop: body_fn returns", b_out, loop_vars)
    outs = [prog._new_var(*_metas(v)) for v in loop_vars]
    prog._append(OpRecord(
        "while", None, tuple(resolve_alias(v) if isinstance(v, Variable)
                             else v for v in loop_vars), {}, outs,
        sub={"holders": holders, "cond": (c_ops, c_out),
             "body": (b_ops, b_out)}))
    return outs


def _as_list(fn):
    def body(*args):
        out = fn(*args)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    return body


# -- static collectives -------------------------------------------------------

def _c_root(group, root):
    local = group.get_group_rank(root) if root in group.ranks else root
    if not 0 <= local < group.nranks:
        raise ValueError(f"c_broadcast root {root} is neither a member of "
                         f"{group.ranks} nor a valid in-group index")
    return local


def _c_shape(x, kind, group, root=0):
    shape = list(x.shape)
    n = group.nranks
    if kind == "concat":
        shape[-1] *= n
    elif kind == "split":
        if shape[-1] % n:
            raise ValueError(f"c_split: last dim {shape[-1]} not divisible "
                             f"by group size {n}")
        shape[-1] //= n
    elif kind == "broadcast":
        _c_root(group, root)
    return shape


def _c_meta(x, kind, group, root=0):
    return torch.empty(_c_shape(x, kind, group, root), dtype=x.dtype,
                       device="meta")


@framework.static_leaf(_c_meta)
def _c_collective(x, kind, group, root=0):
    """One static collective on this rank's shard ``x``."""
    from ..distributed import collective as coll

    _c_shape(x, kind, group, root)
    if group.nranks == 1:
        return x.clone()
    if kind in ("sum", "max", "min"):
        op = {"sum": coll.ReduceOp.SUM, "max": coll.ReduceOp.MAX,
              "min": coll.ReduceOp.MIN}[kind]
        out = x.clone()
        coll.all_reduce(out, op, group=group)
        return out
    if kind == "prod":
        return coll.all_gather_axis(x.unsqueeze(0), group, 0).prod(dim=0)
    if kind == "broadcast":
        out = x.clone()
        coll.broadcast(out, src=_c_root(group, root), group=group)
        return out
    if kind == "concat":
        return coll.all_gather_axis(x, group, x.dim() - 1)
    width = x.shape[-1] // group.nranks
    return x.narrow(-1, group.rank * width, width).clone()


def _static_collective(x, kind, group, root=0):
    from ..distributed import collective as coll

    group = group if group is not None else coll.get_group(0)
    return _c_collective(x, kind, group, root)


def _c_allreduce(kind):
    def op(x, group=None, use_calc_stream=True):
        return _static_collective(x, kind, group)

    op.__name__ = f"c_allreduce_{kind}"
    return op


c_allreduce_sum = _c_allreduce("sum")
c_allreduce_max = _c_allreduce("max")
c_allreduce_min = _c_allreduce("min")
c_allreduce_prod = _c_allreduce("prod")


def c_broadcast(x, root=0, group=None, use_calc_stream=True):
    """Every rank's shard becomes ``root``'s (module docstring)."""
    return _static_collective(x, "broadcast", group, root)


def c_concat(x, group=None, use_calc_stream=True):
    """The shards all-gathered along the last dimension."""
    return _static_collective(x, "concat", group)


def c_split(x, rank=None, group=None, use_calc_stream=True):
    """This rank's slice of the last dimension (it must divide evenly)."""
    return _static_collective(x, "split", group)
