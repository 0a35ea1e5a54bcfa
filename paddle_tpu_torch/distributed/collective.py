"""Collective communication (counterpart of
paddle_tpu/distributed/collective.py) over ``torch.distributed``.

Two forms, as in the reference:

1. The eager tensor form (``all_reduce(t, group=g)``, ...), with the
   reference's names and arguments. The reference is one controller whose
   tensors are global arrays: the leading dim spans the group. Here each
   rank is a process holding its own tensor, so rank ``r`` holds row ``r``
   of the reference's array, and its result is row ``r`` of the
   reference's result.
2. The axis-name functional form (``psum(x, "mp")``, ``all_gather_axis``,
   ...), which the reference has only inside ``shard_map``. Here an axis
   name is one dimension of the fleet mesh (``fleet.init`` names them
   ``"dp"``, ``"pp"``, ``"sharding"``, ``"ep"``, ``"mp"``; a tuple of
   them names their joint group), so the forms run eagerly
   over that dimension's group of this rank and return new tensors;
   ``meta_parallel.mp_ops`` is built on them.

Groups are ``torch.distributed`` process groups: ``new_group`` must be
called by every rank (torch's rule), and a fleet mesh dimension is the
group of ranks that differ only along it. Counters (registry scope
``collective``): ``<op>.calls`` and ``<op>.bytes`` per call (the bytes of
the local input), and ``host_staged`` (+ ``host_staged.<op>``): calls that
went through host memory because gloo refused a CUDA tensor for that op
(tried once per op and process, then staged every time; never silent).
Point-to-point transfers (``send``, ``recv``, ``ppermute`` and
:func:`p2p`, which posts a set of sends and receives together, as a
pipeline stage's tick does) never give gloo a CUDA tensor: gloo's send and
receive hand the tensor's data pointer to its transport without looking at
the device, so each CUDA tensor goes through a pinned host buffer, counted
in ``host_staged`` (+ ``host_staged.p2p``). ``p2p`` tallies ``send`` and
``recv`` per tensor (the bytes that cross between ranks).
``reduce`` gives every rank the result, as the reference's does; the
reference's ``ReduceOp.PROD`` sums (it has no product reducer), the port's
multiplies.
"""
from __future__ import annotations

import re

import torch
import torch.distributed as dist

from ..profiler import registry as _registry

__all__ = ["ReduceOp", "Group", "new_group", "get_group", "all_reduce",
           "all_gather", "reduce_scatter", "broadcast", "reduce", "scatter",
           "alltoall", "all_to_all", "send", "recv", "p2p", "wait",
           "split_group_mesh", "psum", "pmean", "pmax",
           "all_gather_axis", "reduce_scatter_axis", "ppermute",
           "all_to_all_axis", "axis_index", "axis_group", "set_axis_groups"]

_counters = _registry.scoped_counters("collective", {"host_staged": 0})


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT,
              ReduceOp.AVG: dist.ReduceOp.SUM}


class Group:
    """A communicator: ``ranks`` (global ranks, in group order) over one
    torch process group (None for a group of one process)."""

    def __init__(self, ranks, gid, pg=None, axis_name=None):
        self.ranks = list(ranks)
        self.nranks = len(self.ranks)
        self.id = gid
        self.pg = pg
        self.axis = axis_name or f"g{gid}"

    @property
    def process_group(self):
        """The torch process group (``torch.distributed`` calls take it)."""
        return self.pg

    @property
    def rank(self):
        """This process's rank in the group (-1 outside it)."""
        return self.get_group_rank(dist.get_rank()
                                   if dist.is_initialized() else 0)

    @property
    def backend(self):
        return dist.get_backend(self.pg) if self.pg is not None else None

    def get_group_rank(self, global_rank):
        try:
            return self.ranks.index(global_rank)
        except ValueError:
            return -1

    def __repr__(self):
        return (f"Group(id={self.id}, ranks={self.ranks}, "
                f"axis={self.axis!r})")


_groups: dict = {}
_axis_groups: dict = {}
_next_gid = [1]


def _default_group():
    """The world's group. Rebuilt when the world's process group is not
    the one it was built over: a world torn down and formed again (an
    elastic survivor's ``destroy_process_group`` and ``init_parallel_env``)
    at the same size must not keep the destroyed group."""
    g = _groups.get(0)
    world = dist.get_world_size() if dist.is_initialized() else 1
    pg = dist.group.WORLD if dist.is_initialized() else None
    if g is None or g.nranks != world or (world > 1 and g.pg is not pg):
        g = _groups[0] = Group(range(world), 0, pg, axis_name="world")
    return g


def get_group(gid=0):
    return _default_group() if gid == 0 else _groups[gid]


def new_group(ranks=None, backend=None, timeout=None):
    """A group over ``ranks`` (default: the world). Every rank of the
    world must call it, in the same order, as torch requires."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = sorted(range(world) if ranks is None else ranks)
    kw = {} if timeout is None else {"timeout": timeout}
    pg = dist.new_group(ranks, backend=backend, **kw) \
        if dist.is_initialized() else None
    g = Group(ranks, _next_gid[0], pg)
    _groups[g.id] = g
    _next_gid[0] += 1
    return g


def split_group_mesh(mesh, axis_name):
    """This rank's group along one dimension of a ``DeviceMesh``."""
    pg = mesh.get_group(axis_name)
    g = Group(dist.get_process_group_ranks(pg), _next_gid[0], pg,
              axis_name=axis_name)
    _groups[g.id] = g
    _next_gid[0] += 1
    return g


def set_axis_groups(groups):
    """Name the groups the axis-name forms reach (``fleet.init`` passes
    ``{"dp": ..., "mp": ...}``); replaces the previous table."""
    _axis_groups.clear()
    _axis_groups.update(groups)


def axis_group(axis):
    """The group of an axis name of the fleet mesh, of a tuple of axis
    names (the ranks that differ only along those axes, as
    ``("dp", "ep")``; ``fleet.init`` makes the ones the port uses), or a
    ``Group`` as it is."""
    if isinstance(axis, Group):
        return axis
    if axis is None or axis == "world":
        return _default_group()
    try:
        return _axis_groups[axis]
    except KeyError:
        raise ValueError(f"no mesh axis {axis!r}: call fleet.init first "
                         f"(known: {sorted(_axis_groups)})") from None


# ----------------------------------------------------- running one op ----
_REFUSAL = re.compile(r"unsupported|not supported|not implemented|"
                      r"does not support|"
                      r"only supports cpu|must be (on )?cpu|expected.*cpu",
                      re.IGNORECASE)
_staged: set = set()


class _Task:
    """What an eager collective returns: ``wait()`` and ``is_completed()``
    (the calls run to their end before returning)."""

    def wait(self):
        return True

    def is_completed(self):
        return True


def _run(name, group, fn, tensors):
    """``fn(*tensors)`` (a torch collective writing its outputs in place).
    A gloo group refusing CUDA tensors for this op runs it on host copies
    instead, counted in ``host_staged``."""
    if not (any(t.is_cuda for t in tensors) and group.backend == "gloo"):
        fn(*tensors)
        return
    if name not in _staged:
        try:
            fn(*tensors)
            return
        except RuntimeError as e:
            if not _REFUSAL.search(str(e)):
                raise
            _staged.add(name)
    host = [t.detach().to("cpu").pin_memory() for t in tensors]
    fn(*host)
    for t, h in zip(tensors, host):
        t.copy_(h)
    _counters["host_staged"] += 1
    key = f"host_staged.{name}"
    _counters[key] = _counters.get(key, 0) + 1


def _tally(name, *tensors):
    _registry.tally("collective", name, *tensors)


def _global_rank(group, r):
    """A rank argument as a global rank: a member's global rank is taken
    as it is, anything else as an index into the group (the reference's
    rule)."""
    return r if r in group.ranks else group.ranks[r]


def _reduce_in_place(name, t, op, group):
    _run(name, group, lambda x: dist.all_reduce(
        x, op=_TORCH_OPS[op], group=group.pg), [t])
    if op == ReduceOp.AVG:
        t.div_(group.nranks)


# ------------------------------------------------------ the eager form ---
def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce ``tensor`` over the group, in place."""
    _tally("all_reduce", tensor)
    group = group or _default_group()
    if group.nranks > 1:
        _reduce_in_place("all_reduce", tensor, op, group)
    return _Task()


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """``all_reduce``: every rank receives the result, ``dst`` included,
    as in the reference."""
    return all_reduce(tensor, op, group, sync_op)


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Append every rank's ``tensor`` to ``tensor_list``, in rank order."""
    _tally("all_gather", tensor)
    group = group or _default_group()
    if group.nranks == 1:
        tensor_list.append(tensor.clone())
        return _Task()
    outs = [torch.empty_like(tensor) for _ in range(group.nranks)]
    _run("all_gather", group,
         lambda x, *o: dist.all_gather(list(o), x, group=group.pg),
         [tensor.contiguous(), *outs])
    tensor_list.extend(outs)
    return _Task()


def broadcast(tensor, src=0, group=None, sync_op=True):
    """``src``'s tensor into every rank's ``tensor``, in place."""
    _tally("broadcast", tensor)
    group = group or _default_group()
    if group.nranks > 1:
        g_src = _global_rank(group, src)
        _run("broadcast", group, lambda x: dist.broadcast(
            x, src=g_src, group=group.pg), [tensor])
    return _Task()


def reduce_scatter(tensor, tensor_or_tensor_list, op=ReduceOp.SUM,
                   group=None, sync_op=True):
    """Reduce the input (a tensor, or a list concatenated along dim 0)
    over the group and keep this rank's chunk of dim 0 in ``tensor``."""
    src = tensor_or_tensor_list
    if isinstance(src, (list, tuple)):
        src = torch.cat(list(src), dim=0)
    _tally("reduce_scatter", src)
    group = group or _default_group()
    if group.nranks == 1:
        tensor.copy_(src)
        return _Task()
    _run("reduce_scatter", group, lambda o, x: dist.reduce_scatter_tensor(
        o, x, op=_TORCH_OPS[op], group=group.pg),
        [tensor, src.contiguous()])
    if op == ReduceOp.AVG:
        tensor.div_(group.nranks)
    return _Task()


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank ``i`` of the group receives ``src``'s ``tensor_list[i]``."""
    _tally("scatter", tensor)
    group = group or _default_group()
    if group.nranks == 1:
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return _Task()
    g_src = _global_rank(group, src)
    if dist.get_rank() == g_src:
        ins = [t.contiguous() for t in tensor_list]
        _run("scatter", group, lambda o, *i: dist.scatter(
            o, list(i), src=g_src, group=group.pg), [tensor, *ins])
    else:
        _run("scatter", group, lambda o: dist.scatter(
            o, None, src=g_src, group=group.pg), [tensor])
    return _Task()


def alltoall(in_tensor_list, out_tensor_list, group=None, sync_op=True):
    """All-to-all. A tensor input is split into ``nranks`` chunks of dim 0,
    chunk ``j`` going to rank ``j``; this rank's result (the chunks it
    received, in rank order) is returned and its rows are appended to
    ``out_tensor_list``, as the reference appends the rows of its result.
    A list input sends element ``j`` to rank ``j`` and appends what each
    rank sent here."""
    group = group or _default_group()
    if isinstance(in_tensor_list, torch.Tensor):
        x = in_tensor_list.contiguous()
        _tally("all_to_all", x)
        out = torch.empty_like(x)
        if group.nranks == 1:
            out.copy_(x)
        else:
            _run("all_to_all", group, lambda o, i: dist.all_to_all_single(
                o, i, group=group.pg), [out, x])
        if isinstance(out_tensor_list, list):
            out_tensor_list.extend(out.unbind(0))
        return out
    ins = [t.contiguous() for t in in_tensor_list]
    _tally("all_to_all", *ins)
    outs = [torch.empty_like(t) for t in ins]
    if group.nranks == 1:
        outs[0].copy_(ins[0])
    elif all(t.shape == ins[0].shape and t.dtype == ins[0].dtype
             for t in ins):
        # one all_to_all_single over the stacked chunks: gloo has no
        # list form, only the single-tensor one
        x = torch.stack(ins)
        out = torch.empty_like(x)
        _run("all_to_all", group, lambda o, i: dist.all_to_all_single(
            o, i, group=group.pg), [out, x])
        outs = list(out.unbind(0))
    else:
        n = len(ins)
        _run("all_to_all", group, lambda *ts: dist.all_to_all(
            list(ts[n:]), list(ts[:n]), group=group.pg), [*ins, *outs])
    if isinstance(out_tensor_list, list):
        out_tensor_list.extend(outs)
    return outs


all_to_all = alltoall


def _stage_p2p(group, tensors):
    """Whether ``tensors`` must go through host memory (CUDA over gloo)."""
    return group.backend == "gloo" and any(t.is_cuda for t in tensors)


def _p2p(sends, recvs, group):
    """Post ``sends`` ``[(tensor, group rank)]`` and ``recvs`` together
    and wait for all of them (see the module's docstring)."""
    sends = [(t.contiguous(), d) for t, d in sends]
    if not sends and not recvs:
        return
    staged = _stage_p2p(group, [t for t, _ in [*sends, *recvs]])
    if staged:
        s_buf = [t.detach().to("cpu") for t, _ in sends]
        r_buf = [torch.empty(t.shape, dtype=t.dtype).pin_memory()
                 for t, _ in recvs]
    else:
        s_buf = [t for t, _ in sends]
        r_buf = [t for t, _ in recvs]
    ops = [dist.P2POp(dist.isend, b, group.ranks[d], group.pg)
           for b, (_, d) in zip(s_buf, sends)]
    ops += [dist.P2POp(dist.irecv, b, group.ranks[s], group.pg)
            for b, (_, s) in zip(r_buf, recvs)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    if staged:
        for (t, _), b in zip(recvs, r_buf):
            t.copy_(b)
        _counters["host_staged"] += 1
        _counters["host_staged.p2p"] = _counters.get("host_staged.p2p",
                                                     0) + 1


def p2p(sends=(), recvs=(), group=None):
    """Point to point over ``group``: every ``(tensor, dst)`` of ``sends``
    and ``(tensor, src)`` of ``recvs`` (ranks in the group) posted
    together, so two ranks that send to each other cannot deadlock;
    returns when all are done, the received tensors filled in place.
    Tallies ``send`` and ``recv`` per tensor."""
    group = group or _default_group()
    for t, _ in sends:
        _tally("send", t)
    for t, _ in recvs:
        _tally("recv", t)
    _p2p(list(sends), list(recvs), group)
    return _Task()


def send(tensor, dst=0, group=None, sync_op=True):
    """Point-to-point send to ``dst`` (a global rank, or an index into
    ``group``). The reference cannot express it outside ``shard_map`` and
    raises; processes can."""
    group = group or _default_group()
    _tally("send", tensor)
    _p2p([(tensor, group.ranks.index(_global_rank(group, dst)))], [],
         group)
    return _Task()


def recv(tensor, src=0, group=None, sync_op=True):
    """Point-to-point receive from ``src`` into ``tensor``, in place."""
    group = group or _default_group()
    _tally("recv", tensor)
    _p2p([], [(tensor, group.ranks.index(_global_rank(group, src)))],
         group)
    return _Task()


def wait(tensor, group=None, use_calc_stream=True):
    """Wait until ``tensor``'s pending work on its device is done."""
    if tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()


# ---------------------------------------------- the axis-name form ---------
def _reduced(name, x, op, axis):
    group = axis_group(axis)
    _tally(name, x)
    out = x.clone()
    if group.nranks > 1:
        _reduce_in_place(name, out, op, group)
    return out


def psum(x, axis):
    """The sum of ``x`` over the axis's group (a new tensor)."""
    return _reduced("psum", x, ReduceOp.SUM, axis)


def pmean(x, axis):
    return _reduced("pmean", x, ReduceOp.AVG, axis)


def pmax(x, axis):
    return _reduced("pmax", x, ReduceOp.MAX, axis)


def all_gather_axis(x, axis, tiled_dim=0):
    """Every rank's ``x`` concatenated along ``tiled_dim``, in rank order."""
    group = axis_group(axis)
    parts = []
    all_gather(parts, x, group=group)
    return torch.cat(parts, dim=tiled_dim)


def reduce_scatter_axis(x, axis, scatter_dim=0):
    """The sum over the group, split into ``nranks`` chunks along
    ``scatter_dim``; this rank's chunk."""
    group = axis_group(axis)
    xt = x.movedim(scatter_dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // group.nranks, *xt.shape[1:]))
    reduce_scatter(out, xt, group=group)
    return out.movedim(0, scatter_dim)


def ppermute(x, axis, perm):
    """Each ``(src, dst)`` pair of ``perm`` (group ranks) sends ``src``'s
    ``x`` to ``dst``; a rank no pair sends to receives zeros."""
    group = axis_group(axis)
    _tally("ppermute", x)
    me = group.rank
    out = torch.zeros_like(x)
    if group.nranks == 1:
        return x.clone() if (0, 0) in perm else out
    sends, recvs = [], []
    for s, d in perm:
        if s == me and d == me:
            out.copy_(x)
        elif s == me:
            sends.append((x, d))
        elif d == me:
            recvs.append((out, s))
    _p2p(sends, recvs, group)
    return out


def all_to_all_axis(x, axis, split_dim, concat_dim):
    """``x`` split into ``nranks`` chunks along ``split_dim``, chunk ``j``
    sent to rank ``j``; the received chunks concatenated along
    ``concat_dim`` in rank order."""
    group = axis_group(axis)
    chunks = list(torch.chunk(x, group.nranks, dim=split_dim))
    outs = alltoall(chunks, None, group=group)
    return torch.cat(outs, dim=concat_dim)


def axis_index(axis):
    """This rank's index along the axis."""
    return axis_group(axis).rank
