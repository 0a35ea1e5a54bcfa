"""paddle_tpu_torch.serving.mesh — the leader and the followers of an engine
on a tensor-parallel serving mesh (``distributed.spmd.serving_mesh``).

The reference is one controller: one host drives every device of the
mesh. Here each rank of the mesh is a process holding its shard, so the
controller is rendered as a leader and its followers:

* every rank builds the same engine (or server) with the same arguments;
  the ranks agree on it at construction (:meth:`MeshLink.agree`), and the
  leader's sampling base key becomes every rank's;
* rank 0 is the leader. Before it runs a call that changes engine state
  (the methods wrapped by :func:`leader_call`: prefill and its chunks,
  decode steps and spec rounds, release, reset, swaps, re-primes, exports
  and imports), it sends the call's name and host arguments to the other
  ranks over the mesh's gloo control group. Arguments on a device cross as
  host copies;
* the other ranks run ``engine.follow()``: they receive each call and run
  it, in the leader's order, so every rank's slot state, block tables and
  prefix cache stay equal, and every collective inside a step meets its
  peers. ``follow()`` returns when the leader's ``close()`` arrives;
* a follower that calls a wrapped method itself raises, naming rank 0.

Faults: the leader decides. The fault points that fire before a call
(``decode_error``, ``slow_decode``, ``pod_slow``, ``replica_kill`` before a
step, ``kill_during_swap`` before a swap) fire on the leader before it
sends the call, so a call that raises there reaches no follower and no
rank is left waiting in a collective; ``draft_garbage`` is decided on the
leader and sent with the spec round, so every rank replaces the same
proposals. A call that raises on every rank alike (a refused swap, a stale
handoff, a bad prompt) raises on the leader to its caller; a follower
counts it (``serving.mesh_follower_errors``) and goes on following.
"""
from __future__ import annotations

import contextlib
import functools

import torch
import torch.distributed as dist

from ..profiler import explainer as _explain
from ..profiler import registry as _registry
from ..testing import faults as _faults

__all__ = ["MeshLink", "leader_call"]

_counters = _registry.scoped_counters("serving", {
    "mesh_calls_sent": 0, "mesh_calls_followed": 0,
    "mesh_follower_errors": 0})


def _host(obj):
    """``obj`` with every tensor in it as a host copy (dicts, lists and
    tuples walked), for a message to the followers."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


class MeshLink:
    """The channel between the ranks of one mesh engine: the mesh's
    control group (gloo, host objects), the leader's calls and the fault
    decisions of the call running now (``faults``)."""

    def __init__(self, mesh):
        self.group = mesh.control
        self.rank = mesh.rank
        self.leader = self.rank == 0
        self.faults = {}
        self.closed = False
        self._depth = 0

    @property
    def running(self):
        """True inside a call already sent (or received): a wrapped method
        it calls runs directly."""
        return self._depth > 0

    @contextlib.contextmanager
    def run(self, faults):
        self._depth += 1
        self.faults = faults
        try:
            yield
        finally:
            self._depth -= 1
            if not self._depth:
                self.faults = {}

    def broadcast(self, obj):
        """The leader's ``obj`` on every rank (pickled, over gloo)."""
        buf = [obj if self.leader else None]
        dist.broadcast_object_list(buf, src=self.group.ranks[0],
                                   group=self.group.pg)
        return buf[0]

    def agree(self, what, signature, value):
        """Every rank checks that all ranks built ``what`` alike (equal
        ``signature``s) and gets the leader's ``value``. A mismatch raises
        ``ValueError`` on every rank."""
        sigs = [None] * self.group.nranks
        dist.all_gather_object(sigs, signature, group=self.group.pg)
        bad = [r for r, s in enumerate(sigs) if s != sigs[0]]
        if bad:
            raise ValueError(
                f"{what}: ranks {bad} built it with other arguments than "
                f"rank 0 ({sigs[bad[0]]} != {sigs[0]}); every rank of a "
                "mesh builds the same engine")
        return self.broadcast(value)

    def close(self):
        """Leader: tell the followers to return from ``follow()``."""
        if self.leader and not self.closed:
            self.broadcast(None)
        self.closed = True

    def follow(self, engine):
        """Follower: run the leader's calls on ``engine`` until it closes.
        Returns the number of calls run."""
        if self.leader:
            raise RuntimeError("follow() runs on the followers; rank 0 "
                               "leads the mesh engine")
        n = 0
        while True:
            msg = self.broadcast(None)
            if msg is None:
                self.closed = True
                return n
            name, args, kw, faults = msg
            n += 1
            _counters["mesh_calls_followed"] += 1
            try:
                with self.run(faults):
                    getattr(engine, name)(*args, **kw)
            except Exception as e:  # the leader raised it too, and decides
                _counters["mesh_follower_errors"] += 1
                _explain.record(
                    "serving_mesh_follower_error", op=name,
                    why=f"{type(e).__name__}: {e} (the leader's call raised "
                        f"on rank {self.rank}; following on)",
                    error=repr(e))


def _leader_faults(engine, name):
    """Fire the fault points that precede call ``name`` on the leader and
    return the decisions the followers apply with it."""
    if not _faults.ACTIVE:
        return {}
    if name in ("decode_step", "decode_step_spec"):
        engine._fire_decode_faults()
        if name == "decode_step_spec":
            return {"draft_garbage": bool(_faults.fire("draft_garbage"))}
    elif name == "swap_weights":
        _faults.fire("kill_during_swap")
    return {}


def leader_call(fn):
    """Make an engine method a mesh call: on the leader of a mesh engine it
    fires the call's fault points, sends the call to the followers and
    runs it; on a follower outside ``follow()`` it raises. A call made
    inside another one (``reset`` releasing each slot) runs directly, as
    does every call of an engine with no mesh."""
    name = fn.__name__

    @functools.wraps(fn)
    def call(self, *args, **kw):
        link = self._link
        if link is None or link.running:
            return fn(self, *args, **kw)
        if not link.leader:
            raise RuntimeError(
                f"{name}: rank {link.rank} follows the mesh engine; rank 0 "
                "drives it (run engine.follow() here)")
        if link.closed:
            raise RuntimeError(f"{name}: the mesh engine was closed")
        faults = _leader_faults(self, name)
        link.broadcast((name, _host(args), _host(kw), faults))
        _counters["mesh_calls_sent"] += 1
        with link.run(faults):
            return fn(self, *args, **kw)

    return call
