"""Deterministic fault injection (counterpart of
paddle_tpu/testing/faults.py, with the same spec grammar).

Every failure mode the serving stack claims to survive has an injection
point, so recovery paths run in ordinary tests and on the card instead of
waiting for a real fault. Injection is off by default: a site checks the
module global ``ACTIVE`` and calls :func:`fire` only when a spec is armed.

Spec grammar (env ``FLAGS_fault_inject``, read when this module is first
imported, or :func:`configure` at run time)::

    point[:k=v[,k=v...]][;point...]

    "kill_at_step:step=7"                die hard at step 7 (SIGKILL rc)
    "kill_at_step:step=7,rank=1"         only on trainer rank 1
    "nan_loss:step=5"                    loss becomes NaN at step 5
    "truncate_checkpoint:nth=2"          2nd committed payload is torn
    "truncate_checkpoint:nth=2,bytes=17" ... keeping only 17 bytes
    "store_flaky:fails=3"                first 3 store ops raise
    "store_flaky:fails=3,op=set"         ... only set()s
    "store_slow:delay=0.2"               every store op sleeps 0.2 s
    "kill_during_swap"                   weight swap dies after staging
    "slow_decode:delay=0.05,steps=3"     first 3 decode steps sleep
    "decode_error:fails=1"               first decode step(s) raise
    "replica_kill:nth=5"                 5th decode step dies fatally
    "pod_kill:at_request=3"              serving pod exits (rc 137) when
                                         its 3rd request arrives
    "pod_slow:delay=0.05,steps=3"        first 3 decode steps of this pod
                                         sleep (steps omitted = every one)
    "router_drop:nth=2"                  2nd routed request is lost in
                                         transit before the pod acks
    "page_pool_exhausted:times=3"        first 3 admission budget checks
                                         report the KV block pool full
    "mutate_signature:nth=3"             3rd replay check of a captured
                                         step sees a perturbed signature
    "mutate_signature:nth=3,mode=aval"   ... perturbing an argument aval
                                         (a CUDA graph pins no scalar:
                                         the default mode changes nothing)
    "draft_garbage"                      every speculative round's drafter
                                         proposals are replaced with
                                         garbage (output must not change)
    "draft_garbage:rounds=3"             ... only the first 3 rounds
    "kernel_mismatch"                    the next traced paged-attention
                                         route perturbs ONE output
                                         element: a parity gate must trip
    "kernel_mismatch:nth=2"              ... the 2nd trace instead
    "rank_preempt:step=4"                SIGTERM this process at step 4
    "rank_preempt:step=4,rank=1"         ... only on trainer rank 1
    "store_partition:secs=0.3"           every store op raises for 0.3 s
                                         from the first op in the window
    "step_hang:step=5,secs=30"           sleep 30 s inside the step-5 body

Points and their sites in this package:

    ===================  ====================================  ============
    point                site (serving/ unless named)          params
    ===================  ====================================  ============
    page_pool_exhausted  engine can_admit, can_import          times
    kill_during_swap     engine swap_weights, after staging    nth
    slow_decode          engine and spec decode steps          delay, steps
    pod_slow             engine and spec decode steps          delay, steps
    replica_kill         engine and spec decode steps (fatal)  nth
    decode_error         engine and spec decode steps          fails
    draft_garbage        spec_decode drafting round            rounds
    kernel_mismatch      ops/paged_attention route             nth
    truncate_checkpoint  incubate/checkpoint writer            nth, bytes
    mutate_signature     jit.TrainStep's signature check       nth, mode
    nan_loss             hapi.Model.train_batch                step
    store_flaky          distributed.store.TCPStore ops        fails, op
    store_slow           distributed.store.TCPStore ops        delay, op
    store_partition      distributed.store.TCPStore ops        secs
    kill_at_step         incubate/checkpoint CheckpointHook    step, rank
                         .on_step_end (1st)
    rank_preempt         CheckpointHook.on_step_end (2nd)      step, rank
    step_hang            CheckpointHook.on_step_end (3rd)      step, secs
    ===================  ====================================  ============

``pod_kill`` and ``router_drop`` parse, arm and fire like the reference's,
but their sites are in the serving fleet (``serving/{pod_worker,router}``,
ROADMAP queue 1 item 9), which is not ported. The ``net_*`` data-plane
points of the reference's ``testing/netfaults.py`` come with it too (their
sites are the fleet's wire): arming one raises.

Each firing bumps ``fault.injected.<point>`` in the registry and records a
``fault_injected`` explainer event.
"""
from __future__ import annotations

import os
import signal
import time

from ..profiler import explainer as _explain
from ..profiler import registry as _registry

__all__ = ["configure", "reset", "fire", "spec", "parse_spec", "store_op",
           "ACTIVE"]

# the gate every site reads before calling fire(): an unarmed process pays
# one module attribute load per site
ACTIVE = False

_points: dict = {}
_counters = _registry.scoped_counters("fault", {})


def _coerce(v):
    try:
        return int(v)
    except ValueError:
        try:
            return float(v)
        except ValueError:
            return v


def parse_spec(text):
    """Parse the spec grammar into ``{point: {param: value}}``."""
    table: dict = {}
    for part in (text or "").split(";"):
        part = part.strip()
        if not part:
            continue
        point, _, args = part.partition(":")
        params = {}
        for kv in args.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, _, v = kv.partition("=")
            params[k.strip()] = _coerce(v.strip())
        table[point.strip()] = params
    return table


def configure(spec_or_table):
    """Arm the points of a spec string or a parsed table; a falsy argument
    disarms everything (as :func:`reset`). Returns the table."""
    global ACTIVE
    table = parse_spec(spec_or_table) if isinstance(spec_or_table, str) \
        else dict(spec_or_table or {})
    net = sorted(p for p in table if p.startswith("net_"))
    if net:
        raise ValueError(
            f"fault points {net}: the data-plane chaos layer (the "
            "reference's testing/netfaults.py) is not ported")
    _points.clear()
    for point, params in table.items():
        _points[point] = {"params": dict(params), "count": 0}
        key = f"armed.{point}"
        _counters[key] = _counters.get(key, 0) + 1
    ACTIVE = bool(_points)
    return dict(table)


def reset():
    """Disarm every point (the ``fault.*`` counters stay)."""
    global ACTIVE
    _points.clear()
    ACTIVE = False


def spec():
    """The armed table."""
    return {k: dict(v["params"]) for k, v in _points.items()}


def _record(point, why, **detail):
    key = f"injected.{point}"
    _counters[key] = _counters.get(key, 0) + 1
    _explain.record("fault_injected", op=point, why=why, **detail)


def _nth(ent, p, key="nth"):
    """Count one evaluation; True on the ``p[key]``-th (default 1st)."""
    ent["count"] += 1
    return ent["count"] == int(p.get(key, 1))


def _budget(ent, p, key, default=1):
    """True for the first ``p[key]`` evaluations, counting them."""
    if ent["count"] >= int(p.get(key, default)):
        return False
    ent["count"] += 1
    return True


def fire(point, step=None, rank=None, path=None, op=None):
    """Evaluate one injection point. Returns True when the fault fired for
    points whose effect the caller applies (page_pool_exhausted,
    draft_garbage, kernel_mismatch, nan_loss, router_drop,
    mutate_signature), raises for the failing points, sleeps for the slow
    ones, truncates for truncate_checkpoint and never returns for
    kill_at_step and pod_kill. False when the point is not armed or not
    due."""
    ent = _points.get(point)
    if ent is None:
        return False
    p = ent["params"]
    want_rank = p.get("rank")
    if want_rank is not None and rank is None:
        rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    if want_rank is not None and int(want_rank) != int(rank):
        return False

    if point in ("kill_at_step", "nan_loss", "rank_preempt", "step_hang"):
        if step is None or int(step) != int(p.get("step", -1)):
            return False
        if point == "kill_at_step":
            _record(point, f"killing rank at step {step}", step=step,
                    rank=rank)
            os._exit(137)  # like a preempted worker: no atexit, no flush
        if point == "nan_loss":
            _record(point, f"loss poisoned with NaN at step {step}",
                    step=step)
            return True
        if ent["count"]:
            return False  # one per process
        ent["count"] += 1
        if point == "rank_preempt":
            _record(point, f"SIGTERM (preemption notice) at step {step}",
                    step=step, rank=rank)
            os.kill(os.getpid(), signal.SIGTERM)
            return True
        secs = float(p.get("secs", 30.0))
        _record(point, f"step {step} body wedged for {secs}s (watchdog "
                       "must trip)", step=step)
        time.sleep(secs)
        return True

    if point == "store_partition":
        start = ent.setdefault("window_start", time.monotonic())
        remaining = float(p.get("secs", 0.3)) - (time.monotonic() - start)
        if remaining <= 0:
            return False
        if ent["count"] == 0:
            _record(point, f"store partitioned for {p.get('secs', 0.3)}s "
                           "(every op raises until it heals)", store_op=op)
        ent["count"] += 1
        raise ConnectionError(
            f"injected store partition ({remaining:.2f}s remaining)")

    if point == "truncate_checkpoint":
        if not _nth(ent, p):
            return False
        keep = int(p.get("bytes", 0))
        try:
            with open(path, "r+b") as f:
                f.truncate(keep)
        except OSError:
            return False
        _record(point, f"truncated committed checkpoint to {keep} bytes",
                path=str(path))
        return True

    if point in ("store_flaky", "store_slow"):
        want_op = p.get("op")
        if want_op is not None and want_op != op:
            return False
        if point == "store_slow":
            delay = float(p.get("delay", 0.1))
            _record(point, f"store {op} delayed {delay}s", store_op=op)
            time.sleep(delay)
            return True
        if not _budget(ent, p, "fails"):
            return False
        _record(point, f"transient store failure #{ent['count']} ({op})",
                store_op=op)
        raise ConnectionError(
            f"injected transient store {op} failure "
            f"({ent['count']}/{int(p.get('fails', 1))})")

    if point == "kill_during_swap":
        # after every weight is staged, before the first is written: the
        # swap must leave the engine on its complete old weights
        if not _nth(ent, p):
            return False
        _record(point, "weight swap killed between staging and commit")
        raise RuntimeError(
            "injected failure during weight swap (kill_during_swap)")

    if point == "page_pool_exhausted":
        if not _budget(ent, p, "times"):
            return False
        _record(point, "KV block pool reported exhausted at admission "
                       f"check #{ent['count']}")
        return True

    if point in ("slow_decode", "pod_slow"):
        ent["count"] += 1
        steps = p.get("steps")
        if steps is not None and ent["count"] > int(steps):
            return False
        delay = float(p.get("delay", 0.05))
        _record(point, f"decode step #{ent['count']} delayed {delay}s")
        time.sleep(delay)
        return True

    if point == "pod_kill":
        if not _nth(ent, p, "at_request"):
            return False
        _record(point, f"serving pod killed at request #{ent['count']}")
        from ..profiler import tracing as _tracing

        _tracing.dump_flight_recorder(reason="fault:pod_kill")
        os._exit(137)

    if point == "router_drop":
        if not _nth(ent, p):
            return False
        _record(point, f"routed request #{ent['count']} lost before the "
                       "pod's ack")
        return True

    if point == "decode_error":
        if not _budget(ent, p, "fails"):
            return False
        _record(point, f"transient decode failure #{ent['count']}")
        raise RuntimeError(
            f"injected transient decode failure "
            f"({ent['count']}/{int(p.get('fails', 1))})")

    if point == "draft_garbage":
        ent["count"] += 1
        rounds = p.get("rounds")
        if rounds is not None and ent["count"] > int(rounds):
            return False
        _record(point, "drafter proposals replaced with garbage "
                       f"(round #{ent['count']})")
        return True

    if point == "kernel_mismatch":
        if not _nth(ent, p):
            return False
        _record(point, f"paged-attention trace #{ent['count']} perturbed "
                       "by one output element")
        return True

    if point == "mutate_signature":
        if not _nth(ent, p):
            return False
        _record(point, f"replay signature perturbed (mode="
                       f"{p.get('mode', 'scalar')}) at fast step "
                       f"{ent['count']}")
        return True

    if point == "replica_kill":
        if not _nth(ent, p):
            return False
        _record(point, f"replica killed at decode step {ent['count']}")
        from ..serving.engine import FatalEngineError

        raise FatalEngineError(
            f"injected replica death at decode step {ent['count']} "
            "(replica_kill)")

    return False


def _from_env():
    text = os.environ.get("FLAGS_fault_inject", "")
    if text:
        configure(text)


_from_env()


def store_op(op):
    """The rendezvous store's one fault site per operation: ``store_slow``,
    then ``store_flaky``, then ``store_partition`` (the reference's
    ``store_op``)."""
    fire("store_slow", op=op)
    fire("store_flaky", op=op)
    fire("store_partition", op=op)
