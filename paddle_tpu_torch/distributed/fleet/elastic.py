"""Elastic training: membership, liveness, hang detection, coordinated
preemption, zombie fencing and world resizes (counterpart of
paddle_tpu/distributed/fleet/elastic.py, the reference's
``fleet/elastic/manager.py``).

Everything goes through the rendezvous ``distributed.store.TCPStore``
(``csrc/tcpstore``), with the reference's keys, values and scopes byte for
byte, so a watcher of either package reads what the other published on the
same store:

    <scope>/gen, <scope>/claim/<g>, <scope>/members/<g>   generations
    <scope>/world_epoch                                   membership epoch
    <scope>/lease/<gen>/<rank>                            heartbeat leases
    <scope>/hang/<gen>/<rank>                             watchdog marks
    <scope>/preempt/<gen>, .../claim, preempt_ack/<g>/<s> preemption
    <scope>/barrier/<epoch>/<name>                        fenced barriers
    <scope>/resize_seq, <scope>/resize/<seq>              resize requests
    <scope>/endpoint/<pod>, .../gen                       endpoints
    elastic/host/<gen>/<rank>, num_registered             ElasticManager

``ElasticManager`` supervises one host's trainer across crashes and world
resizes: leases are generation-scoped, so a dead generation's leases are
invisible and ``watch()`` holds again after a resize; on lease expiry the
lowest alive survivor publishes the next membership and every survivor
respawns its trainer with ``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM``
remapped and ``PADDLE_ELASTIC_GEN`` set. The trainer side is
``ElasticTrainContext``: a ``HeartbeatLease``, a ``StepWatchdog``, a
``PreemptionCoordinator`` and a ``GenerationFence``, wired into the step
loop by ``incubate.checkpoint.CheckpointHook(elastic=)`` and
``hapi.Model.fit(elastic=)``; ``distributed.launch``'s ``Pod`` is the
supervisor that restarts, shrinks and grows the world.

Recoveries count in the ``fault`` scope (``elastic.restarts``,
``elastic.resizes``, ``elastic.generation_bumps``,
``elastic.heartbeat_misses``, ``elastic.hang``, ``elastic.fenced_zombies``,
``elastic.lease_expiries``, ``elastic.coordinated_preempts``) and each one
records an explainer event. The module is host code: it imports no torch.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
import traceback

from ...profiler import explainer as _explain
from ...profiler import registry as _registry

__all__ = ["ElasticManager", "ElasticStatus", "publish_generation",
           "endpoint_key", "publish_endpoint", "resolve_endpoint",
           "HeartbeatLease", "StepWatchdog", "PreemptionCoordinator",
           "GenerationFence", "StaleGenerationError", "ElasticTrainContext",
           "request_resize", "pending_resize", "dump_thread_stacks",
           "world_epoch", "bump_world_epoch", "HANG_RC"]

# every trainer restart and world resize lands in the fault scope and
# the explainer ring
_counters = _registry.scoped_counters("fault", {
    "elastic.restarts": 0, "elastic.resizes": 0,
    "elastic.generation_bumps": 0, "elastic.heartbeat_misses": 0,
    "elastic.hang": 0, "elastic.fenced_zombies": 0,
    "elastic.lease_expiries": 0, "elastic.coordinated_preempts": 0})

# A watchdog-tripped trainer exits with this rc so the supervisor can
# tell "hung step, stacks dumped in the worker log" from an ordinary
# crash. 98 collides with no shell/signal convention in use here
# (137/143 are SIGKILL/SIGTERM, 17 is the serving FatalEngineError).
HANG_RC = 98


def publish_generation(store, world, log=None, scope="elastic"):
    """Publish a new elastic generation through a rendezvous store so
    watchers re-rendezvous with a restarted member. Shared by the launch
    ``Pod`` (trainer restarts), the serving ``ReplicaSupervisor``
    (replica restarts) and the serving ``ServingFleet`` (pod restarts,
    ``scope="serving"``) — one protocol, one implementation. ``scope``
    is the store key prefix: a serving fleet sharing a trainer's store
    publishes under its own namespace so the two supervision planes
    cannot race each other's generation counters.

    Mirrors ``ElasticManager._publish`` exactly: exclusive claim via
    ``add()==1`` (a racing publisher must not double-bump), members
    written FIRST (a bump without members wedges every watcher), then
    the gen pointer. Membership is the full 0..world-1 range — an
    in-place restart replaces a member, it does not shrink the job.
    Best-effort: store errors are logged and swallowed (the restart
    itself must proceed). Returns True when this call owned the bump.

    Superseded generations are garbage-collected at publish time: once gen N+1 is live no watcher may consume
    a ``members/claim`` record older than N — watchers poll the gen
    pointer and read only the CURRENT generation's members — so a
    long-running elastic job no longer accretes one key pair per
    restart. Generation N itself is kept (a watcher mid-read of the
    previous generation must not lose it)."""
    if store is None:
        return False
    try:
        gen = int(store.add(f"{scope}/gen", 0))
        if int(store.add(f"{scope}/claim/{gen + 1}", 1)) != 1:
            return False  # another publisher owns generation gen+1
        members = ",".join(str(r) for r in range(int(world)))
        store.set(f"{scope}/members/{gen + 1}", members)
        if int(store.add(f"{scope}/gen", 0)) == gen:
            store.add(f"{scope}/gen", 1)
        _counters["elastic.generation_bumps"] += 1
        # expire everything older than the PREVIOUS generation; the
        # backward walk stops at the first missing record, so steady
        # state deletes exactly one superseded pair per bump
        if hasattr(store, "delete_key"):
            g = gen - 1
            while g > 0 and (store.delete_key(f"{scope}/members/{g}")
                             | store.delete_key(f"{scope}/claim/{g}")):
                g -= 1
        return True
    except Exception as e:  # rendezvous best-effort: restart anyway
        if log is not None:
            log(f"elastic generation bump failed: {e}")
        return False


# -------------------------------------------------- endpoint publication --
#
# Endpoints go through the rendezvous store, so a pod can live on any
# host:
#
#   {scope}/endpoint/{pod}      JSON {host, port, data_port, role,
#                               generation, pid}
#   {scope}/endpoint/{pod}/gen  monotone counter (add()-published), so
#                               watchers can cheaply poll for "newer
#                               than what I have"
#
# Generation = the pod's restart count (PADDLE_RESTART_COUNT): a
# respawned pod publishes gen N+1, and readers asking for min_gen=N+1
# never resolve the dead incarnation's address — stale-generation
# REJECTION is the reader's job and is encoded in resolve_endpoint.


def endpoint_key(pod, scope="serving"):
    return f"{scope}/endpoint/{pod}"


def publish_endpoint(store, pod, host, port, generation, role="serve",
                     data_port=0, scope="serving", log=None):
    """Publish this pod incarnation's endpoints. Monotone by
    generation: a slow/stale publisher (an old incarnation flushing its
    dying breath after the respawn already registered) never overwrites
    a newer record. Best-effort like publish_generation — the pod must
    serve even if the store hiccups (callers retry via republish)."""
    import json as _json

    if store is None:
        return False
    key = endpoint_key(pod, scope)
    doc = {"host": host, "port": int(port), "data_port": int(data_port),
           "role": role, "generation": int(generation),
           "pid": os.getpid()}
    try:
        if store.check(key):
            try:
                cur = _json.loads(store.get(key))
                if int(cur.get("generation", -1)) > int(generation):
                    _explain.record(
                        "stale_endpoint_publish", op="endpoint",
                        why=f"pod {pod} gen {generation} yielded to "
                            f"newer gen {cur['generation']}", pod=pod)
                    return False
            except Exception:
                pass  # unreadable record: overwrite it
        store.set(key, _json.dumps(doc))
        store.add(f"{key}/gen", 1)
        return True
    except Exception as e:
        if log is not None:
            log(f"endpoint publish failed for pod {pod}: {e}")
        return False


def unpublish_endpoint(store, pod, scope="serving", log=None):
    """Garbage-collect a pod's endpoint record on CLEAN teardown: a
    drained fleet must not leave `endpoint/*`
    keys behind for the next job sharing the rendezvous store to trip
    over (resolve_endpoint would happily return the dead incarnation's
    address — same-generation records pass the staleness check).
    Deletes the JSON doc and its poll counter; best-effort like every
    rendezvous op (a crashed pod leaves its record, and the next
    incarnation's higher generation supersedes it). Returns True when
    the record existed and is now gone."""
    if store is None:
        return False
    key = endpoint_key(pod, scope)
    try:
        if not hasattr(store, "delete_key"):
            return False
        existed = store.delete_key(key)
        store.delete_key(f"{key}/gen")
        return existed
    except Exception as e:
        if log is not None:
            log(f"endpoint unpublish failed for pod {pod}: {e}")
        return False


def resolve_endpoint(store, pod, scope="serving", min_gen=0,
                     timeout=0.0):
    """Resolve a pod's endpoint record, REJECTING stale generations:
    returns the JSON doc once its generation is >= min_gen, or None
    when `timeout` seconds pass without one (timeout 0 = one shot).
    A rejected stale record lands in the explainer so 'router kept
    dialing a dead pod' is diagnosable, not silent."""
    import json as _json

    if store is None:
        return None
    key = endpoint_key(pod, scope)
    deadline = time.time() + float(timeout)
    stale_seen = None
    while True:
        try:
            if store.check(key):
                doc = _json.loads(store.get(key))
                if int(doc.get("generation", -1)) >= int(min_gen):
                    return doc
                stale_seen = doc.get("generation")
        except Exception:
            pass  # store hiccup: poll again inside the window
        if time.time() >= deadline:
            break
        time.sleep(0.05)
    if stale_seen is not None:
        _explain.record(
            "stale_endpoint_rejected", op="endpoint",
            why=f"pod {pod} endpoint gen {stale_seen} < required "
                f"{min_gen} (old incarnation); resolution refused",
            pod=pod)
    return None


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


class ElasticManager:
    def __init__(self, args=None, store=None, rank=None, world_size=None,
                 heartbeat_interval=2.0, lease_ttl=10.0, claim_ttl=None):
        from ..store import TCPStore

        self.rank = rank if rank is not None else int(
            os.environ.get("PADDLE_TRAINER_ID", "0"))
        self.world_size = world_size or int(
            os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        if store is not None:
            self.store = store
        else:
            master = os.environ.get("PADDLE_MASTER", "127.0.0.1:8070")
            host, _, port = master.partition(":")
            self.store = TCPStore(host, int(port), is_master=self.rank == 0,
                                  world_size=self.world_size)
        self.heartbeat_interval = heartbeat_interval
        self.lease_ttl = lease_ttl
        # how long an unfulfilled generation claim may sit before another
        # survivor takes it over (the claimant itself may die mid-publish)
        self.claim_ttl = claim_ttl if claim_ttl is not None else 2 * lease_ttl
        self._claim_seen: dict = {}  # gen -> first unfulfilled observation
        self._stop = threading.Event()
        self._hb_thread = None
        self.need_restart = False
        # generation-scoped membership
        self.gen = 0
        self.members = list(range(self.world_size))

    # -- membership -----------------------------------------------------------
    def _lease_key(self, gen, rank):
        return f"elastic/host/{gen}/{rank}"

    def register(self):
        self.store.set(self._lease_key(self.gen, self.rank),
                       str(time.time()))
        self.store.add("num_registered", 1)

    def start_heartbeat(self):
        def beat():
            while not self._stop.is_set():
                self.store.set(self._lease_key(self.gen, self.rank),
                               str(time.time()))
                self._stop.wait(self.heartbeat_interval)

        self._hb_thread = threading.Thread(target=beat, daemon=True)
        self._hb_thread.start()

    def stop(self):
        self._stop.set()
        if self._hb_thread:
            self._hb_thread.join(timeout=2)

    def alive_ranks(self):
        """Current-generation members with a fresh lease."""
        now = time.time()
        alive = []
        for r in self.members:
            key = self._lease_key(self.gen, r)
            try:
                # non-blocking existence test first: a member that died
                # before registering has no key, and store.get() WAITS for
                # missing keys (reference TCPStore::get semantics)
                if not self.store.check(key):
                    continue
                ts = float(self.store.get(key).decode())
                if now - ts < self.lease_ttl:
                    alive.append(r)
            except Exception:
                # transient store error must not read as a death — only a
                # FRESHLY READ stale timestamp (or a never-written key)
                # counts as dead; wrongly pruning a live rank kills its
                # store server and cascades
                alive.append(r)
        return alive

    def _sync_generation(self):
        """Adopt a newer generation if one was published. True on change."""
        g = int(self.store.add("elastic/gen", 0))
        if g > self.gen:
            try:
                raw = self.store.get(f"elastic/members/{g}").decode()
            except TimeoutError:
                return False  # publish in flight; adopt on a later tick
            self.gen = g
            self.members = [int(x) for x in raw.split(",") if x != ""]
            return True
        return False

    def watch(self):
        """Reference manager.py watch loop: HOLD while the current
        generation's membership is fully alive; on lease expiry the lowest
        alive survivor publishes generation g+1 with the surviving member
        list, and every rank returns RESTART exactly once — after
        re-registering under g+1, watch() holds again."""
        if self._sync_generation():
            self.need_restart = True
            return ElasticStatus.RESTART
        alive = self.alive_ranks()
        if set(alive) != set(self.members):
            if not alive:
                return ElasticStatus.ERROR
            # leader publishes only after observing the SAME dead set on
            # two consecutive ticks (etcd-lease-style debounce: one stale
            # read under load must not shrink the world)
            if self.rank == min(alive) and \
                    getattr(self, "_pending_dead", None) == set(alive):
                new_gen = self.gen + 1
                # exclusive-claim guard: two survivors with divergent
                # alive-views can both pass the min(alive) check; only the
                # first add() on the claim key publishes, so elastic/gen
                # bumps exactly once per generation (a double bump would
                # point past the last members/<g> key and wedge everyone)
                if int(self.store.add(f"elastic/claim/{new_gen}", 1)) == 1:
                    self._publish(new_gen, alive)
                else:
                    # claim taken but unfulfilled: the claimant may have
                    # died between winning the claim and publishing
                    # (without this the survivors would HOLD forever).
                    # The claim is a LEASE: after claim_ttl without
                    # members/<g+1> appearing, one takeover attempt per
                    # claim_ttl window is allowed via an attempt-indexed
                    # claim key.
                    self._maybe_take_over_claim(new_gen, alive)
            self._pending_dead = set(alive)
            # the publish lands for everyone (including the leader) via
            # _sync_generation on the next watch tick
        else:
            self._pending_dead = None
        return ElasticStatus.HOLD

    def _publish(self, new_gen, alive):
        """Fulfill a won claim: write the membership, then bump the
        generation pointer. BOTH store-ops are guarded on the generation
        still being ours: a stale claimant resuming after a takeover must
        neither overwrite the membership other ranks already adopted
        (split-brain world sizes) nor double-bump the pointer. The
        remaining check-then-act window is a fraction of a tick, vs the
        ≥claim_ttl the claimant was already silent."""
        if int(self.store.add("elastic/gen", 0)) != self.gen:
            return  # superseded while we were stalled
        self.store.set(f"elastic/members/{new_gen}",
                       ",".join(str(r) for r in sorted(alive)))
        # a scale-in IS a membership change: advance the world epoch so
        # a partitioned member coming back late fences itself out
        # (GenerationFence) instead of rejoining a world it left
        bump_world_epoch(self.store)
        if int(self.store.add("elastic/gen", 0)) == self.gen:
            self.store.add("elastic/gen", 1)

    def _maybe_take_over_claim(self, new_gen, alive):
        if int(self.store.add("elastic/gen", 0)) != self.gen:
            # the world moved on — nothing to take over
            self._claim_seen.pop(new_gen, None)
            self._claim_seen.pop(("bump", new_gen), None)
            return
        if self.store.check(f"elastic/members/{new_gen}"):
            # membership written but the gen pointer never moved: the
            # claimant died BETWEEN the two publish store-ops. Finish the
            # publish for it (same claim_ttl patience). The bump itself is
            # guarded by an exclusive attempt-indexed key — two survivors
            # with divergent alive-views can BOTH reach this path in the
            # same window, and unguarded concurrent add()s would advance
            # gen past the last members/<g> key and wedge every rank.
            first = self._claim_seen.setdefault(("bump", new_gen),
                                                time.time())
            attempt = int((time.time() - first) // self.claim_ttl)
            if attempt >= 1 and int(self.store.add(
                    f"elastic/bump/{new_gen}/retry{attempt}", 1)) == 1 \
                    and int(self.store.add("elastic/gen", 0)) == self.gen:
                # finishing a dead claimant's publish is still a
                # MEMBERSHIP change: the epoch must advance too, or the
                # scaled-out member a takeover completed would pass the
                # fence forever. The exclusive retry key above keeps
                # this to one bump per takeover (a claimant that died
                # between its own epoch bump and the gen bump costs one
                # extra epoch tick — harmless: over-fencing only
                # affects ranks that ARE stale).
                bump_world_epoch(self.store)
                self.store.add("elastic/gen", 1)
            return
        first = self._claim_seen.setdefault(new_gen, time.time())
        attempt = int((time.time() - first) // self.claim_ttl)
        if attempt >= 1 and int(self.store.add(
                f"elastic/claim/{new_gen}/retry{attempt}", 1)) == 1:
            self._publish(new_gen, alive)

    # -- trainer lifecycle ----------------------------------------------------
    def local_rank_and_world(self):
        """This host's trainer rank/world in the current generation."""
        return self.members.index(self.rank), len(self.members)

    def run(self, cmd, env=None, max_restarts=3):
        """Supervise a trainer through failures AND world resizes.

        - trainer exits 0 → COMPLETED.
        - trainer crashes (no membership change) → restart in place, up to
          max_restarts.
        - a host's lease expires → survivors re-rendezvous at generation
          g+1: the trainer is stopped and respawned with PADDLE_TRAINER_ID
          / PADDLE_TRAINERS_NUM remapped to the surviving world (the
          trainer reloads its latest checkpoint on start — reference
          recovery contract). A rank not in the new membership exits EXIT.
        """
        restarts = 0
        self.register()
        self.start_heartbeat()
        # join barrier (reference manager waits for np nodes before
        # training): without it, an early-starting leader would prune
        # slow-joining members into a gen-1 world before they register
        join_deadline = time.time() + max(60.0, self.store.timeout)
        while time.time() < join_deadline:
            if all(self.store.check(self._lease_key(self.gen, r))
                   for r in self.members):
                break
            time.sleep(0.1)
        else:
            self.stop()
            return ElasticStatus.ERROR
        while True:
            cur_env = dict(env or os.environ)
            lr, lw = self.local_rank_and_world()
            cur_env.update({
                "PADDLE_TRAINER_ID": str(lr),
                "PADDLE_TRAINERS_NUM": str(lw),
                "PADDLE_ELASTIC_GEN": str(self.gen),
            })
            proc = subprocess.Popen(cmd, env=cur_env)
            status = None
            while proc.poll() is None:
                status = self.watch()
                if status == ElasticStatus.RESTART:
                    proc.send_signal(signal.SIGTERM)
                    try:
                        proc.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                    break
                if status == ElasticStatus.ERROR:
                    proc.kill()
                    self.stop()
                    return ElasticStatus.ERROR
                time.sleep(self.heartbeat_interval)
            if status == ElasticStatus.RESTART:
                if self.rank not in self.members:
                    self.stop()
                    return ElasticStatus.EXIT
                self.register()  # lease under the new generation
                self.need_restart = False
                _counters["elastic.resizes"] += 1
                _explain.record(
                    "elastic_resize", op="run",
                    why=f"re-rendezvous at generation {self.gen} with "
                        f"world {len(self.members)}",
                    gen=self.gen, members=list(self.members))
                continue  # resize restart is not a failure
            if proc.returncode == 0:
                self.stop()
                return ElasticStatus.COMPLETED
            restarts += 1
            if restarts > max_restarts:
                self.stop()
                return ElasticStatus.ERROR
            _counters["elastic.restarts"] += 1
            _explain.record(
                "elastic_restart", op="run",
                why=f"trainer crashed rc={proc.returncode}; in-place "
                    f"restart {restarts}/{max_restarts} with backoff",
                rc=proc.returncode, attempt=restarts)
            # exponential backoff: a crash-looping trainer must not spin
            # the host (reference elastic manager waits before respawn)
            time.sleep(min(1.0 * (2 ** (restarts - 1)), 30.0))


# -- elastic training loop ------------------------------------------------------
#
# Four trainer-side primitives plus a supervisor protocol, composing
# with launch.Pod's restarts and incubate.checkpoint's bitwise N->M
# resharding:
#
#   HeartbeatLease        liveness: a rank is alive while its store
#                         lease stays fresh — expiry means DEAD, even
#                         if the OS process still exists (hung NFS
#                         write, wedged collective, stuck CUDA call)
#   StepWatchdog          hang detection: a per-step deadline; a trip
#                         dumps every thread's Python stack, records an
#                         `elastic_hang` explainer event + the
#                         fault.elastic.hang counter, then escalates to
#                         the supervisor by exiting with HANG_RC
#   PreemptionCoordinator SIGTERM on ANY rank → every rank writes its
#                         emergency checkpoint at the SAME step
#                         boundary (store-coordinated), so the cross-
#                         rank manifest set is consistent for resume
#   GenerationFence       zombie fencing: a stale-generation rank can
#                         never write a checkpoint or join a barrier —
#                         it sees the bumped elastic/gen and fences out
#
# ElasticTrainContext bundles them from the PADDLE_* env so a trainer
# wires the whole loop with two lines (see CheckpointHook(elastic=...)).


def dump_thread_stacks():
    """Every thread's current Python stack as one formatted string
    (name + ident per thread). Pure stdlib — safe to call from the
    watchdog thread while the train thread is wedged."""
    names = {t.ident: t.name for t in threading.enumerate()}
    chunks = []
    for tid, frame in sys._current_frames().items():
        chunks.append(f"--- thread {names.get(tid, '?')} (ident {tid}) ---")
        chunks.extend(ln.rstrip() for ln in traceback.format_stack(frame))
    return "\n".join(chunks)


class HeartbeatLease:
    """Per-rank liveness lease through the TCPStore, renewed OFF the
    train thread.

    The reference elastic manager keeps etcd TTL leases per node
    (`fleet/elastic/manager.py:254-259`); here the lease is a timestamp
    under ``<scope>/lease/<gen>/<rank>`` that a daemon thread refreshes
    every ``interval`` seconds. The supervisor declares the rank dead
    when the timestamp goes stale past ``ttl`` — process-exit detection
    alone misses a trainer that is alive-but-wedged with its heartbeat
    thread dead, or a host whose kernel froze. Store errors never reach
    the train thread: each failed renewal bumps
    ``fault.elastic.heartbeat_misses`` and the next tick retries (the
    store op itself already retries transient transport errors)."""

    def __init__(self, store, rank, gen=0, interval=0.5, ttl=None,
                 scope="elastic"):
        self.store = store
        self.rank = int(rank)
        self.gen = int(gen)
        self.interval = float(interval)
        self.ttl = float(ttl) if ttl is not None else 6.0 * self.interval
        self.scope = scope
        self._stop = threading.Event()
        self._thread = None
        self._miss_streak = 0

    @staticmethod
    def key_for(scope, gen, rank):
        return f"{scope}/lease/{int(gen)}/{int(rank)}"

    @property
    def key(self):
        return self.key_for(self.scope, self.gen, self.rank)

    def _renew(self):
        try:
            self.store.set(self.key, str(time.time()))
            self._miss_streak = 0
            return True
        except Exception as e:
            _counters["elastic.heartbeat_misses"] += 1
            self._miss_streak += 1
            if self._miss_streak == 1:  # one event per outage, not per tick
                _explain.record(
                    "elastic_heartbeat_miss", op="lease",
                    why=f"rank {self.rank} lease renewal failed: {e}",
                    rank=self.rank, gen=self.gen)
            return False

    def start(self):
        """Write the first lease synchronously (the supervisor must see
        a registered rank before the first interval elapses), then renew
        on a daemon thread."""
        self._renew()
        if self._thread is None:
            def beat():
                while not self._stop.wait(self.interval):
                    self._renew()

            self._thread = threading.Thread(target=beat, daemon=True,
                                            name="elastic-heartbeat")
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    @staticmethod
    def age(store, scope, gen, rank):
        """Seconds since the rank's last renewal, or None when the rank
        never registered under this generation. Transient store errors
        read as None too — only a FRESHLY READ stale timestamp may be
        declared a death (same rule as ElasticManager.alive_ranks)."""
        key = HeartbeatLease.key_for(scope, gen, rank)
        try:
            if not store.check(key):
                return None
            return time.time() - float(store.get(key).decode())
        except Exception:
            return None


class StepWatchdog:
    """Hang/straggler detection: a deadline armed per train step.

    ``tick(step)`` at each step boundary re-arms the deadline; a step
    that fails to tick within ``deadline`` seconds trips the watchdog,
    which (1) dumps the Python stacks of every thread to ``sink`` (the
    worker log — the post-mortem for "what was the step stuck on"),
    (2) records a structured ``elastic_hang`` explainer event and bumps
    ``fault.elastic.hang``, then (3) escalates per ``escalate``:

    - ``"exit"`` (production): best-effort store mark under
      ``<scope>/hang/<gen>/<rank>``, then ``os._exit(HANG_RC)`` so the
      supervisor sees a distinctive rc and restarts/resizes the rank —
      a hung collective cannot be un-wedged from inside the process.
    - ``"report"`` (tests / advisory): record only; ``tripped`` stays
      set and ``on_trip`` (if given) is called with the event dict.

    The monitor thread is cheap (one monotonic compare per poll) and
    the train thread's cost is one attribute store per tick."""

    def __init__(self, deadline=120.0, escalate="exit", sink=None,
                 on_trip=None, store=None, rank=0, gen=0, scope="elastic",
                 poll=None):
        self.deadline = float(deadline)
        self.escalate = escalate
        self.sink = sink  # file-like; defaults to sys.stderr at trip time
        self.on_trip = on_trip
        self.store, self.rank, self.gen = store, int(rank), int(gen)
        self.scope = scope
        self._poll = float(poll) if poll else min(self.deadline / 4.0, 1.0)
        self._armed_at = None  # monotonic, None = disarmed
        self._step = None
        self._stop = threading.Event()
        self._thread = None
        self.tripped = False

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._monitor,
                                            daemon=True,
                                            name="elastic-watchdog")
            self._thread.start()
        return self

    def arm(self, step):
        self._step = step
        self._armed_at = time.monotonic()

    def disarm(self):
        self._armed_at = None

    def tick(self, step):
        """Step boundary: the previous step completed in time; arm the
        deadline for the next one."""
        self.arm(step + 1)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _monitor(self):
        while not self._stop.wait(self._poll):
            armed = self._armed_at
            if armed is None or self.tripped:
                continue
            overdue = time.monotonic() - armed - self.deadline
            if overdue >= 0:
                self._trip(overdue)

    def _trip(self, overdue):
        self.tripped = True
        stacks = dump_thread_stacks()
        why = (f"step {self._step} exceeded its {self.deadline:.1f}s "
               f"deadline by {overdue:.1f}s")
        _counters["elastic.hang"] += 1
        ev = _explain.record("elastic_hang", op="watchdog", why=why,
                             step=self._step, rank=self.rank, gen=self.gen,
                             deadline=self.deadline)
        sink = self.sink or sys.stderr
        try:
            sink.write(f"[elastic] WATCHDOG: {why} — thread stacks:\n"
                       f"{stacks}\n")
            sink.flush()
        except Exception:
            pass
        if self.on_trip is not None:
            try:
                self.on_trip(ev)
            except Exception:
                pass
        try:
            # the flight recorder lands next to the stack dump: stacks
            # say where the process is stuck, the flight ring says what
            # requests it was running when it got there
            from ...profiler import tracing as _tracing

            _tracing.dump_flight_recorder(reason=f"watchdog: {why}")
        except Exception:
            pass
        if self.escalate == "exit":
            if self.store is not None:
                try:  # best-effort breadcrumb for the supervisor
                    self.store.set(f"{self.scope}/hang/{self.gen}/"
                                   f"{self.rank}", why)
                except Exception:
                    pass
            os._exit(HANG_RC)


class PreemptionCoordinator:
    """Fleet-wide emergency-checkpoint barrier (coordinated preemption).

    A maintenance event SIGTERMs ranks at slightly different
    instants; uncoordinated emergency saves land on different steps and
    the resharder then merges a FRANKENSTEIN manifest set. Protocol:

    1. Any rank's SIGTERM handler (CheckpointHook) calls
       ``announce(step)``: first announcer wins via ``add()==1`` on the
       claim key, writes the target step (its NEXT boundary) under
       ``<scope>/preempt/<gen>``, and every rank — announcer included —
       adopts that one target.
    2. A poll thread (off the train thread) mirrors the store notice
       into a local event; the train loop's step-boundary check is a
       plain ``Event.is_set()`` — zero store ops per step.
    3. At the first boundary with ``step >= target`` each rank calls
       ``barrier(step)`` (ack counter under the generation), waits for
       ``world`` acks (bounded — a rank that died before acking must
       not eat the grace window), writes its emergency shard, exits.

    All ranks therefore save the same step, and
    ``incubate.checkpoint.load_resharded`` sees one consistent
    manifest set across the whole fleet."""

    def __init__(self, store, rank, world, gen=0, scope="elastic",
                 poll=0.25, barrier_timeout=30.0):
        self.store = store
        self.rank, self.world, self.gen = int(rank), int(world), int(gen)
        self.scope = scope
        self.poll = float(poll)
        self.barrier_timeout = float(barrier_timeout)
        self._event = threading.Event()
        self._target = None
        self._stop = threading.Event()
        self._thread = None

    @property
    def _key(self):
        return f"{self.scope}/preempt/{self.gen}"

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._watch, daemon=True,
                                            name="elastic-preempt-watch")
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _adopt(self):
        try:
            if not self.store.check(self._key):
                return False
            self._target = int(self.store.get(self._key).decode())
            self._event.set()
            return True
        except Exception:
            return False  # transient store error: retry next poll

    def _watch(self):
        while not self._stop.wait(self.poll):
            if self._event.is_set() or self._adopt():
                return

    def announce(self, step):
        """Local preemption notice → fleet-wide target step. The first
        announcer publishes ``step + 1`` (its next boundary); racing
        announcers adopt the winner's target. Safe from a signal-
        handler-adjacent path: one add + one set/get."""
        try:
            if int(self.store.add(f"{self._key}/claim", 1)) == 1:
                self._target = int(step) + 1
                self.store.set(self._key, str(self._target))
                _counters["elastic.coordinated_preempts"] += 1
                _explain.record(
                    "elastic_preempt", op="announce",
                    why=f"rank {self.rank} announced coordinated "
                        f"preemption; fleet saves at step {self._target}",
                    rank=self.rank, gen=self.gen, target=self._target)
            else:
                # we lost the claim race: the winner may not have
                # WRITTEN the target yet (its set() follows its add()).
                # Spin briefly for it — giving up immediately would set
                # the event with _target=None and this rank would save
                # uncoordinated at its own step, the exact Frankenstein
                # manifest the coordinator exists to prevent. After the
                # wait, a still-missing target means the winner died
                # mid-announce: degrade to the uncoordinated local save.
                deadline = time.monotonic() + 2.0
                while not self._adopt() and time.monotonic() < deadline:
                    time.sleep(0.02)
        except Exception as e:
            # store down mid-preemption: fall back to an uncoordinated
            # local emergency save — losing coordination beats losing
            # the checkpoint
            self._target = int(step) + 1
            _explain.record(
                "elastic_preempt", op="announce_local",
                why=f"store unreachable during preemption ({e}); "
                    f"uncoordinated emergency save", rank=self.rank)
        self._event.set()

    @property
    def triggered(self):
        return self._event.is_set()

    def poke(self):
        """Synchronous notice check, for callers already paying a store
        round-trip (the per-step fence barrier). The poll thread
        normally wins; this closes the starvation race where a rank
        reaches its save boundary before its poll thread ever ran —
        without it, a stalled peer can march into a step barrier the
        announcer has already left."""
        if not self._event.is_set():
            self._adopt()
        return self._event.is_set()

    def should_save(self, step):
        """True at the first step boundary at/past the fleet target."""
        if not self._event.is_set():
            return False
        return self._target is None or int(step) >= self._target

    def save_step(self, step):
        """The fleet-agreed save step (the announced target) — the
        barrier ack key, so a rank that adopted the notice a boundary
        late still rendezvouses under the SAME key as its peers. Falls
        back to the local step when no target exists (store was down at
        announce time: uncoordinated save)."""
        return int(step) if self._target is None else self._target

    def barrier(self, step, timeout=None):
        """Rendezvous the fleet at the save boundary. Returns the number
        of ranks that acked within the timeout (== world on a clean
        barrier); a short count means some rank died pre-ack and the
        survivors save anyway — their shards still share the step."""
        key = f"{self.scope}/preempt_ack/{self.gen}/{int(step)}"
        deadline = time.monotonic() + (timeout or self.barrier_timeout)
        try:
            n = int(self.store.add(key, 1))
            while n < self.world and time.monotonic() < deadline:
                time.sleep(0.02)
                n = int(self.store.add(key, 0))
            return n
        except Exception:
            return 1  # store down: this rank saves alone


class StaleGenerationError(RuntimeError):
    """A rank tried to act (checkpoint write, barrier join) under an
    elastic generation the world has already moved past — it was resized
    away or declared dead while it wasn't looking. The only safe action
    is to exit without touching shared state."""

    def __init__(self, own_gen, current_gen, rank=None, what=""):
        self.own_gen, self.current_gen = int(own_gen), int(current_gen)
        self.rank = rank
        super().__init__(
            f"stale elastic generation: rank {rank} holds gen "
            f"{own_gen} but the world is at gen {current_gen}"
            + (f" (refusing {what})" if what else "")
            + " — this rank was resized out; it must exit without "
              "writing checkpoints or joining collectives")


def world_epoch(store, scope="elastic"):
    """The membership generation: bumped ONLY when the world's
    membership changes (a supervisor resize / survivor re-rendezvous),
    never by an in-place single-rank restart. The plain ``<scope>/gen``
    counter moves on every restart (the re-rendezvous contract), so
    fencing on it would evict live survivors whenever one sibling
    crash-restarts; the epoch is the fence's key instead."""
    return int(store.add(f"{scope}/world_epoch", 0))


def bump_world_epoch(store, scope="elastic"):
    """Advance the membership generation (resize publishers only)."""
    return int(store.add(f"{scope}/world_epoch", 1))


class GenerationFence:
    """Zombie fencing at the store barrier.

    Every rank carries the membership generation (world epoch) it was
    spawned under — ``PADDLE_WORLD_EPOCH`` from the supervisor, or read
    from the store at construction. Before any externally visible act
    it re-reads the epoch: a newer value means a resize already
    republished the world without this rank — whatever it was doing
    (finishing a slow step, draining an async checkpoint queue, coming
    back from a network partition) it is now a zombie, and a zombie
    that writes a checkpoint shard or joins a collective corrupts the
    NEW world's state. ``check`` is advisory (False + one
    ``fault.elastic.fenced_zombies`` count per fence);
    ``assert_current``/``barrier`` raise :class:`StaleGenerationError`.

    Transient store errors read as CURRENT — wrongly fencing a live
    rank on a dropped packet would shrink the world for nothing (the
    same asymmetry as lease reads)."""

    def __init__(self, store, gen=None, rank=0, scope="elastic"):
        self.store = store
        self.gen = world_epoch(store, scope) if gen is None else int(gen)
        self.rank = int(rank)
        self.scope = scope
        self._fenced = False

    def current_gen(self):
        return world_epoch(self.store, self.scope)

    def check(self, what=""):
        """True when this rank's generation is still the world's."""
        try:
            cur = self.current_gen()
        except Exception:
            return True
        if cur <= self.gen:
            return not self._fenced
        if not self._fenced:  # one count/event per zombie, not per probe
            self._fenced = True
            _counters["elastic.fenced_zombies"] += 1
            _explain.record(
                "elastic_fenced", op="fence",
                why=f"rank {self.rank} fenced: holds gen {self.gen}, "
                    f"world is at gen {cur}"
                    + (f" (blocked {what})" if what else ""),
                rank=self.rank, own_gen=self.gen, current_gen=cur)
        return False

    def assert_current(self, what=""):
        if not self.check(what):
            raise StaleGenerationError(self.gen, self.current_gen(),
                                       rank=self.rank, what=what)

    def barrier(self, name, world, timeout=30.0, abort=None):
        """Generation-scoped rendezvous: ``world`` ranks ack
        ``<scope>/barrier/<gen>/<name>``; a stale-generation rank raises
        BEFORE acking (the fence point the tentpole names — a zombie can
        never complete a collective with the new world), and the fence
        is re-checked while waiting so a resize mid-barrier releases the
        doomed waiters instead of timing them out.

        ``abort`` (port only; the keys are the reference's): a callable
        polled while waiting; when it returns true the wait ends and the
        barrier returns None, as a rank whose sibling restarted in place
        gives up a barrier that rank will never reach."""
        self.assert_current(f"barrier {name}")
        key = f"{self.scope}/barrier/{self.gen}/{name}"
        n = int(self.store.add(key, 1))
        deadline = time.monotonic() + float(timeout)
        while n < int(world):
            if abort is not None and abort():
                return None
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"elastic barrier {name!r}: {n}/{world} ranks after "
                    f"{timeout}s (gen {self.gen})")
            time.sleep(0.02)
            self.assert_current(f"barrier {name}")
            n = int(self.store.add(key, 0))
        return n


# -- supervisor resize protocol ----------------------------------------------

def request_resize(store, world, scope="elastic"):
    """Ask the supervising Pod to resize the job to ``world`` ranks at
    its next supervision tick (operator shrink ahead of a maintenance
    event, or grow when capacity returns). Append-only protocol: bump
    ``<scope>/resize_seq``, write the target world under the new
    sequence number; the Pod consumes requests by tracking the last
    sequence it acted on (the store does support delete_key now, but
    consume-by-sequence needs no GC — a request key is one small write
    per OPERATOR action, unlike the per-restart generation/endpoint
    records that publish_generation/unpublish_endpoint collect).
    Returns the sequence number."""
    seq = int(store.add(f"{scope}/resize_seq", 1))
    store.set(f"{scope}/resize/{seq}", str(int(world)))
    _explain.record("elastic_resize_request", op="request_resize",
                    why=f"resize to world {int(world)} requested "
                        f"(seq {seq})", world=int(world), seq=seq)
    return seq


def pending_resize(store, after_seq, scope="elastic"):
    """Newest resize request with sequence > ``after_seq`` as
    ``(seq, world)``, or None. Transient store errors read as
    no-request (the next tick retries)."""
    try:
        seq = int(store.add(f"{scope}/resize_seq", 0))
        if seq <= int(after_seq):
            return None
        return seq, int(store.get(f"{scope}/resize/{seq}").decode())
    except Exception:
        return None


class ElasticTrainContext:
    """One-object bundle of the trainer-side elastic pieces, built from
    the ``PADDLE_*`` env the launcher provides::

        store = TCPStore(host, port)               # PADDLE_MASTER
        ctx = ElasticTrainContext(store=store, step_deadline=120).start()
        hook = CheckpointHook(dir, net, opt, reshard=True, elastic=ctx,
                              rank=ctx.rank, world_size=ctx.world,
                              shard=True)
        start = hook.restore()                     # resharded N->M resume
        for step in range(start, total):
            loss = train_step(batch(step))
            if hook.on_step_end(step) in ("preempted", "fenced"):
                break
        ctx.stop()

    Components are None when their dependency is absent (no store → no
    lease/coordinator/fence; no ``step_deadline`` → no watchdog), so the
    same trainer code runs un-elastic in single-process tests."""

    def __init__(self, store=None, rank=None, world=None, gen=None,
                 scope="elastic", heartbeat_interval=0.5, lease_ttl=None,
                 step_deadline=None, watchdog_escalate="exit",
                 preempt_poll=0.25, watchdog_sink=None):
        self.rank = int(os.environ.get("PADDLE_TRAINER_ID", "0")) \
            if rank is None else int(rank)
        self.world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1")) \
            if world is None else int(world)
        self.gen = int(os.environ.get("PADDLE_ELASTIC_GEN", "0")) \
            if gen is None else int(gen)
        self.scope = scope
        self.store = store
        self.lease = self.coordinator = self.fence = self.watchdog = None
        if store is not None:
            self.lease = HeartbeatLease(store, self.rank, gen=self.gen,
                                        interval=heartbeat_interval,
                                        ttl=lease_ttl, scope=scope)
            self.coordinator = PreemptionCoordinator(
                store, self.rank, self.world, gen=self.gen, scope=scope,
                poll=preempt_poll)
            # the fence keys on the WORLD EPOCH (membership generation),
            # not elastic/gen: in-place restarts bump the latter for
            # re-rendezvous, and survivors of a sibling's restart are
            # not zombies. The supervisor hands the epoch down in env;
            # otherwise read it at construction (post-resize spawns see
            # the post-bump value).
            epoch = os.environ.get("PADDLE_WORLD_EPOCH")
            self.fence = GenerationFence(
                store, gen=None if epoch is None else int(epoch),
                rank=self.rank, scope=scope)
        if step_deadline:
            self.watchdog = StepWatchdog(
                deadline=step_deadline, escalate=watchdog_escalate,
                store=store, rank=self.rank, gen=self.gen, scope=scope,
                sink=watchdog_sink)

    def start(self, first_step=0):
        if self.lease is not None:
            self.lease.start()
        if self.coordinator is not None:
            self.coordinator.start()
        if self.watchdog is not None:
            self.watchdog.start()
            self.watchdog.arm(first_step)
        return self

    def step_boundary(self, step):
        """Call once per completed step (CheckpointHook does this): the
        watchdog deadline re-arms for the next step."""
        if self.watchdog is not None:
            self.watchdog.tick(step)

    def fence_check(self, what=""):
        return True if self.fence is None else self.fence.check(what)

    def barrier(self, name, timeout=30.0, abort=None):
        """Generation-fenced store barrier over the current world
        (``abort``: :meth:`GenerationFence.barrier`'s; an aborted barrier
        returns None)."""
        if self.fence is None:
            return 0
        n = self.fence.barrier(name, self.world, timeout=timeout,
                               abort=abort)
        if n is None:
            return None
        # a peer's ack on this barrier ORDERS AFTER its announce(), so
        # any preemption notice published before the barrier completed
        # is visible now — checking here makes lockstep ranks adopt the
        # fleet save target deterministically even when the async poll
        # thread is starved
        coord = getattr(self, "coordinator", None)
        if coord is not None:
            coord.poke()
        return n

    @property
    def preempt_requested(self):
        return (self.coordinator is not None
                and self.coordinator.triggered)

    def stop(self):
        for part in (self.watchdog, self.coordinator, self.lease):
            if part is not None:
                part.stop()

    close = stop
