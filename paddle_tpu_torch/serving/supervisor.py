"""Supervision of serving replicas (counterpart of
paddle_tpu/serving/supervisor.py).

``ReplicaSupervisor`` keeps in-process serving replicas alive (one
``GenerationServer`` and its engine each, built by ``engine_factory``) as
``distributed.launch``'s ``Pod`` keeps trainer ranks alive, with the same
conventions: exponential restart backoff as a per-replica deadline (a
crash-looping replica never stalls its siblings), a ``max_restarts``
budget, and a generation published through the rendezvous store on every
respawn (``fleet.elastic.publish_generation``) when a ``store`` is given.

Crash recovery: a replica dies when its engine raises ``FatalEngineError``
(a lost device; the ``replica_kill`` fault point). The supervisor takes
over every queued and in-flight request of the dead replica
(``scheduler.takeover_requests``): they stay unfinished, so callers
blocked on ``result()`` keep waiting, and are re-submitted to a healthy
or restarted replica. Every request gets an explicit seed at its first
submission, and sampling depends only on (engine base key, request seed,
token index), so with a fixed ``rng_seed`` in the factory a replay gives
the same tokens bitwise. The dead replica's engine (its KV pools and its
graphs' memory pool) is released before the respawn builds a new one.

Autoscaling follows the schedulers' telemetry: queue depth per healthy
replica at or above ``scale_up_queue_depth`` adds a replica (up to
``max_replicas``); an idle fleet (nothing queued, occupancy at most
``scale_down_occupancy``) drains one (down to ``min_replicas``). Counters
``serving.replica_restarts``, ``replicas_retired``, ``scale_ups``,
``scale_downs``, the ``serving.replicas`` gauge, and an explainer event
for each action.
"""
from __future__ import annotations

import gc
import itertools
import threading
import time

from ..profiler import explainer as _explain
from ..profiler import registry as _registry
from .scheduler import GenerationRequest, QueueFullError, RequestStatus
from .server import GenerationServer

__all__ = ["ReplicaSupervisor"]

_counters = _registry.scoped_counters("serving", {
    "replica_restarts": 0, "replicas_retired": 0,
    "scale_ups": 0, "scale_downs": 0})


class _Replica:
    __slots__ = ("rid", "server", "restarts", "respawn_at", "retired")

    def __init__(self, rid, server):
        self.rid = rid
        self.server = server
        self.restarts = 0
        self.respawn_at = None  # pending-backoff deadline, launch-Pod style
        self.retired = False

    @property
    def healthy(self):
        return (not self.retired and self.respawn_at is None
                and self.server is not None
                and self.server.fatal_error is None)


class ReplicaSupervisor:
    """Supervise N serving replicas: restart on crash (backoff + budget),
    re-queue the dead replica's requests, scale the fleet off queue-depth
    and occupancy telemetry.

    ``engine_factory`` builds one engine per replica; pass a fixed
    ``rng_seed`` through it for the bitwise replay contract::

        sup = ReplicaSupervisor(
            lambda: GenerationEngine(model, max_batch_size=4, rng_seed=7),
            replicas=2, max_replicas=4)
        req = sup.submit(prompt_ids, max_new_tokens=32)
        print(req.result(60).tokens)
        sup.shutdown()
    """

    def __init__(self, engine_factory, replicas=1, min_replicas=None,
                 max_replicas=None, max_restarts=3, restart_backoff=0.05,
                 monitor_interval=0.02, scale_up_queue_depth=4,
                 scale_down_occupancy=0.1, scale_interval=1.0,
                 max_queue_size=16, idle_wait_s=0.005, store=None):
        self._factory = engine_factory
        self.min_replicas = int(min_replicas if min_replicas is not None
                                else max(1, int(replicas)))
        self.max_replicas = int(max_replicas if max_replicas is not None
                                else max(int(replicas), self.min_replicas))
        self.max_restarts = int(max_restarts)
        self.restart_backoff = float(restart_backoff)
        self.monitor_interval = float(monitor_interval)
        self.scale_up_queue_depth = int(scale_up_queue_depth)
        self.scale_down_occupancy = float(scale_down_occupancy)
        self.scale_interval = float(scale_interval)
        self._server_kwargs = {"max_queue_size": int(max_queue_size),
                               "idle_wait_s": float(idle_wait_s)}
        self.store = store
        self._replicas: list[_Replica] = []
        self._held: list = []  # orphans waiting for a healthy replica
        self._lock = threading.Lock()
        self._rid = itertools.count()
        self._seeds = itertools.count()
        self._stop = threading.Event()
        self._monitor = None
        self._last_scale = time.monotonic()
        self._scaling = False  # one in-flight scale action at a time
        for _ in range(max(1, int(replicas))):
            self._replicas.append(_Replica(next(self._rid),
                                           self._new_server()))
        _registry.gauge_set("serving.replicas", len(self._replicas))

    # ----------------------------------------------------------- control --
    def _new_server(self):
        srv = GenerationServer(engine=self._factory(),
                               fail_fast_on_fatal=False,
                               **self._server_kwargs)
        srv.start()
        return srv

    def start(self):
        if self._monitor is not None and self._monitor.is_alive():
            return self
        if self._stop.is_set():
            raise RuntimeError("supervisor was shut down; build a new one")
        self._monitor = threading.Thread(
            target=self._monitor_loop,
            name="paddle-tpu-torch-serve-supervisor",
            daemon=True)
        self._monitor.start()
        return self

    def shutdown(self, drain=True, timeout=None):
        """Stop supervision and every replica. drain=True finishes all
        in-flight work first; held orphans that never found a replica are
        failed either way (nothing will ever run them)."""
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5)
        ok = True
        for rep in self._replicas:
            if rep.server is None:
                continue
            if rep.server.fatal_error is not None:
                # dead replica nobody handled yet: its worker is gone, a
                # drain would strand the requests un-finished forever
                with self._lock:
                    self._held.extend(rep.server.scheduler
                                      .takeover_requests())
            ok = rep.server.shutdown(drain=drain, timeout=timeout) and ok
        with self._lock:
            held, self._held = self._held, []
        for req in held:
            if not req.done:
                req.status = RequestStatus.ERROR
                req.error = "supervisor shutdown before replay"
                req.finished.set()
        return ok

    # ---------------------------------------------------------- frontend --
    def submit(self, prompt_ids, **options):
        """Enqueue on the least-loaded healthy replica. The request seed
        is pinned HERE (explicit, from the supervisor's own counter) so a
        crash-replay regenerates the same tokens on any replica."""
        if self._stop.is_set():
            raise RuntimeError("supervisor is shut down")
        if self._monitor is None:
            self.start()
        if options.get("seed") is None:
            options["seed"] = next(self._seeds)
        req = GenerationRequest(prompt_ids, **options)
        last_err = None
        for rep in self._by_load():
            srv = rep.server  # monitor may null it out concurrently
            if srv is None:
                continue
            try:
                return srv.submit_request(req)
            except (QueueFullError, RuntimeError) as e:
                last_err = e
        raise last_err if last_err is not None else QueueFullError(
            "no healthy replica accepting work")

    def generate(self, prompt_ids, result_timeout=None, **options):
        req = self.submit(prompt_ids, **options).result(result_timeout)
        if req.status == RequestStatus.DONE:
            return list(req.tokens)
        raise RuntimeError(
            f"request {req.rid} ended {req.status}: {req.error}")

    def replicas(self):
        return len([r for r in self._replicas if not r.retired])

    def healthy_replicas(self):
        return len([r for r in self._replicas if r.healthy])

    def stats(self):
        servers = [r.server for r in self._replicas if r.healthy]
        servers = [s for s in servers if s is not None]
        return {"replicas": self.replicas(),
                "healthy": self.healthy_replicas(),
                "held": len(self._held),
                "queued": sum(s.scheduler.queued() for s in servers),
                "active": sum(s.scheduler.active() for s in servers)}

    # ------------------------------------------------------- supervision --
    def _by_load(self):
        # snapshot (replica, server) pairs: the monitor thread may null
        # out rep.server (retire / death) between this filter and use
        live = [(r, r.server) for r in self._replicas if r.healthy]
        live = [(r, s) for r, s in live if s is not None]
        return [r for r, s in sorted(
            live, key=lambda p: (p[1].scheduler.queued()
                                 + p[1].scheduler.active()))]

    def _monitor_loop(self):
        while not self._stop.is_set():
            now = time.monotonic()
            for rep in self._replicas:
                if rep.retired:
                    continue
                if rep.respawn_at is not None:
                    if now >= rep.respawn_at:
                        self._respawn(rep)
                    continue
                if rep.server.fatal_error is not None:
                    self._handle_death(rep, now)
            self._redistribute()
            if now - self._last_scale >= self.scale_interval:
                self._last_scale = now
                self._autoscale()
            _registry.gauge_set("serving.replicas", self.replicas())
            self._stop.wait(self.monitor_interval)

    def _handle_death(self, rep, now):
        """Take over the dead replica's requests and schedule its respawn
        (backoff DEADLINE, not a sleep — siblings keep being monitored)."""
        orphans = rep.server.scheduler.takeover_requests()
        rep.server.shutdown(drain=False, timeout=2)
        with self._lock:
            self._held.extend(orphans)
        # the dead engine's KV pools and graph pool go before a respawn
        # builds new ones: a restart must not hold two engines' memory
        rep.server = None
        gc.collect()
        if rep.restarts >= self.max_restarts:
            rep.retired = True
            _counters["replicas_retired"] += 1
            _explain.record(
                "serving_replica_retired", op="supervise",
                why=f"replica {rep.rid} exhausted its restart budget "
                    f"({self.max_restarts}); its {len(orphans)} requests "
                    "re-queue on the surviving replicas",
                replica=rep.rid, orphans=len(orphans))
            return
        delay = min(self.restart_backoff * (2 ** rep.restarts), 30.0)
        rep.restarts += 1
        rep.respawn_at = now + delay
        _counters["replica_restarts"] += 1
        _explain.record(
            "serving_replica_restart", op="supervise",
            why=f"replica {rep.rid} died fatally; respawn in {delay:.2f}s "
                f"(restart {rep.restarts}/{self.max_restarts}), "
                f"{len(orphans)} in-flight/queued requests re-queued by "
                "seed (bitwise replay)",
            replica=rep.rid, attempt=rep.restarts, orphans=len(orphans))

    def _respawn(self, rep):
        rep.respawn_at = None
        rep.server = self._new_server()
        # same protocol as launch.Pod trainer restarts: publish the new
        # serving generation so external watchers re-rendezvous
        if self.store is not None:
            from ..distributed.fleet.elastic import publish_generation

            publish_generation(self.store, self.replicas())

    def _redistribute(self):
        """Replay held orphans onto healthy replicas (same request object,
        same seed — idempotent)."""
        with self._lock:
            held, self._held = self._held, []
        if not held:
            return
        leftover = []
        for req in held:
            if req.done:
                continue
            placed = False
            for rep in self._by_load():
                try:
                    rep.server.submit_request(req)
                    placed = True
                    break
                except (QueueFullError, RuntimeError):
                    continue
            if not placed:
                leftover.append(req)
        if leftover:
            if any(not r.retired for r in self._replicas):
                with self._lock:
                    self._held.extend(leftover)  # a respawn is pending
            else:
                for req in leftover:  # nothing will ever run these
                    req.status = RequestStatus.ERROR
                    req.error = "all serving replicas retired"
                    req.finished.set()

    # -------------------------------------------------------- autoscale --
    def _autoscale(self):
        """Decide on the monitor thread, ACT on a short-lived worker:
        building an engine (scale-up) and draining a server (scale-down)
        both block for seconds, and the monitor loop's whole design is
        that death detection / respawn deadlines never stall behind a
        sibling's slow operation. One scale action in flight at a time —
        the guard also stops a deep queue from spawning a replica per
        monitor tick while the first build is still compiling."""
        if self._scaling:
            return
        pairs = [(r, r.server) for r in self._replicas if r.healthy]
        pairs = [(r, s) for r, s in pairs if s is not None]
        if not pairs:
            return
        queued = sum(s.scheduler.queued() for _, s in pairs)
        active = sum(s.scheduler.active() for _, s in pairs)
        occupancy = active / (len(pairs) * max(
            1, pairs[0][1].engine.max_batch_size))
        if queued / len(pairs) >= self.scale_up_queue_depth \
                and self.replicas() < self.max_replicas:
            self._scaling = True
            threading.Thread(target=self._scale_up, args=(queued,
                             len(pairs)), daemon=True,
                             name="paddle-tpu-torch-serve-scale").start()
        elif (queued == 0 and occupancy <= self.scale_down_occupancy
                and len(pairs) > 1
                and self.replicas() > self.min_replicas):
            idle = [(r, s) for r, s in reversed(pairs)
                    if not s.scheduler.has_work()]
            if idle:
                rep, srv = idle[0]
                rep.retired = True  # monitor/submit skip it immediately
                self._scaling = True
                threading.Thread(target=self._scale_down,
                                 args=(rep, srv, occupancy), daemon=True,
                                 name="paddle-tpu-torch-serve-scale").start()

    def _scale_up(self, queued, n_live):
        try:
            rep = _Replica(next(self._rid), self._new_server())
            if self._stop.is_set():  # lost the race with shutdown()
                rep.server.shutdown(drain=False, timeout=5)
                return
            self._replicas.append(rep)
            _counters["scale_ups"] += 1
            _explain.record(
                "serving_scale_up", op="autoscale",
                why=f"queue depth {queued} over {n_live} replicas "
                    f"exceeds {self.scale_up_queue_depth}/replica; "
                    f"scaled to {self.replicas()}",
                queued=queued, replicas=self.replicas())
        finally:
            self._scaling = False

    def _scale_down(self, rep, srv, occupancy):
        try:
            srv.shutdown(drain=True, timeout=10)
            rep.server = None
            _counters["scale_downs"] += 1
            _explain.record(
                "serving_scale_down", op="autoscale",
                why=f"fleet idle (occupancy {occupancy:.2f} <= "
                    f"{self.scale_down_occupancy}); drained replica "
                    f"{rep.rid}, {self.replicas()} remain",
                replicas=self.replicas())
        finally:
            self._scaling = False
