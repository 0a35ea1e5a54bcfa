"""The launcher (counterpart of paddle_tpu/distributed/launch/main.py, the
reference's ``launch/main.py`` and ``controllers/``).

``python -m paddle_tpu_torch.distributed.launch [options] script [args]``
starts ``--nproc_per_node`` trainer processes (a ``Pod``) on this host and
supervises them. Every child gets the reference's environment:
``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, ``PADDLE_MASTER`` (the
rendezvous ``TCPStore``), ``PADDLE_COORDINATOR`` (the ``host:port`` that
``parallel_env.init_parallel_env`` turns into ``MASTER_ADDR`` /
``MASTER_PORT`` for torch's ``env://`` rendezvous),
``PADDLE_CURRENT_ENDPOINT``, ``PADDLE_TRAINER_ENDPOINTS`` and
``PADDLE_LOCAL_RANK``. ``--devices`` sets ``CUDA_VISIBLE_DEVICES`` and
``FLAGS_selected_gpus`` where the reference sets ``FLAGS_selected_tpus``.
The launcher chooses no backend: a trainer asks ``init_parallel_env`` for
NCCL or gloo.

Across nodes (``--nnodes``), node 0's launcher runs the ``TCPStore``
server at ``--master``; every node publishes its address and reserved
ports, and all launchers assemble the same ordered endpoint list before
any trainer starts.

Supervision: a crashed rank restarts in place with exponential backoff
within its ``--max_restarts`` budget, each restart publishing a new
elastic generation (``fleet.elastic.publish_generation``); teardown sends
SIGTERM, then SIGKILL after ``--terminate_grace``. With ``--elastic``
(one node) the pod runs its own store, a rank that exhausts its budget
shrinks the world (the world epoch advances, so a straggler of the old
world is fenced), ``fleet.elastic.request_resize`` grows or shrinks it,
``--lease_ttl`` declares a rank whose heartbeat lease went stale dead, and
an exit with ``HANG_RC`` (98) reads as a step-watchdog hang.

torch's c10d rendezvous cannot be joined again at a new world size on a
port a dead generation used. So each restart episode gets a coordinator
endpoint of its own: the first rank respawned after a failure gets a
fresh port (never one used before in this pod), and the ranks respawned
after it join the same one, so a world whose process group broke
re-forms on one endpoint. The endpoint is published in the store under
``<scope>/coordinator/<gen>``. A survivor whose process group broke
raises at its next collective and is respawned like any crashed rank.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import time


def _parse():
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--master", default=None,
                   help="rendezvous endpoint ip:port on node 0 "
                        "(TCPStore master; HTTPMaster equivalent)")
    p.add_argument("--nnodes", type=int, default=1, help="number of hosts")
    p.add_argument("--rank", type=int, default=0, help="this host's rank")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="trainer processes per host (one per card)")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--devices", default=None,
                   help="visible device ids (CUDA_VISIBLE_DEVICES)")
    p.add_argument("--max_restarts", type=int,
                   default=int(os.environ.get(
                       "PADDLE_LAUNCH_MAX_RESTARTS", "3")),
                   help="per-rank restart budget before the pod gives up "
                        "(reference elastic manager contract; env "
                        "PADDLE_LAUNCH_MAX_RESTARTS overrides the default)")
    p.add_argument("--restart_backoff", type=float, default=1.0,
                   help="base seconds for exponential restart backoff "
                        "(doubles per consecutive restart of one rank)")
    p.add_argument("--terminate_grace", type=float, default=10.0,
                   help="seconds between SIGTERM and SIGKILL on teardown "
                        "(the preemption grace for emergency checkpoints)")
    p.add_argument("--elastic", action="store_true",
                   default=os.environ.get("PADDLE_ELASTIC", "") == "1",
                   help="elastic supervision: a rank that "
                        "exhausts its restart budget shrinks the world "
                        "instead of killing the pod; resize requests "
                        "through the store are honored; single-node runs "
                        "get a local TCPStore so trainers can heartbeat/"
                        "fence")
    p.add_argument("--lease_ttl", type=float, default=None,
                   help="declare a rank dead when its heartbeat lease "
                        "goes this many seconds stale (elastic mode; "
                        "default: process-exit detection only)")
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args()


def _rc_describe(rc):
    """Human-readable exit status: 'rc=1' or 'signal SIGKILL (rc=-9)'."""
    if rc is not None and rc < 0:
        try:
            return f"signal {signal.Signals(-rc).name} (rc={rc})"
        except ValueError:
            return f"signal {-rc} (rc={rc})"
    return f"rc={rc}"


def _local_ip(probe_ip):
    """This host's IP on the route to ``probe_ip`` (the master's; a UDP
    connect sends no packet)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect((probe_ip, 53))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


def _free_port():
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Pod:
    """Group of local trainer procs (reference launch/job/pod.py).

    Fault tolerance: a crashed rank is
    restarted in place with exponential backoff up to `max_restarts`
    times instead of tearing down the whole pod; when a rendezvous
    store exists the restart publishes a new elastic generation so
    surviving ranks re-rendezvous (fleet/elastic.py contract) rather
    than dying with the failed one. Teardown escalates SIGTERM →
    SIGKILL after a grace window and REAPS every child (a trainer that
    ignores SIGTERM used to hang the launcher forever).

    ``coordinator_host``: when set, every restart episode hands its
    respawned ranks a ``PADDLE_COORDINATOR`` of its own on this host (the
    module docstring says why), published under
    ``<scope>/coordinator/<gen>`` when a store exists.
    """

    def __init__(self, max_restarts=3, restart_backoff=1.0,
                 terminate_grace=10.0, store=None, log=None,
                 generation_scope="elastic", elastic=False, lease_ttl=None,
                 lease_grace=30.0, coordinator_host=None):
        self.procs: list[subprocess.Popen] = []
        self.specs: list[tuple] = []  # (cmd, env, log_path) per local rank
        self.restarts: list[int] = []
        self.spawned_at: list[float] = []
        self.max_restarts = int(max_restarts)
        self.restart_backoff = float(restart_backoff)
        self.terminate_grace = float(terminate_grace)
        self.store = store
        # elastic mode: a rank that exhausts its restart
        # budget SHRINKS the world instead of killing the pod; operator
        # resize requests (fleet.elastic.request_resize) are honored at
        # the next supervision tick; per-rank heartbeat leases (when
        # lease_ttl is set) declare a rank dead on expiry even while its
        # OS process lives (hung step the in-process watchdog missed).
        # lease_grace holds lease judgment for a window after each
        # (re)spawn: the store still carries the PREVIOUS incarnation's
        # timestamp, and judging a fresh proc by its predecessor's
        # stale lease would crash-loop every restart.
        self.elastic = bool(elastic)
        self.lease_ttl = None if lease_ttl is None else float(lease_ttl)
        self.lease_grace = float(lease_grace)
        # rendezvous-store key prefix for generation bumps: trainer pods
        # publish under "elastic/", a serving fleet sharing the same
        # store publishes under "serving/" so the two supervision planes
        # can't race each other's generations (serving/fleet.py)
        self.generation_scope = str(generation_scope)
        self._log = log or (lambda msg: print(f"[launch] {msg}",
                                              file=sys.stderr, flush=True))
        self.coordinator_host = coordinator_host
        self._used_ports: set = set()
        self._episode = None  # (coordinator, local ranks respawned on it)

    @staticmethod
    def _popen(cmd, env, log_path):
        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
        with open(log_path, "a") as f:  # the child keeps its own handle
            return subprocess.Popen(cmd, env=env, stdout=f, stderr=f)

    def spawn(self, cmd, env, log_path):
        coord = (env or {}).get("PADDLE_COORDINATOR", "")
        if coord.rpartition(":")[2].isdigit():
            self._used_ports.add(int(coord.rpartition(":")[2]))
        proc = self._popen(cmd, env, log_path)
        self.procs.append(proc)
        self.specs.append((cmd, env, log_path))
        self.restarts.append(0)
        self.spawned_at.append(time.time())
        return proc

    def _fresh_coordinator(self):
        """A ``host:port`` on ``coordinator_host`` whose port no earlier
        generation of this pod held, published under the current
        generation when a store exists."""
        port = _free_port()
        while port in self._used_ports:
            port = _free_port()
        self._used_ports.add(port)
        coord = f"{self.coordinator_host}:{port}"
        if self.store is not None:
            try:
                gen = int(self.store.add(f"{self.generation_scope}/gen", 0))
                self.store.set(
                    f"{self.generation_scope}/coordinator/{gen}", coord)
            except Exception as e:  # best-effort like every store op
                self._log(f"coordinator publish failed: {e}")
        return coord

    def _episode_coordinator(self, i):
        """The coordinator of the restart episode that respawns local
        rank ``i``: a rank already respawned on the current one (it died
        again) opens a new episode on a fresh port; any other joins it."""
        if self._episode is None or i in self._episode[1]:
            self._episode = (self._fresh_coordinator(), set())
        self._episode[1].add(i)
        return self._episode[0]

    def _respawn(self, i):
        cmd, env, log_path = self.specs[i]
        env = dict(env)
        env["PADDLE_RESTART_COUNT"] = str(self.restarts[i])
        if self.coordinator_host is not None and \
                "PADDLE_COORDINATOR" in env:
            env["PADDLE_COORDINATOR"] = self._episode_coordinator(i)
        self.procs[i] = self._popen(cmd, env, log_path)
        self.spawned_at[i] = time.time()

    def _bump_generation(self):
        """Publish a new elastic generation through the rendezvous store
        so surviving ranks re-rendezvous with the restarted trainer.
        Membership is the unchanged GLOBAL world — an in-place restart
        replaces a rank, it does not shrink the job (local proc indices
        would evict every remote rank). The claim/members/pointer
        protocol itself lives in fleet.elastic.publish_generation,
        shared with the serving ReplicaSupervisor."""
        if self.store is None:
            return
        from ..fleet.elastic import publish_generation

        try:
            env = self.specs[0][1] or {}
            world = int(env.get("PADDLE_TRAINERS_NUM", len(self.procs)))
        except (LookupError, TypeError, ValueError) as e:
            # best-effort like the store ops: a malformed env must not
            # kill the pod supervisor mid-restart
            self._log(f"elastic generation bump failed: {e}")
            return
        publish_generation(self.store, world, log=self._log,
                           scope=self.generation_scope)

    def respawn(self, i):
        """Respawn local rank ``i`` in place (new process, same spec,
        restart count in env) after publishing a fresh generation.
        Shared by :meth:`watch` and the serving-fleet supervisor
        (``serving/fleet.py``), which reuses this Pod's spawn/backoff/
        terminate conventions for pods that never exit on their own."""
        self._bump_generation()
        self._respawn(i)

    def _spec_identity(self, i):
        """(global_rank, elastic_gen) of local proc ``i`` from its spec
        env (falls back to the local index / gen 0 on a bare spec)."""
        env = self.specs[i][1] or {}
        try:
            rank = int(env.get("PADDLE_TRAINER_ID", i))
        except (TypeError, ValueError):
            rank = i
        try:
            gen = int(env.get("PADDLE_ELASTIC_GEN", 0))
        except (TypeError, ValueError):
            gen = 0
        return rank, gen

    def _lease_expired(self, i, now):
        """Heartbeat-lease liveness: True when rank ``i``'s
        store lease went stale past ``lease_ttl`` — the rank is declared
        DEAD even though its process still exists. Never-registered
        ranks read as alive (a member may still be importing torch), as do
        transient store errors; only a freshly read stale timestamp
        kills, and only after the post-spawn grace window."""
        if (not self.elastic or self.store is None
                or self.lease_ttl is None):
            return False
        if now - self.spawned_at[i] < self.lease_grace:
            return False
        from ..fleet.elastic import HeartbeatLease

        rank, gen = self._spec_identity(i)
        age = HeartbeatLease.age(self.store, self.generation_scope, gen,
                                 rank)
        return age is not None and age > self.lease_ttl

    def resize(self, new_world, dead=None):
        """N→M world resize. Stops every trainer
        (SIGTERM first: survivors get the preemption grace to land a
        coordinated emergency checkpoint), publishes the next elastic
        generation so any straggling zombie fences itself out at the
        store, then respawns ``new_world`` trainers with remapped
        ``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` /
        ``PADDLE_ELASTIC_GEN``. Survivor specs keep their per-rank env
        (ckpt dirs, device pins); grown ranks clone the first survivor's
        spec minus its per-rank identity keys. The trainers resume via
        ``load_resharded`` — a checkpoint written at the old world
        merges bitwise into the new one. SINGLE-HOST scope: the local
        proc table IS the world here (launch() refuses --elastic for
        nnodes > 1); cross-host elasticity is ElasticManager's job."""
        from ..fleet.elastic import bump_world_epoch, publish_generation

        new_world = int(new_world)
        old_world = len(self.procs)
        self._log(f"elastic resize {old_world} -> {new_world}"
                  + (f" (rank {dead} lost for good)" if dead is not None
                     else " (requested)"))
        self.terminate()
        publish_generation(self.store, new_world, log=self._log,
                           scope=self.generation_scope)
        gen, epoch = 0, 0
        if self.store is not None:
            try:
                # the membership CHANGED: advance the world epoch so any
                # old-epoch straggler fences itself out at its next
                # checkpoint write / barrier join (in-place restarts
                # bump only elastic/gen and leave the epoch alone)
                epoch = bump_world_epoch(self.store,
                                         scope=self.generation_scope)
                gen = int(self.store.add(
                    f"{self.generation_scope}/gen", 0))
            except Exception as e:
                self._log(f"resize: generation read failed ({e}); "
                          f"respawning at gen 0")
        survivors = [j for j in range(old_world) if j != dead]
        old_specs = self.specs
        self.procs, self.specs = [], []
        self.restarts, self.spawned_at = [], []
        # the new world rendezvouses on an endpoint no dead world held
        self._episode = None
        coord = None if self.coordinator_host is None else \
            self._fresh_coordinator()
        for new_rank in range(new_world):
            src = old_specs[survivors[new_rank]] if new_rank < len(
                survivors) else old_specs[survivors[0] if survivors else 0]
            cmd, env, log_path = src
            env = dict(env or {})
            env.update({
                "PADDLE_TRAINER_ID": str(new_rank),
                "PADDLE_TRAINERS_NUM": str(new_world),
                "PADDLE_ELASTIC_GEN": str(gen),
                "PADDLE_WORLD_EPOCH": str(epoch),
            })
            if coord is not None and "PADDLE_COORDINATOR" in env:
                env["PADDLE_COORDINATOR"] = coord
            if new_rank >= len(survivors):
                # grown rank: it clones a survivor's spec, but the
                # per-rank IDENTITY keys must not come along — a
                # duplicated endpoint binds against its donor and a
                # duplicated device pin lands two trainers on one chip.
                # Endpoints are re-derived by the trainers' own
                # rendezvous (PADDLE_MASTER) on the new world.
                for stale in ("PADDLE_CURRENT_ENDPOINT",
                              "FLAGS_selected_gpus"):
                    env.pop(stale, None)
                env["PADDLE_LOCAL_RANK"] = str(new_rank)
                log_path = os.path.join(
                    os.path.dirname(log_path) or ".",
                    f"workerlog.elastic{new_rank}")
            self.spawn(cmd, env, log_path)
        try:
            from ...profiler import explainer as _explain
            from ...profiler import registry as _registry

            _registry.inc("elastic.resizes", scope="fault")
            _explain.record(
                "elastic_resize", op="pod",
                why=f"supervisor resized world {old_world} -> "
                    f"{new_world} at generation {gen}"
                    + (f"; rank {dead} removed (budget exhausted)"
                       if dead is not None else ""),
                old_world=old_world, new_world=new_world, gen=gen,
                dead=dead)
        except Exception:
            pass

    def _pending_resize(self, last_seq):
        if not self.elastic or self.store is None:
            return None
        from ..fleet.elastic import pending_resize

        return pending_resize(self.store, last_seq,
                              scope=self.generation_scope)

    def watch(self):
        """Supervise until every rank exits 0 (return 0), a rank exhausts
        its restart budget (return its rc — or, in elastic mode, shrink
        the world and keep going), or Ctrl-C. Restart backoff is a
        per-rank DEADLINE, not an inline sleep: one crash-looping rank
        at the 30 s cap must not stall death-detection, respawns, or
        Ctrl-C for its siblings. Elastic mode adds three supervisor
        duties per tick: honor store resize requests
        (fleet.elastic.request_resize), declare stale-lease ranks dead
        (SIGKILL; the normal crash path then restarts or shrinks), and
        treat HANG_RC exits (step-watchdog escalation; the thread stacks
        are already in the worker log) as crashes with a distinctive
        log line."""
        from ..fleet.elastic import HANG_RC

        done = [False] * len(self.procs)
        respawn_at = [None] * len(self.procs)  # pending backoff deadline
        resize_seq = 0
        if self.elastic and self.store is not None:
            try:  # only consume requests filed after this watch() began
                resize_seq = int(self.store.add(
                    f"{self.generation_scope}/resize_seq", 0))
            except Exception:
                pass
        try:
            while True:
                now = time.time()
                req = self._pending_resize(resize_seq)
                if req is not None:
                    resize_seq, target = req
                    if target >= 1 and target != len(self.procs):
                        self.resize(target)
                        done = [False] * len(self.procs)
                        respawn_at = [None] * len(self.procs)
                        continue
                for i, p in enumerate(self.procs):
                    if done[i]:
                        continue
                    if respawn_at[i] is not None:
                        if now >= respawn_at[i]:
                            respawn_at[i] = None
                            self.respawn(i)
                        continue
                    rc = p.poll()
                    if rc is None:
                        if self._lease_expired(i, now):
                            self._log(
                                f"rank {i} heartbeat lease expired "
                                f"(> {self.lease_ttl:.1f}s stale) — "
                                f"declaring dead, SIGKILL")
                            try:
                                from ...profiler import (explainer as
                                                         _explain)
                                from ...profiler import (registry as
                                                         _registry)

                                _registry.inc("elastic.lease_expiries",
                                              scope="fault")
                                _explain.record(
                                    "elastic_lease_expired", op="pod",
                                    why=f"rank {i} lease stale past "
                                        f"{self.lease_ttl}s; SIGKILL",
                                    rank=i)
                            except Exception:
                                pass
                            p.kill()
                        continue
                    if rc == 0:
                        done[i] = True
                        self._log(f"rank {i} finished (rc=0)")
                        continue
                    if rc == HANG_RC:
                        self._log(f"rank {i} hung: step watchdog "
                                  f"escalated ({_rc_describe(rc)}; "
                                  f"thread stacks in its worker log) "
                                  f"(restart {self.restarts[i] + 1}/"
                                  f"{self.max_restarts})")
                    else:
                        self._log(f"rank {i} died: {_rc_describe(rc)} "
                                  f"(restart {self.restarts[i] + 1}/"
                                  f"{self.max_restarts})")
                    if self.restarts[i] >= self.max_restarts:
                        live = [j for j in range(len(self.procs))
                                if j != i and not done[j]]
                        if self.elastic and self.store is not None \
                                and len(live) >= 1:
                            self._log(
                                f"rank {i} exhausted its restart budget"
                                f" — shrinking the world to "
                                f"{len(self.procs) - 1} ranks")
                            self.resize(len(self.procs) - 1, dead=i)
                            done = [False] * len(self.procs)
                            respawn_at = [None] * len(self.procs)
                            break
                        self._log(f"rank {i} exhausted its restart budget"
                                  f" — terminating pod")
                        self.terminate()
                        return rc
                    delay = min(self.restart_backoff *
                                (2 ** self.restarts[i]), 30.0)
                    self.restarts[i] += 1
                    respawn_at[i] = now + delay
                if all(done):
                    return 0
                time.sleep(0.2)
        except KeyboardInterrupt:
            self.terminate()
            return 1

    def terminate(self):
        for i, p in enumerate(self.procs):
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        t0 = time.time()
        while time.time() - t0 < self.terminate_grace:
            if all(p.poll() is not None for p in self.procs):
                break
            time.sleep(0.2)
        for i, p in enumerate(self.procs):
            if p.poll() is None:
                self._log(f"rank {i} ignored SIGTERM for "
                          f"{self.terminate_grace:.0f}s — escalating to "
                          f"SIGKILL")
                p.kill()
        for i, p in enumerate(self.procs):
            # reap: wait() collects the zombie and records the final rc
            try:
                rc = p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                rc = None
            self._log(f"rank {i} terminated: {_rc_describe(rc)}")


def _rendezvous(args):
    """Sync the peer list across nodes (reference controllers/master.py:27
    peer_list sync). Returns (endpoints-by-global-rank, coordinator,
    store-or-None). The store server (node 0) must outlive the pod — it
    doubles as the job's rendezvous for elastic/rpc."""
    nproc = args.nproc_per_node
    if args.nnodes <= 1:
        ip = "127.0.0.1"
        eps = [f"{ip}:{_free_port()}" for _ in range(nproc)]
        coord = f"{ip}:{_free_port()}"
        return eps, coord, None

    if not args.master:
        raise SystemExit("--master ip:port is required when --nnodes > 1")
    m_ip, m_port = args.master.rsplit(":", 1)
    from ..store import TCPStore

    store = TCPStore(m_ip, int(m_port), is_master=(args.rank == 0),
                     world_size=args.nnodes)
    my_ip = _local_ip(m_ip)
    ports = [_free_port() for _ in range(nproc)]
    rec = {"ip": my_ip, "ports": ports}
    if args.rank == 0:
        # the process group's coordinator: served by trainer global-rank
        # 0 on node 0 — a verified-free port PUBLISHED through the store,
        # not an assumed master_port+1 which may be taken (the remaining
        # bind-time race window matches the reference launcher's own
        # port reservation semantics)
        rec["coord_port"] = _free_port()
    store.set(f"launch/node/{args.rank}", json.dumps(rec).encode())
    endpoints = []
    coord = None
    for r in range(args.nnodes):
        store.wait([f"launch/node/{r}"])
        info = json.loads(store.get(f"launch/node/{r}"))
        if r == 0:
            coord = f"{info['ip']}:{info['coord_port']}"
        endpoints.extend(f"{info['ip']}:{p}" for p in info["ports"])
    return endpoints, coord, store


def launch():
    args = _parse()
    if args.elastic and args.nnodes > 1:
        # Pod-level elastic resize reasons about the LOCAL proc table as
        # the world (rank remapping, shrink targets, generation
        # publishing) — with multiple nodes every launcher would resize
        # independently and mint duplicate global ranks. Multi-host
        # elasticity is the host-level ElasticManager's job
        # (fleet/elastic.py run()); per-rank restarts still work here.
        print("[launch] --elastic is single-node (Pod-scoped); "
              "multi-node jobs get elasticity from fleet.elastic."
              "ElasticManager — falling back to restart-only "
              "supervision", file=sys.stderr, flush=True)
        args.elastic = False
    endpoints, coordinator, store = _rendezvous(args)
    master = args.master or "127.0.0.1:8070"
    if args.elastic and store is None:
        # single-node elastic: the pod runs the rendezvous store itself
        # so trainers can heartbeat/fence and operators can file resize
        # requests (multi-node already has the --master store)
        from ..store import TCPStore

        store = TCPStore("127.0.0.1", 0, is_master=True,
                         world_size=args.nproc_per_node)
        master = f"127.0.0.1:{store.port}"
    # one node owns its coordinator, so its restarts get fresh ones;
    # across nodes node 0's published coordinator stays
    pod = Pod(max_restarts=args.max_restarts,
              restart_backoff=args.restart_backoff,
              terminate_grace=args.terminate_grace, store=store,
              elastic=args.elastic, lease_ttl=args.lease_ttl,
              coordinator_host="127.0.0.1" if args.nnodes <= 1 else None)
    world = args.nnodes * args.nproc_per_node

    for local_rank in range(args.nproc_per_node):
        rank = args.rank * args.nproc_per_node + local_rank
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_MASTER": master,
            "PADDLE_COORDINATOR": coordinator,
            "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
            "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
            "PADDLE_LOCAL_RANK": str(local_rank),
            "FLAGS_selected_gpus": args.devices or "",
        })
        if args.devices:
            env["CUDA_VISIBLE_DEVICES"] = args.devices
        cmd = [sys.executable, "-u", args.training_script,
               *args.training_script_args]
        pod.spawn(cmd, env, os.path.join(args.log_dir,
                                         f"workerlog.{local_rank}"))

    rc = pod.watch()
    from ...profiler import registry as _registry

    # the supervisor's own recoveries (resizes, generation bumps, lease
    # expiries) count in this process: they go to the log with the rc
    pod._log(f"exit rc={rc}; fault counters " + json.dumps(
        {k: v for k, v in _registry.counters("fault").items() if v}))
    del store  # keep the rendezvous server alive until the pod exits
    sys.exit(rc)


if __name__ == "__main__":
    launch()
