"""The port's elastic primitives (``paddle_tpu_torch.distributed.fleet.
elastic``) against the JAX package's: heartbeat leases, the step watchdog,
coordinated preemption, the generation fence, the store's retry under a
partition, and ``ElasticManager``'s claim takeover, each as the
reference's own tests hold its module. Then both packages on one
``TCPStore``: what one publishes (generations, endpoints, the world epoch,
resize requests, leases) the other reads, key for key and byte for byte.

Small and host-only: no model, no device.
"""
import io
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

pytest.importorskip("jax")

from paddle_tpu.distributed.fleet import elastic as JE  # noqa: E402
from paddle_tpu.distributed.store import TCPStore as JStore  # noqa: E402
from paddle_tpu_torch.distributed.fleet import elastic as E  # noqa: E402
from paddle_tpu_torch.distributed.store import TCPStore  # noqa: E402
from paddle_tpu_torch.profiler import explainer, registry  # noqa: E402
from paddle_tpu_torch.testing import faults  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    faults.reset()


@pytest.fixture()
def store():
    s = TCPStore("127.0.0.1", 0, is_master=True, world_size=1, timeout=10.0)
    yield s
    s.close()


@pytest.fixture()
def ref_client(store):
    """The reference's client on the port's store server."""
    c = JStore("127.0.0.1", store.port, is_master=False, world_size=1,
               timeout=10.0)
    yield c
    del c  # the reference's client closes when collected


def test_all_names_match_the_reference():
    assert sorted(E.__all__) == sorted(JE.__all__)
    assert E.HANG_RC == JE.HANG_RC == 98
    assert set(registry.counters("fault")) >= {
        "elastic.restarts", "elastic.resizes", "elastic.generation_bumps",
        "elastic.heartbeat_misses", "elastic.hang",
        "elastic.fenced_zombies", "elastic.lease_expiries",
        "elastic.coordinated_preempts"}


# ------------------------------------------------------------ heartbeats --

def test_heartbeat_lease_renews_then_expires(store):
    lease = E.HeartbeatLease(store, rank=2, interval=0.05, ttl=0.3).start()
    try:
        time.sleep(0.2)
        age = E.HeartbeatLease.age(store, "elastic", 0, 2)
        assert age is not None and age < 0.3
    finally:
        lease.stop()
    time.sleep(0.45)
    assert E.HeartbeatLease.age(store, "elastic", 0, 2) > 0.3
    # a rank that never registered is not stale: no key, no verdict
    assert E.HeartbeatLease.age(store, "elastic", 0, 7) is None


def test_heartbeat_misses_counted_not_raised():
    class DeadStore:
        def set(self, *a):
            raise ConnectionError("injected dead store")

    before = registry.counters("fault")["elastic.heartbeat_misses"]
    lease = E.HeartbeatLease(DeadStore(), rank=0, interval=0.03).start()
    time.sleep(0.15)
    lease.stop()  # the beat thread survived every failure
    assert registry.counters("fault")["elastic.heartbeat_misses"] > before
    assert "elastic_heartbeat_miss" in [e["kind"]
                                        for e in explainer.events(50)]


# -------------------------------------------------------------- watchdog --

def test_watchdog_trips_dumps_stacks_counts_and_explains():
    sink = io.StringIO()
    trips = []
    before = registry.counters("fault")["elastic.hang"]
    wd = E.StepWatchdog(deadline=0.15, escalate="report", sink=sink,
                        on_trip=trips.append, poll=0.03).start()
    try:
        wd.arm(7)
        time.sleep(0.5)
    finally:
        wd.stop()
    assert wd.tripped
    assert registry.counters("fault")["elastic.hang"] == before + 1
    out = sink.getvalue()
    assert "WATCHDOG" in out and "--- thread MainThread" in out
    assert trips[0]["kind"] == "elastic_hang" and trips[0]["step"] == 7
    assert "elastic_hang" in [e["kind"] for e in explainer.events(50)]


def test_watchdog_healthy_cadence_never_trips():
    wd = E.StepWatchdog(deadline=0.3, escalate="report", poll=0.03,
                        sink=io.StringIO()).start()
    try:
        wd.arm(0)
        for step in range(6):
            time.sleep(0.05)  # well inside the deadline
            wd.tick(step)
        wd.disarm()
        time.sleep(0.4)  # disarmed: no deadline while not training
    finally:
        wd.stop()
    assert not wd.tripped


def test_watchdog_exit_escalation_is_hang_rc():
    from proc_utils import proc_timeout

    code = (f"import sys, time\nsys.path.insert(0, {REPO!r})\n"
            "sys.modules['jax'] = None\n"
            "from paddle_tpu_torch.distributed.fleet.elastic import "
            "StepWatchdog\n"
            "wd = StepWatchdog(deadline=0.3, escalate='exit', poll=0.05)\n"
            "wd.start(); wd.arm(4)\n"
            "time.sleep(60)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=proc_timeout(120))
    assert r.returncode == E.HANG_RC, (r.returncode, r.stderr[-400:])
    assert "WATCHDOG" in r.stderr and "--- thread" in r.stderr


# -------------------------------------------- coordinated preemption -----

def test_preemption_coordinator_fleet_saves_same_step(store):
    c0 = E.PreemptionCoordinator(store, 0, 2, gen=3, poll=0.03).start()
    c1 = E.PreemptionCoordinator(store, 1, 2, gen=3, poll=0.03).start()
    try:
        assert not c0.triggered and not c1.triggered
        c0.announce(4)  # SIGTERM landed on rank 0 at step 4
        deadline = time.time() + 5
        while not c1.triggered and time.time() < deadline:
            time.sleep(0.02)
        assert c1.triggered, "peer never saw the store notice"
        assert not c0.should_save(4) and c0.should_save(5)
        assert not c1.should_save(4) and c1.should_save(5)
        res = []
        t = threading.Thread(
            target=lambda: res.append(c1.barrier(5, timeout=5)))
        t.start()
        n0 = c0.barrier(5, timeout=5)
        t.join(10)
        assert n0 == 2 and res == [2]
    finally:
        c0.stop()
        c1.stop()


# ------------------------------------------------------ generation fence --

def test_fence_restart_bump_does_not_fence_resize_does(store):
    fence = E.GenerationFence(store, rank=1)
    assert fence.check("warmup")
    # an in-place restart bumps elastic/gen, but the membership did not
    # change: survivors must not read as zombies
    assert E.publish_generation(store, 4)
    assert fence.check("after in-place restart")
    E.bump_world_epoch(store)  # a resize: now the old rank is a zombie
    before = registry.counters("fault")["elastic.fenced_zombies"]
    assert not fence.check("checkpoint write")
    assert registry.counters("fault")["elastic.fenced_zombies"] == before + 1
    assert not fence.check("again")  # one count per zombie
    assert registry.counters("fault")["elastic.fenced_zombies"] == before + 1
    with pytest.raises(E.StaleGenerationError):
        fence.barrier("step9", 2)
    assert E.GenerationFence(store, rank=0).check()


def test_fence_releases_waiters_mid_barrier(store):
    fence = E.GenerationFence(store, rank=0)
    err = []

    def wait():
        try:
            fence.barrier("stepX", 3, timeout=30)
        except E.StaleGenerationError as e:
            err.append(e)

    t = threading.Thread(target=wait)
    t.start()
    time.sleep(0.15)
    E.bump_world_epoch(store)
    t.join(10)
    assert err, "the waiter survived the resize (or is still blocked)"


def test_store_partition_rides_retry_backoff(store):
    before = registry.counters("fault")["store.retries"]
    faults.configure("store_partition:secs=0.15")
    # the cumulative retry backoff (0.05 + 0.1 + 0.2) outlives the
    # 0.15 s partition: the op heals, no error escapes
    store.set("part/key", "survived")
    faults.reset()
    assert store.get("part/key") == b"survived"
    assert registry.counters("fault")["store.retries"] > before
    assert registry.counters("fault")["injected.store_partition"] >= 1


# ------------------------------------------------- ElasticManager claims --

def _watch_until_restart(store, m):
    deadline = time.time() + 15
    status = None
    while time.time() < deadline:
        # ranks 1 and 2 are alive (heartbeats written by hand)
        store.set("elastic/host/0/1", str(time.time()))
        store.set("elastic/host/0/2", str(time.time()))
        status = m.watch()
        if status == E.ElasticStatus.RESTART:
            break
        time.sleep(0.1)
    return status


def test_stale_claim_taken_over(store):
    """A leader that won the generation claim and died before publishing
    must not wedge the survivors: after claim_ttl another takes over."""
    m = E.ElasticManager(store=store, rank=1, world_size=3,
                         heartbeat_interval=0.1, lease_ttl=0.6,
                         claim_ttl=0.4)
    assert int(store.add("elastic/claim/1", 1)) == 1
    assert _watch_until_restart(store, m) == E.ElasticStatus.RESTART
    assert m.gen == 1 and m.members == [1, 2]
    assert E.world_epoch(store) == 1  # a scale-in moves the epoch


def test_claim_fulfilled_but_gen_not_bumped(store):
    m = E.ElasticManager(store=store, rank=1, world_size=3,
                         heartbeat_interval=0.1, lease_ttl=0.6,
                         claim_ttl=0.4)
    assert int(store.add("elastic/claim/1", 1)) == 1
    store.set("elastic/members/1", "1,2")  # written, gen never bumped
    assert _watch_until_restart(store, m) == E.ElasticStatus.RESTART
    assert m.gen == 1 and m.members == [1, 2]


def test_context_parts_follow_their_dependencies(store, monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("PADDLE_ELASTIC_GEN", "2")
    monkeypatch.setenv("PADDLE_WORLD_EPOCH", "5")
    bare = E.ElasticTrainContext()
    assert (bare.rank, bare.world, bare.gen) == (3, 4, 2)
    assert bare.lease is bare.coordinator is bare.fence is None
    assert bare.watchdog is None and bare.fence_check() and \
        bare.barrier("x") == 0
    full = E.ElasticTrainContext(store=store, step_deadline=30,
                                 watchdog_escalate="report")
    assert full.fence.gen == 5 and full.lease.key == "elastic/lease/2/3"
    assert full.coordinator._key == "elastic/preempt/2"
    assert full.watchdog is not None


# ------------------------------------------- one store, both packages ----

@pytest.mark.parametrize("writer", ["port", "reference"])
def test_generations_and_epochs_cross_packages(store, ref_client, writer):
    w, r = (E, JE) if writer == "port" else (JE, E)
    ws, rs = (store, ref_client) if writer == "port" else (ref_client, store)
    assert w.publish_generation(ws, 3)
    assert w.publish_generation(ws, 3)
    assert int(rs.add("elastic/gen", 0)) == 2
    assert rs.get("elastic/members/2") == b"0,1,2"
    assert w.bump_world_epoch(ws) == 1
    assert r.world_epoch(rs) == 1
    # the reader's fence was built before the writer's next resize
    fence = r.GenerationFence(rs, rank=0)
    w.bump_world_epoch(ws)
    assert not fence.check("cross-package resize")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_endpoints_cross_packages(store, ref_client, writer):
    w, r = (E, JE) if writer == "port" else (JE, E)
    ws, rs = (store, ref_client) if writer == "port" else (ref_client, store)
    assert w.endpoint_key(4) == r.endpoint_key(4) == "serving/endpoint/4"
    assert w.publish_endpoint(ws, 4, "10.0.0.7", 9100, generation=2,
                              data_port=9101)
    doc = r.resolve_endpoint(rs, 4, min_gen=2)
    assert (doc["host"], doc["port"], doc["data_port"], doc["generation"],
            doc["role"]) == ("10.0.0.7", 9100, 9101, 2, "serve")
    # a stale incarnation is rejected by either reader
    assert r.resolve_endpoint(rs, 4, min_gen=3) is None
    assert not r.publish_endpoint(rs, 4, "10.0.0.8", 1, generation=1)
    assert w.unpublish_endpoint(ws, 4)
    assert r.resolve_endpoint(rs, 4) is None


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_resize_requests_and_leases_cross_packages(store, ref_client,
                                                   writer):
    w, r = (E, JE) if writer == "port" else (JE, E)
    ws, rs = (store, ref_client) if writer == "port" else (ref_client, store)
    seq = w.request_resize(ws, 3)
    assert r.pending_resize(rs, 0) == (seq, 3)
    assert r.pending_resize(rs, seq) is None
    lease = w.HeartbeatLease(ws, rank=1, gen=2, interval=0.05).start()
    try:
        time.sleep(0.1)
        age = r.HeartbeatLease.age(rs, "elastic", 2, 1)
        assert age is not None and age < 1.0
    finally:
        lease.stop()
    assert r.HeartbeatLease.key_for("elastic", 2, 1) == lease.key


def test_preemption_notice_crosses_packages(store, ref_client):
    port = E.PreemptionCoordinator(store, 0, 2, gen=1, poll=0.02).start()
    ref = JE.PreemptionCoordinator(ref_client, 1, 2, gen=1, poll=0.02)
    try:
        ref.announce(6)
        assert port.poke() and port.should_save(7) and \
            not port.should_save(6)
        res = []
        t = threading.Thread(target=lambda: res.append(ref.barrier(7, 5)))
        t.start()
        assert port.barrier(port.save_step(6), timeout=5) == 2
        t.join(10)
        assert res == [2]
    finally:
        port.stop()


def test_manager_registry_keys_cross_packages(store, ref_client):
    """A reference ElasticManager and the port's, on one store, see each
    other's leases as one world's."""
    mine = E.ElasticManager(store=store, rank=0, world_size=2,
                            heartbeat_interval=0.05, lease_ttl=1.0)
    theirs = JE.ElasticManager(store=ref_client, rank=1, world_size=2,
                               heartbeat_interval=0.05, lease_ttl=1.0)
    mine.register()
    theirs.register()
    assert sorted(mine.alive_ranks()) == sorted(theirs.alive_ranks()) \
        == [0, 1]
    assert int(store.add("num_registered", 0)) == 2
