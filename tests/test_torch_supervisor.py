"""The port's ``serving.ReplicaSupervisor`` against the JAX package's, on
``gpt2-tiny`` (vocab 96, initializer_range 0.35, float32, the JAX model's
weights carried into the port by ``convert``):

- ``replica_kill`` mid-flight: the replica restarts, its requests replay
  by seed, and every request's tokens equal the undisturbed run's; the
  greedy requests' tokens equal the reference supervisor's under the same
  fault spec (sampled ones are compared within the port only: the two
  frameworks draw different Gumbel noise);
- the autoscaler adds a replica on queue depth and drains it when idle;
- a replica whose restart budget is spent retires, its requests finishing
  on the survivor;
- ``stats()`` has the reference's keys, and the counters its names.
"""
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu.serving import GenerationEngine as JEngine  # noqa: E402
from paddle_tpu.serving import ReplicaSupervisor as JSupervisor  # noqa: E402
from paddle_tpu.testing import faults as jfaults  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.profiler import explainer, registry  # noqa: E402
from paddle_tpu_torch.serving import (GenerationEngine,  # noqa: E402
                                      ReplicaSupervisor, RequestStatus)
from paddle_tpu_torch.testing import faults  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

VOCAB = 96
EKW = dict(max_batch_size=2, buckets=(8,), rng_seed=7)
OPTS = (dict(max_new_tokens=6), dict(max_new_tokens=6, temperature=0.8))


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.reset()
    jfaults.reset()


@pytest.fixture(scope="module")
def models():
    rng_state = paddle.get_rng_state()
    try:
        paddle.seed(31)
        cfg = jgpt.GPTConfig.preset("gpt2-tiny", vocab_size=VOCAB,
                                    initializer_range=0.35)
        jm = jgpt.GPTForPretraining(jgpt.GPTModel(cfg))
    finally:
        paddle.set_rng_state(rng_state)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tgpt.GPTForPretraining(tgpt.GPTModel(tgpt.GPTConfig.preset(
        "gpt2-tiny", vocab_size=VOCAB, initializer_range=0.35),
        device="cpu"))
    convert.load_paddle_tpu_state(tm, state)
    return jm, tm


def _prompts(n=4):
    rng = np.random.default_rng(11)
    return [[int(t) for t in rng.integers(1, VOCAB, 5)] for _ in range(n)]


def _serve(sup, prompts):
    reqs = [sup.submit(p, **OPTS[i % 2]) for i, p in enumerate(prompts)]
    got = [list(r.result(120).tokens) for r in reqs]
    assert all(r.status == RequestStatus.DONE for r in reqs)
    return got


def test_replica_kill_restarts_and_replays_bitwise(models):
    jm, tm = models
    prompts = _prompts()

    def port(fault=None):
        sup = ReplicaSupervisor(
            lambda: GenerationEngine(tm, device="cpu", **EKW), replicas=1,
            restart_backoff=0.05, monitor_interval=0.02)
        if fault:
            faults.configure(fault)
        try:
            return _serve(sup, prompts)
        finally:
            faults.reset()
            sup.shutdown()

    def reference(fault=None):
        sup = JSupervisor(lambda: JEngine(jm, **EKW), replicas=1,
                          restart_backoff=0.05, monitor_interval=0.02)
        if fault:
            jfaults.configure(fault)
        try:
            return _serve(sup, prompts)
        finally:
            jfaults.reset()
            sup.shutdown()

    want = port()
    c0 = dict(registry.counters("serving"))
    got = port("replica_kill:nth=4")
    c1 = dict(registry.counters("serving"))
    # died mid-flight, restarted, replayed: same seeds and rng_seed
    assert got == want
    assert c1["replica_restarts"] == c0["replica_restarts"] + 1
    assert c1["requeued_requests"] > c0["requeued_requests"]
    kinds = [e["kind"] for e in explainer.events(200)]
    assert "serving_replica_restart" in kinds
    ref = reference("replica_kill:nth=4")
    greedy = [i for i in range(len(prompts)) if not i % 2]
    assert [got[i] for i in greedy] == [ref[i] for i in greedy]


def test_autoscale_up_on_queue_depth_then_down_when_idle(models):
    _, tm = models
    sup = ReplicaSupervisor(
        lambda: GenerationEngine(tm, device="cpu", max_batch_size=1,
                                 buckets=(8,), rng_seed=7),
        replicas=1, max_replicas=3, min_replicas=1, scale_up_queue_depth=2,
        scale_interval=0.05, monitor_interval=0.02, max_queue_size=64)
    c0 = dict(registry.counters("serving"))
    faults.configure("slow_decode:delay=0.03")  # the queue piles up
    try:
        reqs = [sup.submit([1, 2], max_new_tokens=3) for _ in range(10)]
        deadline = time.monotonic() + 10
        while sup.replicas() < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert sup.replicas() >= 2, "queue depth never scaled the fleet up"
        for r in reqs:
            assert r.result(60).status == RequestStatus.DONE
    finally:
        faults.reset()
    deadline = time.monotonic() + 10
    while sup.replicas() > 1 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert sup.replicas() == 1, "the idle fleet never scaled down"
    assert registry.gauge("serving.replicas") == 1
    c1 = dict(registry.counters("serving"))
    assert c1["scale_ups"] >= c0["scale_ups"] + 1
    assert c1["scale_downs"] >= c0["scale_downs"] + 1
    sup.shutdown()


def test_exhausted_budget_retires_the_replica(models):
    _, tm = models
    sup = ReplicaSupervisor(
        lambda: GenerationEngine(tm, device="cpu", **EKW), replicas=2,
        max_restarts=0, restart_backoff=0.05, monitor_interval=0.02)
    c0 = dict(registry.counters("serving"))
    faults.configure("replica_kill:nth=3")
    try:
        got = _serve(sup, _prompts(6))
    finally:
        faults.reset()
    c1 = dict(registry.counters("serving"))
    assert len(got) == 6 and all(len(t) == 6 for t in got)
    assert c1["replicas_retired"] == c0["replicas_retired"] + 1
    assert c1["replica_restarts"] == c0["replica_restarts"]
    assert sup.replicas() == 1 and sup.healthy_replicas() == 1
    sup.shutdown()


def test_stats_and_counter_names_match_the_reference(models):
    jm, tm = models
    mine = ReplicaSupervisor(
        lambda: GenerationEngine(tm, device="cpu", **EKW), replicas=1)
    theirs = JSupervisor(lambda: JEngine(jm, **EKW), replicas=1)
    try:
        assert sorted(mine.stats()) == sorted(theirs.stats())
        assert mine.stats() == {"replicas": 1, "healthy": 1, "held": 0,
                                "queued": 0, "active": 0}
    finally:
        mine.shutdown()
        theirs.shutdown()
    from paddle_tpu.profiler import registry as jregistry

    want = {"replica_restarts", "replicas_retired", "scale_ups",
            "scale_downs", "requeued_requests"}
    assert want <= set(registry.counters("serving"))
    assert want <= set(jregistry.counters("serving"))
    assert registry.gauge("serving.replicas") == 1
