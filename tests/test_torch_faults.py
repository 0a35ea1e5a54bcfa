"""The port's fault-injection harness against the JAX package's
(``paddle_tpu/testing/faults.py``): the spec grammar on every example of
the reference's docstring, arming and disarming, and the effect of each
serving fault point on the same scheduler run in both packages — tokens,
statuses and counters — then the points of spec decode, the paged kernel's
route and the checkpoint writer.

Model: ``gpt2-tiny``, vocab 96, initializer_range 0.35, float32, the
reference's weights carried by ``convert``; greedy requests, so tokens
compare bitwise across the packages.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.incubate import checkpoint as jckpt  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu.profiler import registry as jregistry  # noqa: E402
from paddle_tpu.serving import ContinuousBatchScheduler as JaxSched  # noqa
from paddle_tpu.serving import GenerationEngine as JaxEngine  # noqa: E402
from paddle_tpu.serving import GenerationRequest as JaxRequest  # noqa: E402
from paddle_tpu.serving.engine import \
    FatalEngineError as JaxFatal  # noqa: E402
from paddle_tpu.testing import faults as jfaults  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch.incubate import checkpoint as ckpt  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.ops import paged_attention as pa  # noqa: E402
from paddle_tpu_torch.profiler import registry  # noqa: E402
from paddle_tpu_torch.serving import (ContinuousBatchScheduler,  # noqa: E402
                                      DraftVerifyEngine, FatalEngineError,
                                      GenerationEngine, GenerationRequest)
from paddle_tpu_torch.testing import faults  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 96
EKW = dict(max_batch_size=2, buckets=(16, 32), block_size=8, rng_seed=7)

# every example of the reference's grammar (faults.py:13-97)
EXAMPLES = [
    "kill_at_step:step=7", "kill_at_step:step=7,rank=1", "nan_loss:step=5",
    "truncate_checkpoint:nth=2", "truncate_checkpoint:nth=2,bytes=17",
    "store_flaky:fails=3", "store_flaky:fails=3,op=set",
    "store_slow:delay=0.2", "kill_during_swap",
    "slow_decode:delay=0.05,steps=3", "decode_error:fails=1",
    "replica_kill:nth=5", "pod_kill:at_request=3",
    "pod_slow:delay=0.05,steps=3", "router_drop:nth=2",
    "page_pool_exhausted:times=3", "mutate_signature:nth=3",
    "mutate_signature:nth=3,mode=aval", "draft_garbage",
    "draft_garbage:rounds=3", "kernel_mismatch", "kernel_mismatch:nth=2",
    "rank_preempt:step=4", "rank_preempt:step=4,rank=1",
    "store_partition:secs=0.3", "step_hang:step=5,secs=30",
    "net_drop:nth=2",
    # several points, spaces and empty parts
    " slow_decode:delay=0.01 ; decode_error:fails=2;;",
    "", "store_flaky:op=get,fails=x"]


@pytest.mark.parametrize("text", EXAMPLES)
def test_parse_spec_equals_the_reference(text):
    assert faults.parse_spec(text) == jfaults.parse_spec(text)


def test_configure_arms_and_reset_disarms():
    c0 = registry.counters("fault")
    try:
        table = faults.configure("decode_error:fails=2;page_pool_exhausted")
        assert faults.ACTIVE
        assert table == faults.spec() == {"decode_error": {"fails": 2},
                                          "page_pool_exhausted": {}}
        assert not faults.fire("kill_at_step", step=3)  # not armed
        with pytest.raises(ValueError, match="netfaults"):
            faults.configure("net_drop:nth=2")
    finally:
        faults.reset()
    assert not faults.ACTIVE and faults.spec() == {}
    c1 = registry.counters("fault")
    assert c1["armed.decode_error"] == c0.get("armed.decode_error", 0) + 1
    faults.configure("")
    assert not faults.ACTIVE


def test_armed_from_the_environment():
    code = ("from paddle_tpu_torch.testing import faults\n"
            "print(faults.ACTIVE, sorted(faults.spec().items()))\n")
    env = dict(os.environ, PYTHONPATH=REPO,
               FLAGS_fault_inject="replica_kill:nth=4;kill_during_swap")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == (
        "True [('kill_during_swap', {}), ('replica_kill', {'nth': 4})]")


@pytest.fixture(scope="module")
def models():
    rng_state = paddle.get_rng_state()
    try:
        jms = []
        for seed in (21, 22):
            paddle.seed(seed)
            jms.append(jgpt.GPTForPretraining(jgpt.GPTModel(
                jgpt.GPTConfig.preset("gpt2-tiny", vocab_size=VOCAB,
                                      initializer_range=0.35))))
    finally:
        paddle.set_rng_state(rng_state)
    tm = tgpt.GPTForPretraining(tgpt.GPTModel(tgpt.GPTConfig.preset(
        "gpt2-tiny", vocab_size=VOCAB, initializer_range=0.35),
        device="cpu"))
    convert.load_paddle_tpu_state(
        tm, {k: np.asarray(v.numpy()) for k, v in jms[0].state_dict().items()})
    other = {k: np.asarray(v.numpy()).copy()
             for k, v in jms[1].gpt.state_dict().items()}
    return jms[0], tm, other


@pytest.fixture(scope="module")
def clean_tokens(models):
    """The tokens of an unfaulted run, on an engine of their own."""
    eng = GenerationEngine(models[1], device="cpu", **EKW)
    return _serve(ContinuousBatchScheduler, GenerationRequest,
                  FatalEngineError, faults, registry, eng, "")[0]


@pytest.fixture(scope="module")
def engines(models):
    """One engine per package for every serving case: each case drives the
    two through the same history, so their prefix caches agree."""
    jm, tm, _ = models
    return JaxEngine(jm, **EKW), GenerationEngine(tm, device="cpu", **EKW)


PROMPTS = [[int(t) for t in np.random.default_rng(i).integers(1, VOCAB, n)]
           for i, n in enumerate((5, 11, 17, 8))]
WATCHED = ("requests_completed", "requests_failed", "pool_exhausted",
           "step_retries", "reprimes", "weight_swaps", "swap_failures")


def _serve(sched_cls, req_cls, fatal_cls, fmod, reg, engine, spec,
           swap=None):
    """Serve PROMPTS (greedy, 6 tokens, seeds 0..3) with ``spec`` armed in
    ``fmod``, the way the server's worker loop does: a step error after
    the retry fails the in-flight batch, a fatal one ends the loop and
    cancels the rest. ``swap`` is staged before the second step. Returns
    tokens, statuses, the moved counters and the step that died."""
    sched = sched_cls(engine, max_queue_size=8)
    c0, f0 = reg.counters("serving"), reg.counters("fault")
    reqs = [sched.submit(req_cls(p, max_new_tokens=6, seed=i))
            for i, p in enumerate(PROMPTS)]
    fmod.configure(spec)
    died, steps = None, 0
    try:
        while sched.has_work():
            if steps == 1 and swap is not None:
                sched.request_swap(swap, source="test")
            steps += 1
            try:
                sched.step()
            except fatal_cls:
                died = steps
                sched.cancel_pending("fatal")
                break
            except RuntimeError as e:
                sched.fail_all(e)
    finally:
        fmod.reset()
    c1, f1 = reg.counters("serving"), reg.counters("fault")
    moved = {k: c1[k] - c0[k] for k in WATCHED}
    moved.update({k: v - f0.get(k, 0) for k, v in f1.items()
                  if k.startswith("injected.") and v != f0.get(k, 0)})
    engine.pool.audit()
    return [r.tokens for r in reqs], [r.status for r in reqs], moved, died


SERVING_CASES = {
    "none": "",
    "page_pool_exhausted": "page_pool_exhausted:times=3",
    "decode_error": "decode_error:fails=1",
    "decode_error_twice": "decode_error:fails=2",
    "replica_kill": "replica_kill:nth=3",
    "slow_decode": "slow_decode:delay=0.001,steps=2",
    "pod_slow": "pod_slow:delay=0.001",
    "kill_during_swap": "kill_during_swap"}


@pytest.mark.parametrize("case", list(SERVING_CASES))
def test_serving_fault_effect_equals_the_reference(models, engines,
                                                   clean_tokens, case):
    jeng, teng = engines
    swap = models[2] if case == "kill_during_swap" else None
    spec = SERVING_CASES[case]
    want = _serve(JaxSched, JaxRequest, JaxFatal, jfaults, jregistry, jeng,
                  spec, swap)
    got = _serve(ContinuousBatchScheduler, GenerationRequest,
                 FatalEngineError, faults, registry, teng, spec, swap)
    assert got == want
    tokens, statuses, moved, died = got
    if case in ("none", "page_pool_exhausted", "decode_error",
                "slow_decode", "pod_slow", "kill_during_swap"):
        # recovered: every request finishes with all its tokens, the same
        # as an unfaulted run's
        assert statuses == ["done"] * 4 and died is None
        assert tokens == clean_tokens
    expect = {"page_pool_exhausted": {"injected.page_pool_exhausted": 3},
              "decode_error": {"step_retries": 1, "reprimes": 1},
              "kill_during_swap": {"swap_failures": 1, "weight_swaps": 0},
              "slow_decode": {"injected.slow_decode": 2}}.get(case, {})
    assert {k: moved.get(k, 0) for k in expect} == expect
    if case == "pod_slow":  # every decode step
        assert moved["injected.pod_slow"] >= 5
    if case == "decode_error_twice":
        assert moved["requests_failed"] >= 2 and moved["step_retries"] == 1
    if case == "replica_kill":
        assert died is not None and statuses.count("error") == 4 - \
            statuses.count("done")


def test_draft_garbage_keeps_the_tokens(models):
    jm, tm, _ = models
    prompt = PROMPTS[2]
    jeng = JaxEngine(jm, **EKW)
    want = [jeng.prefill(0, prompt, seed=0)]
    while len(want) < 12:
        want.append(int(jeng.decode_step()[0]))
    spec = DraftVerifyEngine(tm, tm, draft_k=3, device="cpu", **EKW)
    c0, f0 = registry.counters("serving"), registry.counters("fault")
    faults.configure("draft_garbage:rounds=4")
    try:
        got = [spec.prefill(0, prompt, seed=0)]
        rounds = 0
        while len(got) < 12:
            got.extend(spec.decode_step_spec()[0])
            rounds += 1
    finally:
        faults.reset()
    c1, f1 = registry.counters("serving"), registry.counters("fault")
    assert got[:12] == want
    # the twin drafter has every proposal accepted; the garbage rounds
    # have theirs rejected
    assert rounds > 4
    assert c1["spec_accepted"] - c0["spec_accepted"] < \
        c1["spec_proposed"] - c0["spec_proposed"]
    assert f1["injected.draft_garbage"] - \
        f0.get("injected.draft_garbage", 0) == 4
    spec.release(0)
    spec.pool.audit()
    spec.draft_pool.audit()


def test_kernel_mismatch_trips_the_parity_check():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 1, 4, 64, generator=g)
    kp, vp = (torch.randn(9, 8, 4, 64, generator=g) for _ in range(2))
    args = (q, kp, vp, torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32),
            torch.tensor([20, 9], dtype=torch.int32),
            torch.tensor([19, 8], dtype=torch.int32))
    clean = pa.paged_attention_ref(*args)
    atol, rtol = pa.PAGED_PARITY_TOL[torch.float32]
    faults.configure("kernel_mismatch")
    try:
        # the oracle never perturbs; the model's route does, once (nth=1)
        assert torch.equal(pa.paged_attention_ref(*args), clean)
        bad = pa.paged_attention_route("torch", *args)
        again = pa.paged_attention_route("torch", *args)
    finally:
        faults.reset()
    with pytest.raises(AssertionError):
        torch.testing.assert_close(bad, clean, atol=atol, rtol=rtol)
    diff = (bad - clean).abs()
    assert diff[0, 0, 0, 0] == pytest.approx(1.0) and \
        int((diff > atol).sum()) == 1
    torch.testing.assert_close(again, clean, atol=atol, rtol=rtol)


def test_truncate_checkpoint_equals_the_reference(tmp_path):
    out = []
    for fmod, save, latest, d, full in (
            (faults, ckpt.save_checkpoint, ckpt.load_latest, "port",
             lambda v: torch.full((8,), v)),
            (jfaults, jckpt.save_checkpoint, jckpt.load_latest, "ref",
             lambda v: np.full(8, v, np.float32))):
        base = str(tmp_path / d)
        fmod.configure("truncate_checkpoint:nth=2,bytes=17")
        try:
            for step in (1, 2):
                save(base, {"x": full(float(step))}, step)
        finally:
            fmod.reset()
        torn = os.path.join(base, "ckpt-00000002", "data-rank00000.pkl")
        state, man = latest(base)
        out.append((os.path.getsize(torn), man["step"]))
        # the other package skips the torn payload too
        other = jckpt.load_latest if d == "port" else ckpt.load_latest
        out.append(other(base)[1]["step"])
    assert out == [(17, 1), 1, (17, 1), 1]
