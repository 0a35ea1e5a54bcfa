"""The port's serving stack against the JAX package's, and its own
contracts (prefix hit == cold, interleaved == solo, clean pool audit).

Model: ``gpt2-tiny`` with vocab 96 and initializer_range 0.35, float32, the
JAX model's weights carried into the port by ``convert``. Greedy tokens of
the two engines must be bitwise equal: the reference decodes through its
Pallas kernel body (``paged_kernel="pallas"`` runs the interpreter on the
CPU), the port through the plain version of its CUDA kernel, and float32
reduction-order differences stay far below this model's argmax margins.
Sampled tokens are compared only within the port: the two frameworks draw
different Gumbel noise.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu.serving import GenerationEngine as JaxEngine  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.profiler import registry  # noqa: E402
from paddle_tpu_torch.serving import (ContinuousBatchScheduler,  # noqa: E402
                                      GenerationEngine, GenerationRequest,
                                      GenerationServer)

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

VOCAB = 96
EKW = dict(max_batch_size=2, buckets=(16, 32), rng_seed=9, block_size=8)


@pytest.fixture(scope="module")
def models():
    # seeded, then the global generator is put back: later tests in this
    # process draw what they would have drawn without this file
    rng_state = paddle.get_rng_state()
    try:
        paddle.seed(21)
        cfg = jgpt.GPTConfig.preset("gpt2-tiny", vocab_size=VOCAB,
                                    initializer_range=0.35)
        jm = jgpt.GPTForPretraining(jgpt.GPTModel(cfg))
    finally:
        paddle.set_rng_state(rng_state)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tcfg = tgpt.GPTConfig.preset("gpt2-tiny", vocab_size=VOCAB,
                                 initializer_range=0.35)
    tm = tgpt.GPTForPretraining(tgpt.GPTModel(tcfg, device="cpu"))
    convert.load_paddle_tpu_state(tm, state)
    return jm, tm


def _engine(tm, **kw):
    return GenerationEngine(tm, device="cpu", **dict(EKW, **kw))


def _run_one(eng, prompt, n, slot=0, **kw):
    out = [eng.prefill(slot, prompt, **kw)]
    for _ in range(n - 1):
        out.append(int(eng.decode_step()[slot]))
    eng.release(slot)
    return out


def test_greedy_tokens_bitwise_equal_to_reference(models):
    jm, tm = models
    jeng = JaxEngine(jm, paged_kernel="pallas", **EKW)
    assert jeng.paged_kernel == "interpret"  # the Pallas body on the CPU
    teng = _engine(tm)
    assert teng.paged_kernel == "torch"
    rng = np.random.default_rng(5)
    # 15 / 16 / 17 tokens: under, on and over a block (8) and a bucket (16)
    # edge; 17 promotes to the 32-row bucket
    for i, n in enumerate((15, 16, 17)):
        prompt = [int(t) for t in rng.integers(1, VOCAB, n)]
        want = _run_one(jeng, prompt, 10, seed=i)
        got = _run_one(teng, prompt, 10, seed=i)
        assert got == want, (n, got, want)
        assert len(set(got)) > 1  # a live stream, not a constant token
    teng.pool.audit()


def test_prefix_hit_equals_cold(models):
    _, tm = models
    rng = np.random.default_rng(7)
    shared = [int(t) for t in rng.integers(1, VOCAB, 16)]
    for kw in (dict(temperature=0.0), dict(temperature=0.8, top_p=0.9)):
        warm = _engine(tm)
        _run_one(warm, shared + [3, 4, 5], 4, seed=40, **kw)
        hits = registry.counters("serving")["prefix_hits"]
        got = _run_one(warm, shared + [6, 7], 8, seed=41, **kw)
        assert registry.counters("serving")["prefix_hits"] == hits + 1
        cold = _run_one(_engine(tm), shared + [6, 7], 8, seed=41, **kw)
        assert got == cold
        warm.pool.audit()


REQS = [([5, 9, 2, 7, 1, 3], dict(max_new_tokens=9, seed=1)),
        ([8, 1, 3] * 5, dict(max_new_tokens=7, seed=2, temperature=0.8,
                             top_k=20, top_p=0.9)),
        ([4, 4, 6, 2, 9, 9, 1, 2, 3, 5, 7], dict(max_new_tokens=8, seed=3,
                                                 temperature=1.1))]


def _solo(tm, prompt, opts):
    eng = _engine(tm)
    sched = ContinuousBatchScheduler(eng)
    req = sched.submit(GenerationRequest(prompt, **opts))
    sched.drain()
    return req.tokens


def test_interleaved_equals_solo(models):
    _, tm = models
    want = [_solo(tm, p, o) for p, o in REQS]
    eng = _engine(tm, max_batch_size=3)
    sched = ContinuousBatchScheduler(eng)
    reqs = [sched.submit(GenerationRequest(REQS[0][0], **REQS[0][1]))]
    sched.step()
    sched.step()
    reqs.append(sched.submit(GenerationRequest(REQS[1][0], **REQS[1][1])))
    sched.step()
    reqs.append(sched.submit(GenerationRequest(REQS[2][0], **REQS[2][1])))
    assert sched.drain()
    assert [r.tokens for r in reqs] == want
    assert all(r.status == "done" for r in reqs)
    eng.pool.audit()
    assert eng.pool.in_use() == len(eng.prefix_cache)


def test_chunked_prefill_equals_unchunked(models):
    _, tm = models
    prompt = [int(t) for t in np.random.default_rng(3).integers(1, VOCAB,
                                                                 27)]
    opts = dict(max_new_tokens=6, seed=4, temperature=0.7)
    want = _solo(tm, prompt, opts)
    eng = _engine(tm)
    sched = ContinuousBatchScheduler(eng, prefill_chunk_tokens=8)
    c0 = registry.counters("serving")["prefill_chunks"]
    req = sched.submit(GenerationRequest(prompt, **opts))
    assert sched.drain()
    assert req.tokens == want
    assert registry.counters("serving")["prefill_chunks"] - c0 == 4


def test_pool_backpressure_serializes_admissions(models):
    _, tm = models
    # 3 usable blocks of 8 rows; each request needs 2 (10 prompt + 6 new)
    eng = _engine(tm, max_batch_size=2, num_blocks=4)
    sched = ContinuousBatchScheduler(eng)
    c0 = registry.counters("serving")["pool_exhausted"]
    reqs = [sched.submit(GenerationRequest(list(range(1 + i, 11 + i)),
                                           max_new_tokens=6, seed=i))
            for i in range(3)]
    assert sched.drain()
    assert all(r.status == "done" and len(r.tokens) == 6 for r in reqs)
    assert registry.counters("serving")["pool_exhausted"] > c0
    eng.pool.audit()


def test_server_generate_and_clean_audit(models):
    _, tm = models
    srv = GenerationServer(tm, max_batch_size=2, buckets=(16, 32),
                           block_size=8, device="cpu")
    try:
        a = srv.generate([1, 2, 3, 4, 5], max_new_tokens=6,
                         result_timeout=60)
        handles = [srv.submit([7, 8, 9] * 4, max_new_tokens=5, seed=s,
                              temperature=0.9) for s in range(3)]
        outs = [h.result(60).tokens for h in handles]
    finally:
        assert srv.shutdown(timeout=60)
    assert len(a) == 6 and all(0 <= t < VOCAB for t in a)
    assert [len(o) for o in outs] == [5, 5, 5]
    srv.engine.pool.audit()
    assert srv.engine.pool.in_use() == len(srv.engine.prefix_cache)
    with pytest.raises(RuntimeError, match="shutting down"):
        srv.submit([1, 2])
