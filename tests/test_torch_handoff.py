"""The port's prefill→decode KV handoff against the JAX package's
(``tests/test_serving_fleet.py::TestHandoffUnit``).

Model: ``gpt2-tiny`` (2 layers, d_model 128, vocab 96, initializer_range
0.35) in float32; weight sets A and B are two reference models seeded 21
and 22, carried into the port by ``convert``. Greedy tokens must equal the
reference's bitwise (float32 reduction-order differences stay far below
this model's argmax margins); sampled tokens are compared within the port
only, since the two packages draw different Gumbel noise (ROADMAP queue
3). Engines are driven step by step on the test's thread.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu.profiler import registry as jregistry  # noqa: E402
from paddle_tpu.serving import ContinuousBatchScheduler as JaxSched  # noqa
from paddle_tpu.serving import GenerationEngine as JaxEngine  # noqa: E402
from paddle_tpu.serving import GenerationRequest as JaxRequest  # noqa: E402
from paddle_tpu.serving.engine import \
    StaleHandoffError as JaxStale  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.profiler import registry  # noqa: E402
from paddle_tpu_torch.serving import (ContinuousBatchScheduler,  # noqa: E402
                                      DraftVerifyEngine, GenerationEngine,
                                      GenerationRequest, StaleHandoffError)
from paddle_tpu_torch.testing import faults  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

VOCAB = 96
EKW = dict(max_batch_size=2, buckets=(16, 32), block_size=8)
SEEDS = {"A": 21, "B": 22}
PROMPT = [int(t) for t in np.random.default_rng(3).integers(1, VOCAB, 19)]
N_NEW = 8


def _jax_model(seed):
    rng_state = paddle.get_rng_state()
    try:
        paddle.seed(seed)
        cfg = jgpt.GPTConfig.preset("gpt2-tiny", vocab_size=VOCAB,
                                    initializer_range=0.35)
        return jgpt.GPTForPretraining(jgpt.GPTModel(cfg))
    finally:
        paddle.set_rng_state(rng_state)


@pytest.fixture(scope="module")
def states():
    return {k: {n: np.asarray(v.numpy()).copy()
                for n, v in _jax_model(s).gpt.state_dict().items()}
            for k, s in SEEDS.items()}


def _port(state, **over):
    tm = tgpt.GPTForPretraining(tgpt.GPTModel(tgpt.GPTConfig.preset(
        "gpt2-tiny", vocab_size=VOCAB, initializer_range=0.35, **over),
        device="cpu"))
    convert.load_paddle_tpu_state(tm.gpt, state)
    return tm


def _jax(state):
    jm = _jax_model(SEEDS["A"])
    jm.gpt.set_state_dict({k: state[k] for k in jm.gpt.state_dict()})
    return jm


def _engine(tm, rng_seed=7, **kw):
    return GenerationEngine(tm, device="cpu",
                            **dict(EKW, rng_seed=rng_seed, **kw))


def _decode(eng, first, slot, n=N_NEW):
    out = [first]
    while len(out) < n:
        out.append(int(eng.decode_step()[slot]))
    eng.release(slot)
    return out


def _monolithic(eng, prompt=PROMPT, **opts):
    return _decode(eng, eng.prefill(0, prompt, max_new_tokens=N_NEW, **opts),
                   0)


def _export(eng, prompt=PROMPT, **opts):
    eng.prefill(0, prompt, max_new_tokens=N_NEW, **opts)
    payload = eng.export_request_kv(0)
    eng.release(0)
    eng.pool.audit()
    return payload


@pytest.mark.parametrize("opts", [dict(seed=0),
                                  dict(seed=5, temperature=0.8, top_p=0.9)],
                         ids=["greedy", "sampled"])
def test_port_handoff_is_bitwise_and_counted(states, opts):
    tm = _port(states["A"])
    want = _monolithic(_engine(tm), **opts)
    a = _engine(tm)
    # the decode side's base key differs on purpose: the exported request
    # key must rule
    b = _engine(tm, rng_seed=99)
    c0 = registry.counters("serving")
    payload = _export(a, **opts)
    assert payload["kv_k"][0].dtype == torch.float32
    assert tuple(payload["kv_k"][0].shape) == (payload["n_blocks"], 8, 4, 32)
    assert b.can_import(payload)
    got = b.import_request_kv(1, payload, prompt_ids=PROMPT)
    # the adopted rows are the exported bytes
    rows = torch.tensor(b._slot_blocks[1])
    for (k, v), kb, vb in zip(b._kv, payload["kv_k"], payload["kv_v"]):
        assert torch.equal(k[rows], kb) and torch.equal(v[rows], vb)
    assert _decode(b, got, 1) == want
    c1 = registry.counters("serving")
    assert c1["handoff_exports"] == c0["handoff_exports"] + 1
    assert c1["handoff_imports"] == c0["handoff_imports"] + 1
    assert c1["prefills"] == c0["prefills"] + 1  # A's only
    # the adopted prompt's full blocks joined B's prefix cache
    assert len(b.prefix_cache) == len(PROMPT) // 8
    b.pool.audit()


def test_handoff_across_packages_greedy(states):
    a_state = states["A"]
    jref = _monolithic(JaxEngine(_jax(a_state), rng_seed=7, **EKW), seed=0)
    tm = _port(a_state)
    assert _monolithic(_engine(tm), seed=0) == jref
    # port payload -> reference engine
    jb = JaxEngine(_jax(a_state), rng_seed=99, **EKW)
    payload = _export(_engine(tm), seed=0)
    assert jb.can_import(payload)
    assert _decode(jb, jb.import_request_kv(0, payload, prompt_ids=PROMPT),
                   0) == jref
    jb.pool.audit()
    # reference payload -> port engine
    ja = JaxEngine(_jax(a_state), rng_seed=7, **EKW)
    ja.prefill(0, PROMPT, seed=0, max_new_tokens=N_NEW)
    jpayload = ja.export_request_kv(0)
    assert isinstance(jpayload["kv_k"][0], np.ndarray)
    b = _engine(tm, rng_seed=99)
    assert _decode(b, b.import_request_kv(0, jpayload, prompt_ids=PROMPT),
                   0) == jref
    b.pool.audit()


def test_stale_handoff_is_refused_and_prefilled_again(states):
    want = _monolithic(_engine(_port(states["B"])), seed=0)
    jwant = _monolithic(JaxEngine(_jax(states["B"]), rng_seed=7, **EKW),
                        seed=0)
    assert want == jwant
    a = _engine(_port(states["A"]))
    b = _engine(_port(states["A"]))
    payload = _export(a, seed=0)
    b.swap_weights(states["B"])  # lands between the export and the import
    c0 = registry.counters("serving")
    with pytest.raises(StaleHandoffError):
        b.import_request_kv(0, payload, prompt_ids=PROMPT)
    b.pool.audit()  # the refusal leaks nothing
    assert len(b.prefix_cache) == 0  # and publishes no stale block
    sched = ContinuousBatchScheduler(b)
    req = GenerationRequest(PROMPT, max_new_tokens=N_NEW, seed=0)
    req.kv_payload = payload
    sched.submit(req)
    while sched.step():
        pass
    c1 = registry.counters("serving")
    assert req.status == "done" and req.tokens == want
    assert req.kv_payload is None
    assert c1["handoff_stale"] == c0["handoff_stale"] + 2
    assert c1["handoff_imports"] == c0["handoff_imports"]
    assert c1["prefills"] == c0["prefills"] + 1
    b.pool.audit()


def _mismatch(payload, what):
    p = dict(payload)
    if what == "block_size":
        p["block_size"] = 16
    elif what == "block_count":
        p["n_blocks"] = 99
    elif what == "layers":
        p["kv_k"], p["kv_v"] = p["kv_k"][:1], p["kv_v"][:1]
    else:  # block shape: 2 heads of 64 where the engine has 4 of 32
        p["kv_k"] = [k.reshape(k.shape[0], 8, 2, 64) for k in p["kv_k"]]
    return p


@pytest.mark.parametrize("what", ["block_size", "block_count", "layers",
                                  "block_shape"])
def test_import_refuses_a_payload_of_another_geometry(states, what):
    tm = _port(states["A"])
    payload = _mismatch(_export(_engine(tm), seed=0), what)
    b = _engine(tm)
    with pytest.raises(ValueError, match={"block_size": "block_size",
                                          "block_count": "blocks but",
                                          "layers": "layers",
                                          "block_shape": "blocks"}[what]):
        b.import_request_kv(0, payload, prompt_ids=PROMPT)
    b.pool.audit()
    assert b.pool.in_use() == 0 and not b._active.any()


def test_can_import_backs_off_under_page_pool_exhausted(states):
    tm = _port(states["A"])
    a = _engine(tm)
    payloads = [_export(a, prompt=PROMPT[:n], seed=i)
                for i, n in enumerate((19, 11, 7))]
    want = [_monolithic(_engine(tm), prompt=PROMPT[:n], seed=i)
            for i, n in enumerate((19, 11, 7))]
    b = _engine(tm)
    faults.configure("page_pool_exhausted:times=2")
    try:
        assert not b.can_import(payloads[0])
        c0 = registry.counters("serving")
        sched = ContinuousBatchScheduler(b)
        reqs = []
        for i, (p, n) in enumerate(zip(payloads, (19, 11, 7))):
            r = GenerationRequest(PROMPT[:n], max_new_tokens=N_NEW, seed=i)
            r.kv_payload = p
            reqs.append(sched.submit(r))
        sched.step()
        assert sched.queued() == 3  # the second fired fault held the head
        while sched.step():
            pass
    finally:
        faults.reset()
    c1 = registry.counters("serving")
    assert [r.tokens for r in reqs] == want
    assert all(r.status == "done" for r in reqs)
    assert c1["pool_exhausted"] == c0["pool_exhausted"] + 1
    assert c1["handoff_imports"] == c0["handoff_imports"] + 3
    b.pool.audit()


def test_spec_engine_adopts_a_handoff_equal_to_plain_decode(states):
    tm = _port(states["A"])
    opts = dict(seed=2, temperature=0.8)
    want = _monolithic(_engine(tm), **opts)
    spec = DraftVerifyEngine(tm, _port(states["A"]), draft_k=3,
                             device="cpu", **dict(EKW, rng_seed=99))
    payload = _export(_engine(tm), **opts)
    assert spec.can_import(payload)
    with pytest.raises(ValueError, match="prompt_ids"):
        spec.import_request_kv(0, payload)
    with pytest.raises(ValueError, match="fresh"):
        spec.import_request_kv(0, payload, prompt_ids=PROMPT[:-1])
    spec.pool.audit()
    spec.draft_pool.audit()
    c0 = registry.counters("serving")
    got = [spec.import_request_kv(0, payload, prompt_ids=PROMPT)]
    # the drafter's budget is taken once, at the import: its ceiling
    assert len(spec._draft_blocks[0]) == spec.blocks_per_slot
    while len(got) < N_NEW:
        got.extend(spec.decode_step_spec()[0])
    assert got[:N_NEW] == want
    c1 = registry.counters("serving")  # a twin drafter: all accepted
    assert c1["spec_accepted"] - c0["spec_accepted"] == \
        c1["spec_proposed"] - c0["spec_proposed"] > 0
    spec.release(0)
    spec.pool.audit()
    spec.draft_pool.audit()


def _reference_reprime_then_swap(states):
    """The reference: A re-primes, then prefills and exports; B swaps to
    weights B; B adopts the payload. Returns B's tokens."""
    ja = JaxEngine(_jax(states["A"]), rng_seed=7, **EKW)
    jb = JaxEngine(_jax(states["A"]), rng_seed=7, **EKW)
    ja.reprime()
    ja.prefill(0, PROMPT, seed=0, max_new_tokens=N_NEW)
    payload = ja.export_request_kv(0)
    jb.swap_weights(states["B"])
    assert payload["weight_generation"] == jb.prefix_cache.generation == 1
    return _decode(jb, jb.import_request_kv(0, payload, prompt_ids=PROMPT),
                   0)


def test_reprime_then_swap_reference_adopts_stale_kv_port_refuses(states):
    """A re-prime advances the reference's handoff generation
    (``prefix_cache.generation``) as a swap does, so after one re-prime on
    the prefill side and one swap on the decode side old-weight KV passes
    as current there. The port's generation counts swaps only."""
    want = _monolithic(_engine(_port(states["B"])), seed=0)
    assert _reference_reprime_then_swap(states) != want

    a, b = _engine(_port(states["A"])), _engine(_port(states["A"]))
    a.reprime()
    payload = _export(a, seed=0)
    assert payload["weight_generation"] == 0
    b.swap_weights(states["B"])
    with pytest.raises(StaleHandoffError):
        b.import_request_kv(0, payload, prompt_ids=PROMPT)
    sched = ContinuousBatchScheduler(b)
    req = GenerationRequest(PROMPT, max_new_tokens=N_NEW, seed=0)
    req.kv_payload = payload
    sched.submit(req)
    while sched.step():
        pass
    assert req.tokens == want
    b.pool.audit()


def test_reprime_on_the_decode_side_alone(states):
    """The converse: after one re-prime on the decode side the reference
    refuses every later handoff as stale (and prefills it again), while
    the port adopts it; both give the monolithic tokens."""
    want = _monolithic(_engine(_port(states["A"])), seed=0)
    ja = JaxEngine(_jax(states["A"]), rng_seed=7, **EKW)
    jb = JaxEngine(_jax(states["A"]), rng_seed=7, **EKW)
    ja.prefill(0, PROMPT, seed=0, max_new_tokens=N_NEW)
    jpayload = ja.export_request_kv(0)
    jb.reprime()
    with pytest.raises(JaxStale):
        jb.import_request_kv(0, jpayload, prompt_ids=PROMPT)
    j0 = jregistry.counters("serving")["prefills"]
    jreq = JaxRequest(PROMPT, max_new_tokens=N_NEW, seed=0)
    jreq.kv_payload = jpayload
    jsched = JaxSched(jb)
    jsched.submit(jreq)
    while jsched.step():
        pass
    assert jreq.tokens == want
    assert jregistry.counters("serving")["prefills"] == j0 + 1

    a, b = _engine(_port(states["A"])), _engine(_port(states["A"]))
    payload = _export(a, seed=0)
    b.reprime()
    c0 = registry.counters("serving")
    assert _decode(b, b.import_request_kv(0, payload, prompt_ids=PROMPT),
                   0) == want
    c1 = registry.counters("serving")
    assert c1["handoff_imports"] == c0["handoff_imports"] + 1
    assert c1["handoff_stale"] == c0["handoff_stale"]
