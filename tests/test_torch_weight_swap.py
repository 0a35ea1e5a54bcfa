"""The port's weight hot-swap, re-prime-and-retry and replica takeover
against the JAX package's (``tests/test_serving.py::TestWeightHotSwap``).

Models: ``gpt2-tiny`` (2 layers, d_model 128, vocab 96, initializer_range
0.35) in float32 unless a test says otherwise; weight sets A and B are two
reference models seeded 21 and 22, carried into the port by ``convert``.
Both sides are driven synchronously at step boundaries, never by sleeps.
Greedy tokens must equal the reference's bitwise (float32 reduction-order
differences stay far below this model's argmax margins). Each test builds
its own models: a swap writes into the model's own parameters.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu.profiler import registry as jregistry  # noqa: E402
from paddle_tpu.serving import ContinuousBatchScheduler as JaxSched  # noqa
from paddle_tpu.serving import DraftVerifyEngine as JaxSpec  # noqa: E402
from paddle_tpu.serving import GenerationEngine as JaxEngine  # noqa: E402
from paddle_tpu.serving import GenerationRequest as JaxRequest  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.profiler import registry  # noqa: E402
from paddle_tpu_torch.serving import (ContinuousBatchScheduler,  # noqa: E402
                                      DraftVerifyEngine, FatalEngineError,
                                      GenerationEngine, GenerationRequest,
                                      GenerationServer, WeightSwapError)

VOCAB = 96
EKW = dict(max_batch_size=3, buckets=(16, 32), rng_seed=9, block_size=8)
SEEDS = {"A": 21, "B": 22}


def _jax_model(seed, n_layer=2):
    rng_state = paddle.get_rng_state()
    try:
        paddle.seed(seed)
        cfg = jgpt.GPTConfig.preset("gpt2-tiny", vocab_size=VOCAB,
                                    n_layer=n_layer, initializer_range=0.35)
        return jgpt.GPTForPretraining(jgpt.GPTModel(cfg))
    finally:
        paddle.set_rng_state(rng_state)


def _np_state(jm):
    """The trunk's state as numpy (the reference's names and layout)."""
    return {k: np.asarray(v.numpy()).copy()
            for k, v in jm.gpt.state_dict().items()}


@pytest.fixture(scope="module")
def states():
    return {k: _np_state(_jax_model(s)) for k, s in SEEDS.items()}


def _jax_with(state, n_layer=2):
    """A fresh reference model holding ``state``."""
    jm = _jax_model(SEEDS["A"], n_layer)
    jm.gpt.set_state_dict({k: state[k] for k in jm.gpt.state_dict()})
    return jm


def _port_with(state, n_layer=2, dtype="float32"):
    tm = tgpt.GPTForPretraining(tgpt.GPTModel(tgpt.GPTConfig.preset(
        "gpt2-tiny", vocab_size=VOCAB, n_layer=n_layer,
        initializer_range=0.35, dtype=dtype), device="cpu"))
    convert.load_paddle_tpu_state(tm.gpt, state)
    return tm


def _engine(tm, **kw):
    return GenerationEngine(tm, device="cpu", **dict(EKW, **kw))


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _same_params(model, snap):
    return all(torch.equal(v, snap[k]) for k, v in model.state_dict().items())


PROMPTS = [[int(t) for t in np.random.default_rng(i).integers(1, VOCAB, n)]
           for i, n in enumerate((5, 11, 17, 8))]


def _drive(sched, make_req, swap_state=None, swap_at=None, n_new=12):
    """Submit PROMPTS greedily, step to the end, stage ``swap_state`` before
    step ``swap_at``. Returns the requests."""
    reqs = [sched.submit(make_req(p, max_new_tokens=n_new, seed=i))
            for i, p in enumerate(PROMPTS)]
    steps = 0
    while sched.has_work():
        if steps == swap_at:
            sched.request_swap(swap_state, source="test")
        sched.step()
        steps += 1
    return reqs


def test_mid_flight_swap_tokens_equal_reference(states):
    a, b = states["A"], states["B"]
    jeng = JaxEngine(_jax_with(a), **EKW)
    j0 = dict(jregistry.counters("serving"))
    want = _drive(JaxSched(jeng), JaxRequest, b, swap_at=4)
    j1 = jregistry.counters("serving")
    assert j1["weight_swaps"] == j0["weight_swaps"] + 1

    teng = _engine(_port_with(a))
    gen0 = teng.prefix_cache.generation
    c0 = registry.counters("serving")
    got = _drive(ContinuousBatchScheduler(teng), GenerationRequest, b,
                 swap_at=4)
    c1 = registry.counters("serving")
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert all(r.status == "done" for r in got)
    assert c1["weight_swaps"] == c0["weight_swaps"] + 1
    assert c1["swap_failures"] == c0["swap_failures"]
    assert c1["decode_compiles"] == c0["decode_compiles"]
    assert teng.prefix_cache.generation == gen0 + 1
    # the swap is observable: without it the tokens differ
    plain = _drive(ContinuousBatchScheduler(_engine(_port_with(a))),
                   GenerationRequest)
    assert [r.tokens for r in plain] != [r.tokens for r in got]
    teng.pool.audit()


@pytest.mark.parametrize("nest", ["gpt_prefix", "checkpoint", "port_layout"])
def test_swap_accepts_reference_nests_and_port_state(states, nest):
    a, b = states["A"], states["B"]
    want = convert.state_from_paddle_tpu(b, _port_with(a).gpt)
    if nest == "gpt_prefix":
        state = {f"gpt.{k}": v for k, v in b.items()}
    elif nest == "checkpoint":
        state = {"model": {f"gpt.{k}": {"__tensor__": True, "data": v}
                           for k, v in b.items()}, "optimizer": {}}
    else:  # the port's own layout, from a model's state_dict
        state = _port_with(b).state_dict()
    eng = _engine(_port_with(a))
    eng.swap_weights(state)
    got = eng._gpt.state_dict()
    # out_proj is square: a guessed layout would transpose it
    assert all(torch.equal(got[k], want[k]) for k in want)


def _bad_states(a, b, port_b):
    trunc = dict(b)
    name = next(k for k in trunc if trunc[k].ndim == 2)
    trunc[name] = trunc[name][:-1]
    mixed = dict(b)
    first = next(iter(mixed))
    mixed[first] = port_b[first]  # one torch tensor among arrays
    return {"missing": {k: b[k] for k in list(b)[:3]},
            "truncated": trunc, "mixed": mixed,
            "not_a_dict": list(b.values()),
            "not_a_number": {**b, first: np.asarray(["x"] * 4)}}


@pytest.mark.parametrize("kind", ["missing", "truncated", "mixed",
                                  "not_a_dict", "not_a_number"])
def test_refused_swap_leaves_every_parameter_unchanged(states, kind):
    a, b = states["A"], states["B"]
    port_b = _port_with(b).gpt.state_dict()
    bad = _bad_states(a, b, port_b)[kind]
    tm = _port_with(a)
    eng = _engine(tm)
    snap = _snapshot(tm)
    gen0 = eng.prefix_cache.generation
    with pytest.raises(WeightSwapError):
        eng.swap_weights(bad)
    assert _same_params(tm, snap)
    assert eng.prefix_cache.generation == gen0
    # staged through the scheduler: counted, and the old weights serve
    sched = ContinuousBatchScheduler(eng)
    c0 = registry.counters("serving")
    sched.request_swap(bad, source="bad")
    req = sched.submit(GenerationRequest(PROMPTS[0], max_new_tokens=6))
    sched.drain()
    c1 = registry.counters("serving")
    assert c1["swap_failures"] == c0["swap_failures"] + 1
    assert c1["weight_swaps"] == c0["weight_swaps"]
    assert isinstance(sched.last_swap_error, WeightSwapError)
    assert sched.swap_count == 0
    ref = ContinuousBatchScheduler(_engine(_port_with(a)))
    want = ref.submit(GenerationRequest(PROMPTS[0], max_new_tokens=6))
    ref.drain()
    assert req.tokens == want.tokens and _same_params(tm, snap)


def test_failure_between_staging_and_commit_leaves_weights_whole(
        states, monkeypatch):
    tm = _port_with(states["A"])
    eng = _engine(tm)
    snap = _snapshot(tm)
    head = eng._head_w.clone()
    stage = eng._stage_swap

    def stage_then_die(*args):
        stage(*args)
        raise RuntimeError("lost between staging and commit")

    monkeypatch.setattr(eng, "_stage_swap", stage_then_die)
    c0 = registry.counters("serving")["weight_swaps"]
    with pytest.raises(RuntimeError, match="between staging"):
        eng.swap_weights(states["B"])
    assert _same_params(tm, snap) and torch.equal(eng._head_w, head)
    assert registry.counters("serving")["weight_swaps"] == c0


def test_bf16_swap_refreshes_the_float32_lm_head(states):
    a, b = states["A"], states["B"]
    eng = _engine(_port_with(a, dtype="bfloat16"))
    fresh = _engine(_port_with(b, dtype="bfloat16"))
    # in bf16 the head is a float32 copy of the embedding, not the weight
    assert eng._head_w.data_ptr() != \
        eng._gpt.embeddings.word_embeddings.weight.data_ptr()
    eng.swap_weights(b)
    logits = []
    for e in (eng, fresh):
        e.prefill(0, PROMPTS[2], seed=0)
        e.decode_step()
        logits.append(e.last_logits[0].clone())
    assert torch.equal(logits[0], logits[1])
    assert torch.equal(eng._head_w, fresh._head_w)


class _Faults:
    """Raise from ``engine._finish_decode`` (after the step body ran and
    advanced the device cursors, before the host mirrors advance) on the
    given calls."""

    def __init__(self, engine, at, exc=RuntimeError):
        self.calls, self.at, self.exc = 0, set(at), exc
        self._orig = engine._finish_decode
        engine._finish_decode = self

    def __call__(self, *args):
        self.calls += 1
        if self.calls in self.at:
            raise self.exc(f"injected fault at decode call {self.calls}")
        return self._orig(*args)


def _serve(eng, n_new=10):
    sched = ContinuousBatchScheduler(eng)
    reqs = [sched.submit(GenerationRequest(p, max_new_tokens=n_new, seed=i))
            for i, p in enumerate(PROMPTS[:3])]
    sched.drain()
    return [r.tokens for r in reqs]


def test_one_fault_retries_to_the_unfaulted_tokens(states):
    want = _serve(_engine(_port_with(states["A"])))
    eng = _engine(_port_with(states["A"]))
    gen0 = eng.prefix_cache.generation
    c0 = registry.counters("serving")
    _Faults(eng, at={4})
    assert _serve(eng) == want
    c1 = registry.counters("serving")
    assert c1["step_retries"] == c0["step_retries"] + 1
    assert c1["reprimes"] == c0["reprimes"] + 1
    assert c1["requests_failed"] == c0["requests_failed"]
    assert eng.prefix_cache.generation == gen0 + 1


def test_two_faults_in_a_row_fail_the_batch(states):
    eng = _engine(_port_with(states["A"]))
    _Faults(eng, at={3, 4})
    srv = GenerationServer(engine=eng)
    try:
        reqs = [srv.submit(p, max_new_tokens=10, seed=i)
                for i, p in enumerate(PROMPTS[:3])]
        for r in reqs:
            r.result(timeout=60)
    finally:
        srv.shutdown(timeout=60)
    assert all(r.status == "error" for r in reqs)
    assert "injected fault at decode call 4" in str(srv.last_error)
    assert srv.fatal_error is None


def test_fatal_error_is_not_retried(states):
    eng = _engine(_port_with(states["A"]))
    _Faults(eng, at={2}, exc=FatalEngineError)
    sched = ContinuousBatchScheduler(eng)
    sched.submit(GenerationRequest(PROMPTS[0], max_new_tokens=10))
    c0 = registry.counters("serving")
    with pytest.raises(FatalEngineError):
        while sched.has_work():
            sched.step()
    c1 = registry.counters("serving")
    assert c1["step_retries"] == c0["step_retries"]
    assert c1["reprimes"] == c0["reprimes"]
    # through the server: the worker stops and fails the pending requests
    eng = _engine(_port_with(states["A"]))
    _Faults(eng, at={2}, exc=FatalEngineError)
    srv = GenerationServer(engine=eng)
    try:
        req = srv.submit(PROMPTS[0], max_new_tokens=10).result(timeout=60)
    finally:
        srv.shutdown(timeout=60)
    assert req.status == "error"
    assert isinstance(srv.fatal_error, FatalEngineError)


def test_fatal_error_under_a_supervisor_leaves_requests_to_take_over(states):
    want = _serve(_engine(_port_with(states["A"])))
    eng = _engine(_port_with(states["A"]))
    _Faults(eng, at={3}, exc=FatalEngineError)
    srv = GenerationServer(engine=eng, fail_fast_on_fatal=False)
    reqs = [srv.submit(p, max_new_tokens=10, seed=i)
            for i, p in enumerate(PROMPTS[:3])]
    srv._thread.join(timeout=60)
    assert not srv._thread.is_alive()
    assert isinstance(srv.fatal_error, FatalEngineError)
    assert not any(r.done for r in reqs)  # left for the takeover
    taken = srv.scheduler.takeover_requests()
    srv.shutdown(timeout=60)
    replica = GenerationServer(engine=_engine(_port_with(states["A"])))
    try:
        for r in taken:
            replica.submit_request(r)
        assert [r.result(timeout=60).tokens for r in reqs] == want
    finally:
        replica.shutdown(timeout=60)


def test_takeover_and_resubmission_reproduce_the_tokens(states):
    opts = [dict(seed=0), dict(seed=1, temperature=0.9, top_p=0.9),
            dict(seed=2, temperature=1.2), dict(seed=3)]

    def requests():
        return [GenerationRequest(p, max_new_tokens=10, **o)
                for p, o in zip(PROMPTS, opts)]

    want = requests()
    sched = ContinuousBatchScheduler(_engine(_port_with(states["A"])))
    for r in want:
        sched.submit(r)
    sched.drain()

    reqs = requests()
    sched = ContinuousBatchScheduler(_engine(_port_with(states["A"])))
    for r in reqs:
        sched.submit(r)
    for _ in range(4):  # three in flight, one queued
        sched.step()
    c0 = registry.counters("serving")["requeued_requests"]
    taken = sched.takeover_requests()
    assert registry.counters("serving")["requeued_requests"] == c0 + 4
    assert sorted(r.rid for r in taken) == sorted(r.rid for r in reqs)
    assert all(not r.done and r.tokens == [] for r in taken)
    assert sched.active() == sched.queued() == sched.prefilling() == 0
    srv = GenerationServer(engine=_engine(_port_with(states["A"])))
    try:
        for r in taken:
            srv.submit_request(r)
        for r in reqs:
            r.result(timeout=60)
    finally:
        srv.shutdown(timeout=60)
    assert [r.tokens for r in reqs] == [r.tokens for r in want]
    # the reference's takeover and replay give the same greedy tokens
    # (sampled ones differ between the frameworks' noise)
    jreqs = [JaxRequest(p, max_new_tokens=10, **o)
             for p, o in zip(PROMPTS, opts)]
    jsched = JaxSched(JaxEngine(_jax_with(states["A"]), **EKW))
    for r in jreqs:
        jsched.submit(r)
    for _ in range(4):
        jsched.step()
    replay = JaxSched(JaxEngine(_jax_with(states["A"]), **EKW))
    for r in jsched.takeover_requests():
        replay.submit(r)
    replay.drain()
    greedy = [i for i, o in enumerate(opts) if "temperature" not in o]
    assert [jreqs[i].tokens for i in greedy] == \
        [reqs[i].tokens for i in greedy]


def _spec_rounds(eng, prompt, swap, rounds=(3, 4)):
    """Prefill, ``rounds[0]`` spec rounds, ``swap(eng)``, ``rounds[1]``
    more. Returns the per-round tokens and accept counts."""
    out = [[eng.prefill(0, prompt, seed=0)]]
    accepts = []
    for r in range(sum(rounds)):
        if r == rounds[0]:
            swap(eng)
        a0 = _accepted(eng)
        out.append(list(eng.decode_step_spec()[0]))
        accepts.append(_accepted(eng) - a0)
    return out, accepts


def _accepted(eng):
    reg = jregistry if isinstance(eng, JaxSpec) else registry
    return reg.counters("serving")["spec_accepted"]


def test_spec_swap_with_draft_state_equals_reference(states):
    a, b = states["A"], states["B"]
    # 1-layer drafters holding the target's embeddings, first block and
    # final LayerNorm: they agree with the target on some drafts only
    da = {k: a[k] for k in _np_state(_jax_model(5, 1))}
    db = {k: b[k] for k in da}
    kw = dict(EKW, max_batch_size=1, draft_k=3)
    jeng = JaxSpec(_jax_with(a), _jax_with(da, 1), **kw)
    teng = DraftVerifyEngine(_port_with(a), _port_with(da, 1), device="cpu",
                             **kw)
    prompt = PROMPTS[2]
    c0 = registry.counters("serving")["draft_swaps"]
    got = _spec_rounds(teng, prompt,
                       lambda e: e.swap_weights(b, draft_state=db))
    want = _spec_rounds(jeng, prompt,
                        lambda e: e.swap_weights(b, draft_state=db))
    assert got == want
    assert registry.counters("serving")["draft_swaps"] == c0 + 1
    assert sum(got[1][3:]) > 0  # the rebuilt drafter is accepted again
    gens = teng.acceptance_by_generation()
    assert len(gens) == 2
    jgens = jeng.acceptance_by_generation()
    assert list(gens.values()) == pytest.approx(list(jgens.values()),
                                                abs=0)
    # greedy tokens after the swap equal plain decode's under the same
    # swap schedule
    n_before = sum(len(t) for t in got[0][:4])
    plain = _engine(_port_with(a), max_batch_size=1)
    toks = [plain.prefill(0, prompt, seed=0)]
    while len(toks) < sum(len(t) for t in got[0]):
        if len(toks) == n_before:
            plain.swap_weights(b)
        toks.append(int(plain.decode_step()[0]))
    assert toks == [t for r in got[0] for t in r]
    teng.pool.audit()
    teng.draft_pool.audit()


def test_drafter_swapped_to_the_target_agrees_on_every_draft(states):
    """An independent drafter swapped mid-stream to the target's own
    weights (the target swapped to itself): its KV is rebuilt from the
    token history, so from then on every draft is accepted."""
    a, b = states["A"], states["B"]
    eng = DraftVerifyEngine(_port_with(a), _port_with(b), device="cpu",
                            **dict(EKW, max_batch_size=1, draft_k=3))
    _spec_rounds(eng, PROMPTS[2], lambda e: e.swap_weights(
        a, draft_state=a), rounds=(2, 4))
    gens = eng.acceptance_by_generation()
    assert len(gens) == 2 and list(gens.values())[-1] == 1.0
    assert list(gens.values())[0] < 1.0


class _FaultAfter:
    """Stands in for a step graph: runs it (the device cursors advance),
    then raises once."""

    def __init__(self, graph):
        self.graph = graph

    def __call__(self):
        self.graph()
        raise RuntimeError("injected fault after the verify")


def test_spec_fault_after_the_verify_retries_to_the_same_tokens(states):
    a = states["A"]
    da = {k: a[k] for k in _np_state(_jax_model(5, 1))}

    def run(fault):
        eng = DraftVerifyEngine(_port_with(a), _port_with(da, 1),
                                device="cpu",
                                **dict(EKW, max_batch_size=2, draft_k=3))
        sched = ContinuousBatchScheduler(eng)
        reqs = [sched.submit(GenerationRequest(p, max_new_tokens=12, seed=i))
                for i, p in enumerate(PROMPTS[:2])]
        sched.step()
        sched.step()
        if fault:
            eng._verify_graph = _FaultAfter(eng._verify_graph)
        sched.drain()
        return [r.tokens for r in reqs]

    want = run(False)
    c0 = registry.counters("serving")
    assert run(True) == want
    c1 = registry.counters("serving")
    assert c1["step_retries"] == c0["step_retries"] + 1
    assert c1["reprimes"] == c0["reprimes"] + 1


def test_spec_acceptance_keeps_the_newest_generations(states):
    from paddle_tpu_torch.serving import spec_decode

    a = states["A"]
    da = {k: a[k] for k in _np_state(_jax_model(5, 1))}
    eng = DraftVerifyEngine(_port_with(a), _port_with(da, 1), device="cpu",
                            **dict(EKW, max_batch_size=1, draft_k=3))
    eng.prefill(0, PROMPTS[1], seed=0)
    for _ in range(spec_decode.SPEC_ACCEPT_KEEP_GENERATIONS + 2):
        eng.decode_step_spec()
        eng.swap_weights(a)  # each swap starts a weight generation
    eng.decode_step_spec()
    gens = eng.acceptance_by_generation()
    assert len(gens) == spec_decode.SPEC_ACCEPT_KEEP_GENERATIONS
    gauges = registry.gauges()
    assert "serving.spec_acceptance.historic" in gauges
    assert f"serving.spec_acceptance.gen{min(gens)}" in gauges
    assert f"serving.spec_acceptance.gen{min(gens) - 1}" not in gauges


@pytest.mark.parametrize("how", ["reprime", "retried_fault"])
def test_spec_reprime_opens_no_weight_generation(states, how):
    """Acceptance is kept per weight generation, which only a swap
    advances: a re-prime, alone or as a retry's, changes no weights."""
    a = states["A"]
    da = {k: a[k] for k in _np_state(_jax_model(5, 1))}
    eng = DraftVerifyEngine(_port_with(a), _port_with(da, 1), device="cpu",
                            **dict(EKW, max_batch_size=1, draft_k=3))
    sched = ContinuousBatchScheduler(eng)
    req = sched.submit(GenerationRequest(PROMPTS[1], max_new_tokens=12,
                                         seed=0))
    sched.step()
    sched.step()
    if how == "reprime":
        eng.reprime()
    else:
        eng._verify_graph = _FaultAfter(eng._verify_graph)
    r0 = registry.counters("serving")["reprimes"]
    sched.drain()
    assert req.status == "done"
    assert registry.counters("serving")["reprimes"] == \
        r0 + (how == "retried_fault")
    assert list(eng.acceptance_by_generation()) == [0]
    eng.swap_weights(a)
    eng.prefill(0, PROMPTS[2], seed=0)
    eng.decode_step_spec()
    assert list(eng.acceptance_by_generation()) == [0, 1]


def test_spec_reprime_drops_every_graph(states):
    a = states["A"]
    da = {k: a[k] for k in _np_state(_jax_model(5, 1))}
    eng = DraftVerifyEngine(_port_with(a), _port_with(da, 1), device="cpu",
                            **dict(EKW, max_batch_size=1, draft_k=3))
    graphs = (eng._decode_graph, eng._draft_graph, eng._verify_graph)
    eng.reprime()
    assert all(g is not n for g, n in zip(graphs, (
        eng._decode_graph, eng._draft_graph, eng._verify_graph)))
    assert eng._fast is False
