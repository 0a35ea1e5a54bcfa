"""The port's draft-verify speculative decoding against the JAX package's,
and its own contracts (the reference's ``tests/test_spec_decode.py``):
spec tokens equal plain decode's, greedy and sampled; a twin drafter is
accepted in full; the interleaved spec server matches the plain server;
chunked admissions reserve the drafter's blocks up front; stop conditions
apply per token inside a round; both pools audit clean; and a request that
runs to the cache ceiling keeps plain decode's tokens.

Models: target ``gpt2-tiny`` and a 1-layer ``gpt2-tiny`` drafter, vocab 96,
initializer_range 0.35, float32, the JAX models' weights carried into the
port by ``convert``. Greedy tokens and accept counts must equal the
reference's bitwise (float32 reduction-order differences stay far below
this model's argmax margins); sampled tokens are compared within the port,
since the two frameworks draw different Gumbel noise.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu.profiler import registry as jregistry  # noqa: E402
from paddle_tpu.serving import DraftVerifyEngine as JaxSpec  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.profiler import registry  # noqa: E402
from paddle_tpu_torch.serving import (ContinuousBatchScheduler,  # noqa: E402
                                      DraftVerifyEngine, GenerationEngine,
                                      GenerationRequest, GenerationServer)

VOCAB = 96
EKW = dict(max_batch_size=2, buckets=(16, 32), rng_seed=9, block_size=8)


def _pair(seed, n_layer, weights_of=None):
    """A JAX gpt2-tiny from ``seed`` (or with the weights of the same names
    in ``weights_of``) and the port's copy of it."""
    rng_state = paddle.get_rng_state()
    try:
        paddle.seed(seed)
        cfg = jgpt.GPTConfig.preset("gpt2-tiny", vocab_size=VOCAB,
                                    n_layer=n_layer, initializer_range=0.35)
        jm = jgpt.GPTForPretraining(jgpt.GPTModel(cfg))
    finally:
        paddle.set_rng_state(rng_state)
    if weights_of is not None:
        src = weights_of.state_dict()
        jm.set_state_dict({k: src[k] for k in jm.state_dict()})
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tgpt.GPTForPretraining(tgpt.GPTModel(tgpt.GPTConfig.preset(
        "gpt2-tiny", vocab_size=VOCAB, n_layer=n_layer,
        initializer_range=0.35), device="cpu"))
    convert.load_paddle_tpu_state(tm, state)
    return jm, tm


@pytest.fixture(scope="module")
def models():
    """The target; an independent 1-layer drafter; a 1-layer drafter with
    the target's embeddings, first block and final LayerNorm, which
    agrees with the target on some drafts and not on others; and the
    target's twin."""
    target = _pair(23, 2)
    return {"target": target, "draft": _pair(5, 1),
            "truncated": _pair(5, 1, weights_of=target[0]),
            "twin": _pair(23, 2)}


@pytest.fixture(scope="module")
def jax_spec(models):
    """The reference's spec engine, built once: it compiles its draft scan
    and its verify once per engine."""
    return JaxSpec(models["target"][0], models["truncated"][0], draft_k=3,
                   paged_kernel="pallas", **EKW)


def _spec(models, drafter="draft", **kw):
    return DraftVerifyEngine(models["target"][1], models[drafter][1],
                             device="cpu", **{**EKW, "draft_k": 3, **kw})


def _plain(models, **kw):
    return GenerationEngine(models["target"][1], device="cpu",
                            **dict(EKW, **kw))


def _run_plain(eng, prompt, n, **kw):
    out = [eng.prefill(0, prompt, **kw)]
    while len(out) < n and eng.slot_len(0) < eng.max_seq_len:
        out.append(int(eng.decode_step()[0]))
    eng.release(0)
    return out[:n]


def _run_spec(eng, prompt, n, **kw):
    out = [eng.prefill(0, prompt, **kw)]
    while len(out) < n and eng.slot_len(0) < eng.max_seq_len:
        out.extend(eng.decode_step_spec()[0])
    eng.release(0)
    return out[:n]


def _audit(eng):
    eng.pool.audit()
    eng.draft_pool.audit()


def test_greedy_rounds_and_accepts_equal_reference(models, jax_spec):
    teng = _spec(models, drafter="truncated")
    assert teng.paged_kernel == "torch" and jax_spec.paged_kernel == \
        "interpret"  # the reference's Pallas body on the CPU
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, VOCAB, n)] for n in (7, 13)]
    rounds, accepted = [], []
    for eng, reg in ((jax_spec, jregistry), (teng, registry)):
        a0 = reg.counters("serving")["spec_accepted"]
        log = [eng.prefill(0, prompts[0], seed=0)]
        for r in range(10):
            if r == 3:  # an admission mid-flight
                log.append(eng.prefill(1, prompts[1], seed=1))
            log.append(eng.decode_step_spec())
        eng.release(0)
        eng.release(1)
        rounds.append(log)
        accepted.append(reg.counters("serving")["spec_accepted"] - a0)
    assert rounds[1] == rounds[0]
    assert accepted[1] == accepted[0]
    # some drafts accepted, some rejected: both branches compared
    emitted = [len(x) for r in rounds[1] if isinstance(r, list) for x in r
               if x]
    assert accepted[1] > 0 and min(emitted) == 1
    _audit(teng)


@pytest.mark.parametrize("opts", [dict(seed=3),
                                  dict(seed=42, temperature=0.9, top_k=30),
                                  dict(seed=7, temperature=0.7, top_p=0.8)],
                         ids=["greedy", "top_k", "top_p"])
def test_spec_equals_plain_decode(models, opts):
    spec, plain = _spec(models), _plain(models)
    rng = np.random.default_rng(1)
    for n in (6, 19):  # one prompt per bucket
        prompt = [int(t) for t in rng.integers(1, VOCAB, n)]
        assert _run_spec(spec, prompt, 14, **opts) == \
            _run_plain(plain, prompt, 14, **opts)
    # rejected drafts rolled back without leaking a block
    _audit(spec)


def test_twin_drafter_accepts_everything(models):
    spec, plain = _spec(models, drafter="twin"), _plain(models)
    prompt = [3, 14, 15, 9, 2, 6]
    c0 = registry.counters("serving")
    opts = dict(temperature=0.8, seed=7)
    assert _run_spec(spec, prompt, 13, **opts) == \
        _run_plain(plain, prompt, 13, **opts)
    c1 = registry.counters("serving")
    proposed = c1["spec_proposed"] - c0["spec_proposed"]
    assert proposed > 0
    assert c1["spec_accepted"] - c0["spec_accepted"] == proposed
    rounds = c1["spec_slot_rounds"] - c0["spec_slot_rounds"]
    assert c1["spec_emitted"] - c0["spec_emitted"] == rounds * 4


def test_interleaved_spec_server_matches_plain_server(models):
    plain = GenerationServer(engine=_plain(models, max_batch_size=3))
    spec = GenerationServer(engine=_spec(models, max_batch_size=3))
    rng = np.random.default_rng(6)
    prompts = [[int(t) for t in rng.integers(1, VOCAB, n)]
               for n in (5, 11, 7, 13, 6)]
    budgets = [6, 9, 4, 7, 11]
    opts = [dict(max_new_tokens=b, seed=200 + i,
                 temperature=0.9 if i % 2 else 0.0)
            for i, b in enumerate(budgets)]
    try:
        want = [plain.generate(p, result_timeout=60, **o)
                for p, o in zip(prompts, opts)]
        reqs = [spec.submit(p, **o) for p, o in zip(prompts, opts)]
        got = [r.result(60).tokens for r in reqs]
    finally:
        assert plain.shutdown(timeout=60) and spec.shutdown(timeout=60)
    assert got == want
    assert all(r.status == "done" for r in reqs)
    _audit(spec.engine)
    assert spec.engine.draft_pool.in_use() == 0


def test_chunked_spec_reserves_draft_blocks_up_front(models):
    eng = _spec(models, draft_k=2, buckets=(8, 32), block_size=4,
                draft_num_blocks=9)
    sched = ContinuousBatchScheduler(eng, prefill_chunk_tokens=8)
    rng = np.random.default_rng(11)
    # 7 of the 8 usable drafter blocks go to the first request
    r1 = sched.submit(GenerationRequest(
        [int(t) for t in rng.integers(1, VOCAB, 5)], max_new_tokens=20,
        seed=1))
    sched.step()
    assert r1.status == "running" and eng.draft_pool.in_use() == 7
    # the long prompt needs 8 drafter blocks: backpressure, not an error
    p0 = registry.counters("serving")["pool_exhausted"]
    r2 = sched.submit(GenerationRequest(
        [int(t) for t in rng.integers(1, VOCAB, 25)], max_new_tokens=4,
        seed=2))
    sched.step()
    assert r2.status == "queued"
    assert registry.counters("serving")["pool_exhausted"] > p0
    while not r1.done:
        sched.step()
    sched.step()  # chunk-admits r2: its drafter budget is reserved now
    assert r2.status == "running" and len(sched._prefilling) == 1
    assert eng.draft_pool.in_use() == 8
    while not r2.done:
        sched.step()
    assert r2.status == "done" and len(r2.tokens) == 4
    _audit(eng)
    assert eng.draft_pool.in_use() == 0


@pytest.mark.parametrize("stop", ["eos", "max_tokens"])
def test_scheduler_stops_inside_a_round(models, stop):
    """A twin drafter makes every round emit K+1 = 4 tokens, so both stops
    land inside a round; the tokens after them are dropped."""
    prompt = [7, 1, 4, 4, 9]
    want = _run_plain(_plain(models), prompt, 12, seed=4)
    if stop == "eos":
        # a token that first appears inside a round (token 0 comes from
        # the prefill, tokens 4r+1..4r+4 from round r)
        cut = next(i for i in range(2, 12)
                   if want[i] not in want[:i] and i % 4) + 1
        eos = want[cut - 1]
        req = GenerationRequest(prompt, max_new_tokens=12, eos_id=eos,
                                seed=4)
    else:
        cut = 7
        req = GenerationRequest(prompt, max_new_tokens=cut, seed=4)
    eng = _spec(models, drafter="twin")
    sched = ContinuousBatchScheduler(eng)
    sched.submit(req)
    assert sched.drain()
    assert req.tokens == want[:cut] and req.stop_reason == stop
    _audit(eng)


# max_seq_len 64 = 4 blocks of 16: with K = 4, a slot's verify spans reach
# past row 63 in its last rounds
CEILING = dict(max_seq_len=64, block_size=16, buckets=(16, 32, 64))


def _ceiling_prompts():
    rng = np.random.default_rng(8)
    return [[int(t) for t in rng.integers(1, VOCAB, 40)] for _ in range(3)]


def _write_rows_without_table_bound(cache_offsets, seq_lens, block_tables,
                                    block_size, T):
    """``paged_write_rows`` by the reference's rule
    (``paddle_tpu/models/gpt.py:175-181``): the logical block clamps to
    ``M - 1`` and every row below ``seq_lens`` is written."""
    M = block_tables.shape[1]
    rows = cache_offsets.long().unsqueeze(1) + torch.arange(T)
    phys = block_tables.long().gather(
        1, (rows // block_size).clamp(max=M - 1))
    flat = torch.where(rows < seq_lens.long().unsqueeze(-1),
                       phys * block_size + rows % block_size,
                       torch.zeros_like(rows))
    return flat.reshape(-1)


def test_ceiling_spec_equals_plain_decode(models):
    """Verify spans that reach past row 63 must not write over the slot's
    live rows (the reference's do: its rows past the table wrap into the
    slot's last block)."""
    spec = _spec(models, draft_k=4, **CEILING)
    plain = _plain(models, **CEILING)
    for seed, prompt in enumerate(_ceiling_prompts()):
        want = _run_plain(plain, prompt, 64, seed=seed)
        assert len(want) == 25  # ran to the ceiling
        assert _run_spec(spec, prompt, 64, seed=seed) == want
    _audit(spec)
    # through the scheduler: the length stop per token, at the ceiling
    sched = ContinuousBatchScheduler(spec)
    req = sched.submit(GenerationRequest(prompt, max_new_tokens=60, seed=2))
    assert sched.drain()
    assert req.tokens == want and req.stop_reason == "length"
    _audit(spec)


def test_ceiling_differs_without_the_table_bound_on_writes(models,
                                                          monkeypatch):
    """The ceiling runs above with the reference's write rule: some differ
    from plain decode, so the port's bound is what keeps them equal."""
    plain = _plain(models, **CEILING)
    prompts = _ceiling_prompts()
    want = [_run_plain(plain, p, 64, seed=s) for s, p in enumerate(prompts)]
    monkeypatch.setattr(tgpt, "paged_write_rows",
                        _write_rows_without_table_bound)
    spec = _spec(models, draft_k=4, **CEILING)
    got = [_run_spec(spec, p, 64, seed=s) for s, p in enumerate(prompts)]
    assert got != want
    assert all(len(g) == 25 for g in got)


def test_reference_verify_at_the_ceiling_differs_from_its_plain_decode(
        models):
    """Documents a fault of the reference that the port does not copy
    (ROADMAP queue 3): ``paddle_tpu``'s spec engine, on the ceiling runs
    above, emits tokens its own plain decode does not, while its plain
    decode gives the port's tokens."""
    from paddle_tpu.serving import GenerationEngine as JaxEngine

    kw = {**EKW, **CEILING, "paged_kernel": "xla"}
    ref_spec = JaxSpec(models["target"][0], models["draft"][0], draft_k=4,
                       **kw)
    ref_plain = JaxEngine(models["target"][0], **kw)
    port_plain = _plain(models, **CEILING)
    differ = 0
    for seed, prompt in enumerate(_ceiling_prompts()):
        want = _run_plain(ref_plain, prompt, 64, seed=seed)
        assert want == _run_plain(port_plain, prompt, 64, seed=seed)
        differ += _run_spec(ref_spec, prompt, 64, seed=seed) != want
    assert differ


@pytest.mark.parametrize("k", [0, 8])
def test_draft_k_outside_the_kernel_span_raises(models, k):
    with pytest.raises(ValueError, match="draft_k"):
        _spec(models, draft_k=k)


def test_drafter_must_match_vocab_and_positions(models):
    other = tgpt.GPTForPretraining(tgpt.GPTModel(tgpt.GPTConfig.preset(
        "gpt2-tiny", vocab_size=VOCAB + 1, n_layer=1), device="cpu"))
    with pytest.raises(ValueError, match="vocab"):
        DraftVerifyEngine(models["target"][1], other, device="cpu", **EKW)
    short = tgpt.GPTForPretraining(tgpt.GPTModel(tgpt.GPTConfig.preset(
        "gpt2-tiny", vocab_size=VOCAB, n_layer=1, seq_len=64),
        device="cpu"))
    with pytest.raises(ValueError, match="position range"):
        DraftVerifyEngine(models["target"][1], short, device="cpu", **EKW)


def test_server_serves_through_the_drafter(models):
    srv = GenerationServer(models["target"][1],
                           draft_model=models["twin"][1], draft_k=3,
                           max_batch_size=2, buckets=(16, 32),
                           block_size=8, device="cpu")
    assert isinstance(srv.engine, DraftVerifyEngine)
    r0 = registry.counters("serving")["spec_rounds"]
    try:
        toks = srv.generate([1, 2, 3, 4], max_new_tokens=9,
                            result_timeout=60)
    finally:
        assert srv.shutdown(timeout=60)
    assert len(toks) == 9 and all(0 <= t < VOCAB for t in toks)
    # a twin drafter: 1 + 4 + 4 tokens in two rounds
    assert registry.counters("serving")["spec_rounds"] - r0 == 2
    _audit(srv.engine)
