"""The port's decode fast path against the JAX package's, and its state
machine: persistent device slot state, a rebuild from the host mirrors at
each batch boundary, fast steps in between, audits at their cadence and a
demotion when the device state diverges (the reference's
``tests/test_serving.py`` fast-path tests, without the weight swap).

On the CPU the step body runs directly on the same buffers the CUDA graph
replays on the card, so the whole state machine runs here. Model:
``gpt2-tiny`` with vocab 96 and initializer_range 0.35, float32, the JAX
model's weights carried into the port by ``convert``. Greedy tokens must
equal the reference's bitwise; decode logits are held to the reference's
cache-less forward within ``tests/test_torch_gpt.py``'s tolerance (1e-4,
float32 reduction order through two layers and the LM head).
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
from paddle_tpu_torch.profiler import explainer, registry  # noqa: E402
from paddle_tpu_torch.serving import (GenerationEngine,  # noqa: E402
                                      GenerationServer, RequestStatus)

VOCAB = 96
EKW = dict(max_batch_size=2, buckets=(16, 32), rng_seed=9, block_size=8)
TOL = dict(atol=1e-4, rtol=1e-4)
PROMPTS = ([5, 9, 2, 7, 1, 3, 8, 8, 4], [8, 1, 3] * 5)


@pytest.fixture(scope="module")
def models():
    rng_state = paddle.get_rng_state()
    try:
        paddle.seed(23)
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


def _fp():
    return dict(registry.counters("fastpath"))


def _moved(f0):
    return {k: v - f0[k] for k, v in registry.counters("fastpath").items()}


def _two_slots(eng):
    eng.prefill(0, PROMPTS[0], seed=0)
    eng.prefill(1, PROMPTS[1], seed=1, temperature=0.8, top_p=0.9)


def _assert_device_equals_mirrors(eng):
    for buf, host in eng._mirrors():
        assert np.array_equal(buf.numpy(), host), (buf, host)


def test_admissions_then_one_rebuild_then_fast_steps(models):
    eng = _engine(models[1])
    _two_slots(eng)
    assert not eng._fast  # admission is a batch boundary
    f0 = _fp()
    for _ in range(6):
        eng.decode_step()
    moved = _moved(f0)
    assert moved["decode_rebuilds"] == 1
    assert moved["decode_fast_steps"] == 5
    assert moved["decode_audit_runs"] == 0 and moved["decode_demotions"] == 0
    assert eng._fast
    _assert_device_equals_mirrors(eng)
    assert list(eng._cur_lens) == [len(PROMPTS[0]) + 6, len(PROMPTS[1]) + 6]


def test_release_rebuilds_exactly_once(models):
    eng = _engine(models[1])
    _two_slots(eng)
    for _ in range(3):
        eng.decode_step()
    eng.release(1)
    assert not eng._fast
    f0 = _fp()
    for _ in range(4):
        eng.decode_step()
    moved = _moved(f0)
    assert moved["decode_rebuilds"] == 1 and moved["decode_fast_steps"] == 3
    _assert_device_equals_mirrors(eng)
    assert not eng._d_active[1] and not eng._d_tables[1].any()


def test_audit_fires_at_its_cadence(models):
    eng = _engine(models[1])
    eng._audit_every = 4
    _two_slots(eng)
    f0 = _fp()
    for _ in range(13):
        eng.decode_step()
    moved = _moved(f0)
    # the rebuild, then an audit before every fourth step after it
    assert moved["decode_rebuilds"] == 1
    assert moved["decode_audit_runs"] == 3
    assert moved["decode_fast_steps"] == 12
    assert moved["decode_demotions"] == 0


def test_planted_divergence_demotes_once_and_tokens_stay_right(models):
    tm = models[1]
    want, got = _engine(tm), _engine(tm)
    _two_slots(want)
    _two_slots(got)
    for _ in range(4):
        assert np.array_equal(got.decode_step(), want.decode_step())
    # corrupt one device cursor right before the audit's turn: the audit
    # must catch it before the step reads it
    got._d_lens[0] += 3
    got._decode_since_audit = got._audit_every - 1
    n_events = len(explainer.events(kind="fastpath_demoted"))
    f0 = _fp()
    for _ in range(6):
        assert np.array_equal(got.decode_step(), want.decode_step())
    moved = _moved(f0)
    assert moved["decode_demotions"] == 1 and moved["decode_rebuilds"] == 1
    assert moved["decode_audit_runs"] == 1
    assert len(explainer.events(kind="fastpath_demoted")) == n_events + 1
    _assert_device_equals_mirrors(got)


def test_chunked_prefill_end_is_a_batch_boundary(models):
    eng = _engine(models[1])
    eng.prefill(0, PROMPTS[0], seed=0)
    eng.decode_step()
    assert eng.begin_prefill(1, list(range(1, 28)), seed=5,
                             chunk_tokens=8) == 4
    f0 = _fp()
    first = None
    while first is None:  # chunks land between fast steps
        eng.decode_step()
        first = eng.prefill_chunk(1)
    moved = _moved(f0)
    assert moved["decode_rebuilds"] == 0 and moved["decode_fast_steps"] == 4
    assert not eng._fast  # the last chunk installed the slot
    eng.decode_step()
    assert _moved(f0)["decode_rebuilds"] == 1
    assert eng._active.tolist() == [True, True]


def test_greedy_tokens_equal_reference_with_admission_and_release(models):
    jm, tm = models
    jeng = JaxEngine(jm, paged_kernel="pallas", **EKW)
    teng = _engine(tm)
    streams = [[], []]
    for eng, out in zip((jeng, teng), streams):
        out.append(eng.prefill(0, PROMPTS[0], seed=0))
        for step in range(20):
            if step == 5:  # an admission mid-flight
                out.append(eng.prefill(1, PROMPTS[1], seed=1))
            if step == 12:  # and a release
                eng.release(0)
            toks = eng.decode_step()
            out.extend(int(toks[s]) for s in eng.active_slots())
    assert streams[1] == streams[0]
    assert len(set(streams[1])) > 2  # live streams, not a constant token
    teng.pool.audit()


def test_decode_logits_match_reference_forward(models):
    jm, tm = models
    eng = _engine(tm)
    seq = list(PROMPTS[0])
    seq.append(eng.prefill(0, seq, seed=0))
    got = []
    for _ in range(6):
        toks = eng.decode_step()
        assert eng.last_logits is eng._d_logits  # the static output buffer
        assert int(toks[0]) == int(eng.last_logits[0].argmax())
        got.append(eng.last_logits[0].clone())
        seq.append(int(toks[0]))
    # the reference's cache-less forward over the whole sequence: its
    # logits at the position each decode step fed
    want = np.asarray(jm(paddle.to_tensor(
        np.asarray([seq[:-1]], np.int64))).numpy())[0]
    n = len(PROMPTS[0])
    for i, g in enumerate(got):
        torch.testing.assert_close(g, torch.tensor(want[n + i]), **TOL)


def test_no_graph_is_captured_on_the_cpu(models):
    eng = _engine(models[1])
    c0 = registry.counters("serving")["decode_compiles"]
    _two_slots(eng)
    for _ in range(3):
        eng.decode_step()
    assert registry.counters("serving")["decode_compiles"] == c0
    assert not eng._decode_graph.captured


@pytest.mark.parametrize("offset,seq_len,T,want", [
    # a verify span at the ceiling: rows 64 and past leave the table of
    # M = 4 blocks of 16 (the reference would write row 64 over live row
    # 48, in the slot's last block)
    (60, 65, 5, [76, 77, 78, 79, 0]),
    (62, 65, 3, [78, 79, 0]),
    # rows at or past seq_len go to the garbage block as before
    (10, 12, 3, [26, 27, 0])])
def test_paged_write_rows_stop_at_the_table(offset, seq_len, T, want):
    # one slot whose table maps logical block i to physical block i + 1
    tables = torch.arange(1, 5, dtype=torch.int32).unsqueeze(0)
    rows = tgpt.paged_write_rows(torch.tensor([offset], dtype=torch.int32),
                                 torch.tensor([seq_len], dtype=torch.int32),
                                 tables, 16, T)
    assert rows.tolist() == want


def test_server_steady_steps_outnumber_rebuilds(models):
    srv = GenerationServer(models[1], max_batch_size=2, buckets=(16, 32),
                           block_size=8, device="cpu")
    srv.engine._audit_every = 5
    try:
        srv.generate([1, 2, 3], max_new_tokens=2, result_timeout=60)
        f0 = _fp()
        reqs = [srv.submit([3 + i, 4, 5], max_new_tokens=24, seed=i)
                for i in range(2)]
        for r in reqs:
            assert r.result(60).status == RequestStatus.DONE
        moved = _moved(f0)
    finally:
        assert srv.shutdown(timeout=60)
    assert moved["decode_fast_steps"] > moved["decode_rebuilds"], moved
    assert moved["decode_audit_runs"] >= 1
    assert moved["decode_demotions"] == 0
