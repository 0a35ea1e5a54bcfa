"""An MoE GPT through the port's serving stack, against the JAX package's.

Model: ``gpt2-tiny-moe`` (2 layers, both MoE, 4 experts, top-2, capacity
factor 1.25) with vocab 96 and initializer_range 0.35, float32, the JAX
model's weights carried into the port by ``convert``. Greedy tokens of the
two engines must be bitwise equal: the reference decodes through its
Pallas kernel body in one test (``paged_kernel="pallas"`` runs the
interpreter on the CPU) and through XLA elsewhere, the port through the
plain version of its CUDA kernel. A zeroed gate weight makes every row
pick experts 0 and 1 (uniform probabilities, first index on ties), which
crowds them and forces drops; the tests use it where a drop must happen.

Routing groups: a decode step routes each slot's one row as its own group;
a prefill routes its bucket-padded window as one group (the reference's
rule, which the port copies: ROADMAP "Known divergences"); the port's
spec verify routes each of its rows as its own group, the reference's
routes a slot's K+1 rows as one (ROADMAP queue 3).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu.serving import DraftVerifyEngine as JaxSpec  # noqa: E402
from paddle_tpu.serving import GenerationEngine as JaxEngine  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.nn import moe as tmoe  # noqa: E402
from paddle_tpu_torch.nn.moe import layer as tmoe_layer  # noqa: E402
from paddle_tpu_torch.profiler import registry  # noqa: E402
from paddle_tpu_torch.serving import (ContinuousBatchScheduler,  # noqa: E402
                                      DraftVerifyEngine, GenerationEngine,
                                      GenerationRequest)

VOCAB = 96
EKW = dict(max_batch_size=2, buckets=(16, 32), rng_seed=9, block_size=8)
CFG = dict(vocab_size=VOCAB, initializer_range=0.35)


@pytest.fixture(scope="module", autouse=True)
def _single_device_reference():
    """The reference's MoEMLP places its banks on whatever layout mesh is
    installed (``fleet.init`` or ``spmd.enable`` by an earlier test in this
    process); these tests hold the port against the single-device
    reference, so both are cleared for the module and put back after."""
    from paddle_tpu.distributed import fleet, spmd

    mesh = spmd.current_mesh()
    spmd.disable()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(fleet._fleet_state, "hcg", None)
        yield
    if mesh is not None:
        spmd.enable(mesh)


def _pair(seed, zero_gate=False, n_layer=2):
    """A JAX gpt2-tiny-moe from ``seed`` and the port's copy of it; with
    ``zero_gate`` every gate weight is zero in both."""
    state = paddle.get_rng_state()
    try:
        paddle.seed(seed)
        jm = jgpt.GPTForPretraining(jgpt.GPTModel(jgpt.GPTConfig.preset(
            "gpt2-tiny-moe", n_layer=n_layer, **CFG)))
    finally:
        paddle.set_rng_state(state)
    if zero_gate:
        for blk in jm.gpt.blocks:
            blk.mlp.gate.weight.set_value(
                np.zeros(blk.mlp.gate.weight.shape, np.float32))
    np_state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tgpt.GPTForPretraining(tgpt.GPTModel(tgpt.GPTConfig.preset(
        "gpt2-tiny-moe", n_layer=n_layer, **CFG), device="cpu"))
    return jm, convert.load_paddle_tpu_state(tm, np_state)


@pytest.fixture(scope="module")
def models():
    return {"A": _pair(31), "B": _pair(32), "zero": _pair(31, True),
            "draft": _pair(5, n_layer=1)}


def _engine(tm, **kw):
    return GenerationEngine(tm, device="cpu", **dict(EKW, **kw))


def _run(eng, prompt, n, slot=0, **kw):
    out = [eng.prefill(slot, prompt, **kw)]
    step = getattr(eng, "decode_step_spec", None)
    while len(out) < n:
        out.extend(step()[slot] if step else [int(eng.decode_step()[slot])])
    eng.release(slot)
    return out[:n]


def _chunked(eng, prompt, n, chunk, **kw):
    eng.begin_prefill(0, prompt, chunk_tokens=chunk, **kw)
    tok = None
    while tok is None:
        tok = eng.prefill_chunk(0)
    out = [tok]
    while len(out) < n:
        out.append(int(eng.decode_step()[0]))
    eng.release(0)
    return out


def test_greedy_tokens_bitwise_equal_to_reference(models):
    jm, tm = models["A"]
    jeng = JaxEngine(jm, paged_kernel="pallas", **EKW)
    assert jeng.paged_kernel == "interpret"  # the Pallas body on the CPU
    teng = _engine(tm)
    rng = np.random.default_rng(5)
    # under, on and over a block (8) and a bucket (16) edge, and one
    # chunked prefill (chunks of 8 rows routed chunk by chunk, in both)
    for i, n in enumerate((15, 16, 17)):
        prompt = [int(t) for t in rng.integers(1, VOCAB, n)]
        want = _run(jeng, prompt, 8, seed=i)
        got = _run(teng, prompt, 8, seed=i)
        assert got == want, (n, got, want)
        assert len(set(got)) > 1
    prompt = [int(t) for t in rng.integers(1, VOCAB, 21)]
    assert _chunked(teng, prompt, 6, 8, seed=7) == \
        _chunked(jeng, prompt, 6, 8, seed=7)
    teng.pool.audit()


def test_prefill_depends_on_its_bucket_in_both_packages(models):
    # Known divergence of the reference's semantics, copied by the port:
    # the gate's capacity follows the bucket-padded length, and padding
    # rows route too. Under a zeroed gate 11 real rows of a 16-row bucket
    # get C = 10 slots on expert 0 (row 10 is dropped), of a 32-row bucket
    # C = 20 (none is): the second layer's K/V differ between buckets,
    # the first's (before any MoE block) do not, in both packages alike
    jm, tm = models["zero"]
    prompt = [int(t) for t in np.random.default_rng(2).integers(1, VOCAB,
                                                                 11)]
    kv = {}
    for pkg, make in (("ref", lambda b: JaxEngine(
            jm, paged_kernel="xla", **dict(EKW, buckets=b))),
                      ("port", lambda b: _engine(tm, buckets=b))):
        for b in ((16,), (32,)):
            eng = make(b)
            eng.prefill(0, prompt, seed=0, max_new_tokens=2)
            pay = eng.export_request_kv(0)
            kv[pkg, b[0]] = [np.asarray(pay[k][li], np.float32)[
                :2].reshape(16, -1)[:11] for li in (0, 1)
                for k in ("kv_k", "kv_v")]
    for pkg in ("ref", "port"):
        a, b = kv[pkg, 16], kv[pkg, 32]
        np.testing.assert_array_equal(a[0], b[0])  # layer 0 K
        assert not np.allclose(a[2], b[2], atol=1e-4)  # layer 1 K
        assert np.allclose(a[2][:10], b[2][:10], atol=1e-5)  # row 10 only
    for b in (16, 32):
        for x, y in zip(kv["port", b], kv["ref", b]):
            # float32 summed in another order through a 0.35-std model
            np.testing.assert_allclose(x, y, atol=1e-4, rtol=1e-4)


def test_mid_flight_swap_of_an_moe_engine(models):
    _, ta = models["A"]
    jb, tb = models["B"]
    swapped = tgpt.GPTForPretraining(tgpt.GPTModel(tgpt.GPTConfig.preset(
        "gpt2-tiny-moe", **CFG), device="cpu"))
    swapped.load_state_dict(ta.state_dict())
    eng = _engine(swapped)
    sched = ContinuousBatchScheduler(eng)
    req = sched.submit(GenerationRequest([3, 1, 4, 1, 5, 9, 2, 6],
                                         max_new_tokens=10, seed=0))
    for _ in range(4):
        sched.step()
    # the reference's layout: numpy, Linear weights [in, out], 3-D banks
    # as they are
    sched.request_swap({k: np.asarray(v.numpy())
                        for k, v in jb.state_dict().items()})
    assert sched.drain()
    assert req.status == "done" and len(req.tokens) == 10
    for name, p in swapped.state_dict().items():
        assert torch.equal(p, tb.state_dict()[name]), name
    prompt = [7, 7, 1, 2, 8, 3]
    assert _run(eng, prompt, 8, seed=3) == _run(_engine(tb), prompt, 8,
                                                 seed=3)
    eng.pool.audit()


@pytest.mark.parametrize("opts", [dict(seed=4),
                                  dict(seed=5, temperature=0.8, top_p=0.9)],
                         ids=["greedy", "sampled"])
def test_handoff_of_an_moe_request(models, opts):
    _, tm = models["A"]
    prompt = [int(t) for t in np.random.default_rng(8).integers(1, VOCAB,
                                                                 19)]
    want = _run(_engine(tm), prompt, 8, **opts)
    a, b = _engine(tm), _engine(tm, rng_seed=99)
    first = a.prefill(0, prompt, max_new_tokens=8, **opts)
    payload = a.export_request_kv(0)
    a.release(0)
    assert b.import_request_kv(1, payload, prompt_ids=prompt) == first
    got = [first] + [int(b.decode_step()[1]) for _ in range(7)]
    assert got == want
    b.release(1)
    b.pool.audit()


@pytest.mark.parametrize("gate", ["random", "zero"])
def test_spec_tokens_equal_plain_decode(models, gate):
    key = "A" if gate == "random" else "zero"
    jm, tm = models[key]
    twin = _pair(31, zero_gate=gate == "zero")[1]
    prompt = [int(t) for t in np.random.default_rng(1).integers(1, VOCAB,
                                                                 13)]
    for drafter in (twin, models["draft"][1]):
        for opts in (dict(seed=2), dict(seed=6, temperature=0.8,
                                        top_p=0.9)):
            eng = DraftVerifyEngine(tm, drafter, device="cpu",
                                    **dict(EKW, draft_k=3))
            a0 = registry.counters("serving")["spec_accepted"]
            got = _run(eng, prompt, 16, **opts)
            assert got == _run(_engine(tm), prompt, 16, **opts), \
                (gate, opts)
            if drafter is twin and "temperature" not in opts:
                # every draft of the twin is accepted: each round verifies
                # a full span, the case the reference gets wrong (below)
                assert registry.counters("serving")["spec_accepted"] \
                    - a0 >= 12
            eng.pool.audit()
            eng.draft_pool.audit()


def test_reference_moe_verify_drops_rows_plain_decode_keeps(models):
    # Reference fault (ROADMAP queue 3): its verify routes a slot's K+1
    # rows as one group, capacity ceil(4 * 1.25 * 2 / 4) = 3 at K=3, so
    # under a zeroed gate the span's last row loses both its expert slots
    # and its sample differs from plain decode's; the port's verify
    # routes each row alone and keeps plain decode's tokens
    jm, tm = models["zero"]
    jtwin, ttwin = _pair(31, zero_gate=True)
    prompt = [int(t) for t in np.random.default_rng(1).integers(1, VOCAB,
                                                                 13)]
    ref_plain = _run(JaxEngine(jm, paged_kernel="xla", **EKW), prompt, 12,
                     seed=2)
    ref_spec = _run(JaxSpec(jm, jtwin, draft_k=3, paged_kernel="xla",
                            **EKW), prompt, 12, seed=2)
    assert ref_spec != ref_plain
    port_spec = _run(DraftVerifyEngine(tm, ttwin,
                                       device="cpu",
                                       **dict(EKW, draft_k=3)),
                     prompt, 12, seed=2)
    assert port_spec == _run(_engine(tm), prompt, 12, seed=2) == ref_plain


def test_collect_on_a_served_model_reads_no_graph_memory(models,
                                                          monkeypatch):
    # a forward under CUDA-graph capture leaves the layers' stats alone:
    # on the card they would point into the graph pool, which other
    # graphs' replays overwrite. Rehearsed here by declaring every
    # forward of one decode step a capture.
    _, tm = models["A"]
    eng = _engine(tm)
    eng.prefill(0, [5, 3, 2, 8, 1], seed=0)
    eng.decode_step()
    layers = [m for m in tm.modules() if isinstance(m, tmoe.MoEMLP)]
    before = [(m.aux_loss, m.last_stats) for m in layers]
    snap = tmoe.metrics.collect(tm)
    assert snap["total"] == 2 * 2 * 2  # 2 layers x 2 slots x top-2
    monkeypatch.setattr(tmoe_layer, "_capturing", lambda x: True)
    eng.decode_step()
    assert all(m.aux_loss is a and m.last_stats is s
               for m, (a, s) in zip(layers, before))
    again = tmoe.metrics.collect(tm)
    np.testing.assert_array_equal(again["expert_tokens"],
                                  snap["expert_tokens"])
    eng.release(0)
