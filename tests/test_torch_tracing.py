"""The port's request traces, flight recorder, latency histograms and host
timeline against the JAX package's (``paddle_tpu/profiler/{tracing,
registry,timeline}.py``): the same inputs must give the same ids, buckets,
quantiles and documents, and a file written by either package must load in
the other. Then the spans of one served request, port against reference
(``gpt2-tiny``, vocab 96, float32, weights carried by ``convert``).
"""
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu.profiler import registry as jregistry  # noqa: E402
from paddle_tpu.profiler import timeline as jtimeline  # noqa: E402
from paddle_tpu.profiler import tracing as jtracing  # noqa: E402
from paddle_tpu.serving import ContinuousBatchScheduler as JaxSched  # noqa
from paddle_tpu.serving import GenerationEngine as JaxEngine  # noqa: E402
from paddle_tpu.serving import GenerationRequest as JaxRequest  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.profiler import registry, timeline, tracing  # noqa
from paddle_tpu_torch.serving import (ContinuousBatchScheduler,  # noqa: E402
                                      GenerationEngine, GenerationRequest)

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

VOCAB = 96
EKW = dict(max_batch_size=2, buckets=(16, 32), block_size=8, rng_seed=7)


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1, 2**40 + 3])
def test_trace_ids_equal_the_reference(seed):
    got = tracing.trace_id_for_seed(seed)
    assert got == jtracing.trace_id_for_seed(seed)
    assert len(got) == 16 and int(got, 16) >= 0


# durations in seconds: below the first bucket's edge, zero, exact powers
# of two (bucket edges), ordinary latencies, and past the last bucket
OBSERVATIONS = [0.0, 1e-9, 2.0 ** -20, 2.0 ** -19 + 1e-12, 3e-4, 0.0125,
                0.0125, 0.5, 1.0, 2.0, 7.3, 2.0 ** 25]


@pytest.mark.parametrize("split", [0, 5, len(OBSERVATIONS)])
def test_histograms_equal_the_reference(split):
    """Buckets, count, quantiles and merges of the same observations;
    ``split`` of them go to one histogram, the rest to a second, and the
    merge of the two equals the histogram of all."""
    scope = f"test_torch_tracing_{split}"
    for reg in (registry, jregistry):
        reg.reset(scope)
        for v in OBSERVATIONS[:split]:
            reg.hist_record("a", v, scope=scope)
        for v in OBSERVATIONS[split:]:
            reg.hist_record("b", v, scope=scope)
        for v in OBSERVATIONS:
            reg.hist_record("all", v, scope=scope)
    got, want = registry.histograms(scope), jregistry.histograms(scope)
    assert got == want
    merged = registry.hist_merge(dict(got.get(f"{scope}.a", {})),
                                 got.get(f"{scope}.b", {}))
    jmerged = jregistry.hist_merge(dict(want.get(f"{scope}.a", {})),
                                   want.get(f"{scope}.b", {}))
    assert merged == jmerged
    for k in ("count", "buckets", "p50_ms", "p99_ms"):
        assert merged[k] == got[f"{scope}.all"][k]
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert registry.hist_quantile_ms(merged, q) == \
            jregistry.hist_quantile_ms(jmerged, q)
    assert [registry.hist_bucket_upper_ms(i) for i in range(44)] == \
        [jregistry.hist_bucket_upper_ms(i) for i in range(44)]
    assert (registry.HIST_EMIN, registry.HIST_NBUCKETS) == \
        (jregistry.HIST_EMIN, jregistry.HIST_NBUCKETS)


def test_reset_zeroes_histograms_in_place():
    scope = "test_torch_tracing_reset"
    registry.hist_record("x", 0.25, scope=scope)
    rec = registry._hist_scopes[scope]["x"]
    registry.reset(scope)
    assert registry._hist_scopes[scope]["x"] is rec
    assert rec[0] == 0 and not any(rec[2])
    assert registry.histograms(scope) == {}
    registry.hist_record("x", 0.25, scope=scope)
    assert registry.histograms(scope)[f"{scope}.x"]["count"] == 1
    assert set(registry.snapshot()) == set(jregistry.snapshot())


def test_chrome_traces_equal_the_reference(tmp_path):
    spans = [["a" * 16, "prefill", 1, 10.0, 10.5],
             ["a" * 16, "kv_export", 1, 10.5, 10.51, {"bytes": 4096}],
             ["", "decode_iter", 2, 11.0, 11.002],
             ["b" * 16, "decode", 1, 11.0, 12.25]]
    docs = []
    for mod in (tracing, jtracing):
        col = mod.FleetTraceCollector()
        col.add_spans("pod0", spans[:2], pid=101, offset=0.5)
        col.add_spans("router", spans[2:], pid=100)
        col.set_process("pod0", offset=-0.25)
        docs.append((col.to_chrome_trace(), col.traces(), col.span_count(),
                     col.to_chrome_trace(meta={"run": 1})["paddle_tpu"]))
    assert docs[0][:3] == docs[1][:3]
    # the reference's event loop rebinds ``meta`` to each span's own, so a
    # document's metadata is lost once it has a span; the port keeps it
    offsets = {"clock_offsets": {"pod0": -0.25, "router": 0.0}}
    assert docs[0][3] == dict(offsets, run=1)
    assert docs[1][3] == offsets
    col = tracing.FleetTraceCollector()
    col.add_spans("pod0", spans, pid=101)
    path = col.write(str(tmp_path / "trace.json"))
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(col.to_chrome_trace()))
    host = [("step", 1, 0.5, 0.75), ("sync", 2, 0.75, 0.8)]
    assert timeline.to_chrome_trace(host, meta={"k": 1}) == \
        jtimeline.to_chrome_trace(host, meta={"k": 1})
    timeline.start()
    timeline.add_span("x", 1.0, 2.0, tid=3)
    assert timeline.stop() == [("x", 3, 1.0, 2.0)]
    timeline.add_span("y", 1.0, 2.0)  # outside a window: dropped
    assert timeline.stop() == []
    assert tracing.offset_from_exchange(1.0, 3.0, 10.0) == \
        jtracing.offset_from_exchange(1.0, 3.0, 10.0)


def test_flight_dumps_load_across_packages(tmp_path):
    try:
        tracing.flight_clear()
        tracing.flight("submit", rid=1, trace_id="c" * 16, prompt_len=5)
        tracing.flight("fatal", error="boom")
        port = tracing.dump_flight_recorder(
            reason="test", path=str(tmp_path / "port.json"))
        doc = jtracing.load_flight_dump(port)
        assert doc["reason"] == "test"
        assert [e["event"] for e in doc["events"]] == ["submit", "fatal"]
        assert doc["events"][0]["trace_id"] == "c" * 16
        jtracing.flight_clear()
        jtracing.flight("admit", rid=2, slot=0)
        ref = jtracing.dump_flight_recorder(
            reason="ref", path=str(tmp_path / "ref.json"))
        jdoc = tracing.load_flight_dump(ref)
        assert jdoc["events"][0] == {"t": jdoc["events"][0]["t"],
                                     "event": "admit", "rid": 2,
                                     "detail": {"slot": 0}}
        (tmp_path / "bad.json").write_text('{"schema": "other"}')
        with pytest.raises(ValueError, match="not a flight"):
            tracing.load_flight_dump(str(tmp_path / "bad.json"))
    finally:
        tracing.flight_clear()
        jtracing.flight_clear()


@pytest.fixture(scope="module")
def models():
    rng_state = paddle.get_rng_state()
    try:
        paddle.seed(21)
        jm = jgpt.GPTForPretraining(jgpt.GPTModel(jgpt.GPTConfig.preset(
            "gpt2-tiny", vocab_size=VOCAB, initializer_range=0.35)))
    finally:
        paddle.set_rng_state(rng_state)
    tm = tgpt.GPTForPretraining(tgpt.GPTModel(tgpt.GPTConfig.preset(
        "gpt2-tiny", vocab_size=VOCAB, initializer_range=0.35),
        device="cpu"))
    convert.load_paddle_tpu_state(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return jm, tm


def _served_spans(mod, sched_cls, req_cls, prefill_eng, decode_eng,
                  handoff):
    """Serve one request (seed 5) with tracing on; returns its trace id
    and the names of its spans in order, and the untraced span names."""
    prompt = list(range(3, 22))
    mod.drain_spans()
    # the default ring: an earlier test in this process may have left a
    # smaller one (tests/test_tracing.py enables the reference's with
    # capacity=4), which would drop this request's later spans
    mod.enable(capacity=8192)
    try:
        req = req_cls(prompt, max_new_tokens=4, seed=5)
        if handoff:
            prefill_eng.prefill(0, prompt, seed=5, max_new_tokens=4)
            req.kv_payload = prefill_eng.export_request_kv(0)
            prefill_eng.release(0)
        sched = sched_cls(decode_eng)
        sched.submit(req)
        while sched.step():
            pass
        spans = mod.drain_spans()
    finally:
        mod.disable()
        mod.drain_spans()
    assert req.status == "done"
    mine = [s[1] for s in sorted(spans, key=lambda s: s[3])
            if s[0] == req.trace_id]
    other = {s[1] for s in spans if s[0] != req.trace_id}
    return req.trace_id, mine, other, req.tokens


@pytest.mark.parametrize("handoff", [False, True],
                         ids=["monolithic", "handoff"])
def test_served_request_spans_equal_the_reference(models, handoff):
    jm, tm = models
    want = _served_spans(jtracing, JaxSched, JaxRequest,
                         JaxEngine(jm, **EKW), JaxEngine(jm, **EKW), handoff)
    got = _served_spans(tracing, ContinuousBatchScheduler, GenerationRequest,
                        GenerationEngine(tm, device="cpu", **EKW),
                        GenerationEngine(tm, device="cpu", **EKW), handoff)
    assert got[0] == want[0] == tracing.trace_id_for_seed(5)
    assert got[1:] == want[1:]
    names = {"prefill", "kv_export", "queue_wait", "kv_import", "kv_adopt",
             "decode"} if handoff else {"queue_wait", "prefill", "admit",
                                        "decode"}
    assert set(got[1]) == names
    assert got[2] == {"decode_iter"}
