"""Tensor-parallel serving of the port (``GenerationEngine(mesh=)``,
``DraftVerifyEngine(mesh=)``, ``GenerationServer(mesh=)``,
``spmd.serving_mesh``) against the JAX package's mesh engines
(``tests/test_paged_kv.py::TestMeshShardedDecode``,
``tests/test_paged_kernel.py::TestMeshShardedKernel``).

The port runs one process per mp rank: a world of 2 gloo ranks
(``testing.world.World``, built once for the module) builds the same
engine on each rank from the reference's weights (carried by
``convert``); rank 0 drives it and the other rank follows. The reference
runs in this process on the forced host devices of ``tests/conftest.py``,
on ``paged_kernel="xla"`` except its mesh engine, which runs its kernel
through the Pallas interpreter.

Model: ``gpt2-tiny`` (2 layers, 4 heads, d_model 128, vocab 96,
initializer_range 0.35) in float32. Tolerances: tokens bitwise; the mesh
engine's logits and handoff payload against the port's single-card
engine's within 1e-5 (float32, sums over the ranks in another order), and
against the reference's payload within 1e-4, the bound of the port's
model against the reference's (``tests/test_torch_gpt.py``). Greedy
tokens are held against the reference's; sampled tokens against the
port's single-card engine only, since the two packages draw different
Gumbel noise (ROADMAP queue 3).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from paddle_tpu.distributed import spmd as jspmd  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu.serving import DraftVerifyEngine as JaxSpec  # noqa: E402
from paddle_tpu.serving import GenerationEngine as JaxEngine  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch.distributed import spmd  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.ops import paged_attention as pa  # noqa: E402
from paddle_tpu_torch.profiler import explainer, registry  # noqa: E402
from paddle_tpu_torch.serving import (DraftVerifyEngine,  # noqa: E402
                                      GenerationEngine)
from paddle_tpu_torch.testing.world import World  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

VOCAB = 96
CFG = dict(vocab_size=VOCAB, initializer_range=0.35)
EKW = dict(max_batch_size=2, buckets=(8, 16), rng_seed=13, block_size=4)
SEEDS = {"target": 61, "draft": 74, "moe": 63, "three_heads": 65}
_rng = np.random.default_rng(9)
PROMPTS = [[int(t) for t in _rng.integers(1, VOCAB, n)] for n in (5, 9)]
KWS = [dict(seed=11, temperature=0.0), dict(seed=12, temperature=0.9,
                                             top_k=25)]
HIT = PROMPTS[1][:8] + [2, 3]  # shares two 4-token blocks with PROMPTS[1]
N = 7
TOL = dict(atol=1e-5, rtol=1e-5)
XTOL = dict(atol=1e-4, rtol=1e-4)  # the port's model against the reference
THREE_HEADS = dict(n_head=3, d_model=96)


# --------------------------------------------------------- both packages --
def _run(eng, prompt, n, step=None, slot=0, **kw):
    """Prefill ``prompt`` into ``slot`` and decode to ``n`` tokens."""
    out = [int(eng.prefill(slot, prompt, **kw))]
    while len(out) < n:
        if step is None:
            out.append(int(eng.decode_step()[slot]))
        else:
            out.extend(int(t) for t in step()[slot])
    eng.release(slot)
    return out[:n]


# -------------------------------------------------------- the reference --
def _jax_model(seed, preset="gpt2-tiny", **over):
    state = paddle.get_rng_state()
    try:
        paddle.seed(seed)
        return jgpt.GPTForPretraining(jgpt.GPTModel(
            jgpt.GPTConfig.preset(preset, **dict(CFG, **over))))
    finally:
        paddle.set_rng_state(state)


def _state_of(jm):
    return {n: np.asarray(v.numpy()).copy()
            for n, v in jm.gpt.state_dict().items()}


@pytest.fixture(scope="module")
def states():
    over = {"moe": dict(preset="gpt2-tiny-moe"), "three_heads": THREE_HEADS}
    return {k: _state_of(_jax_model(s, **over.get(k, {})))
            for k, s in SEEDS.items()}


@pytest.fixture(scope="module")
def reference():
    """The reference's greedy tokens (single chip, xla) and its mesh
    engine (mp = 2, the kernel through the interpreter)."""
    single = JaxEngine(_jax_model(SEEDS["target"]), paged_kernel="xla",
                       **EKW)
    greedy = _run(single, PROMPTS[0], N, **KWS[0])
    hit = _run(single, HIT, 5, seed=14)
    single.prefill(0, PROMPTS[1], seed=5, max_new_tokens=8)
    payload = single.export_request_kv(0)
    mesh = jspmd.serving_mesh(2, model=_jax_model(SEEDS["target"]))
    sharded = JaxEngine(_jax_model(SEEDS["target"]), paged_kernel="pallas",
                        mesh=mesh, **EKW)
    return {"greedy": greedy, "hit": hit, "payload": payload,
            "mesh_greedy": _run(sharded, PROMPTS[0], N, **KWS[0]),
            "describe": sharded.describe_sharding()}


def _spec(rec):
    """A pool record's partition spec without trailing Nones: the
    reference reports ``P(None, None, "mp", None)`` either way, depending
    on whether the pool has been through a compiled step yet."""
    spec = list(rec["spec"])
    while spec and spec[-1] is None:
        spec.pop()
    return spec


def _same_pools(got, want):
    assert len(got["kv_pools"]) == len(want["kv_pools"])
    for g, w in zip(got["kv_pools"], want["kv_pools"]):
        assert sorted(g) == sorted(w)
        for key in ("layer", "pool", "shape", "dtype", "bytes"):
            assert g[key] == w[key], key
        assert _spec(g) == _spec(w) == [None, None, "mp"]


def _lint_engine(desc):
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "sharding_lint.py")
    spec = importlib.util.spec_from_file_location("sharding_lint", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.lint_engine(desc, min_bytes=0)


# -------------------------------------------------------------- the port --
def _port_model(state, preset="gpt2-tiny", **over):
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models import gpt

    tm = gpt.GPTForPretraining(gpt.GPTModel(gpt.GPTConfig.preset(
        preset, **dict(CFG, **over)), device="cpu"))
    convert.load_paddle_tpu_state(tm.gpt, state)
    return tm


def _counts():
    from paddle_tpu_torch.profiler import registry

    return {s: dict(registry.counters(s)) for s in ("serving", "fastpath")}


def _moved(c0, c1):
    return {s: {k: v - c0[s].get(k, 0) for k, v in c1[s].items()
                if v != c0[s].get(k, 0)} for s in c1}


def _mesh_rank(make, drive, *args):
    """Rank side: every rank builds ``make(mesh)`` on a 2-rank serving
    mesh; rank 0 runs ``drive(obj, *args)`` and closes, the other rank
    follows. Returns (rank 0: what ``drive`` returned, else the calls
    followed; the counters this rank moved)."""
    from paddle_tpu_torch.distributed import spmd

    mesh = spmd.serving_mesh(2)
    c0 = _counts()
    obj = make(mesh)
    if mesh.rank:
        out = obj.follow()
    else:
        try:
            out = drive(obj, *args)
        finally:
            getattr(obj, "engine", obj).close()
    return out, _moved(c0, _counts())


def _plain_engine(state, **over):
    def make(mesh):
        from paddle_tpu_torch.serving import GenerationEngine

        return GenerationEngine(_port_model(state, **over), device="cpu",
                                mesh=mesh, **EKW)
    return make


def _drive_plain(eng, payload):
    """Rank 0 of the plain mesh engine: the decode cases, a prefix hit,
    logits, the steady fast path, an export and an import."""
    from paddle_tpu_torch.profiler import registry

    out = {"tokens": [_run(eng, p, N, **kw) for p, kw in zip(PROMPTS, KWS)]}
    h0 = registry.counters("serving")["prefix_hits"]
    out["hit"] = _run(eng, HIT, 5, seed=14)
    out["hits"] = registry.counters("serving")["prefix_hits"] - h0
    eng.prefill(0, PROMPTS[0], seed=0)
    out["prefill_logits"] = eng.last_prefill_logits[0].clone().numpy()
    for _ in range(3):
        eng.decode_step()
    out["decode_logits"] = eng.last_logits[0].clone().numpy()
    c0 = _counts()
    for _ in range(2 * eng._audit_every):
        eng.decode_step()
    out["steady"] = _moved(c0, _counts())
    eng.reset()
    eng.pool.audit()
    eng.prefill(0, PROMPTS[1], seed=5, max_new_tokens=8)
    out["payload"] = eng.export_request_kv(0)
    eng.release(0)
    first = eng.import_request_kv(1, payload, prompt_ids=PROMPTS[1])
    toks = [first]
    while len(toks) < 8:
        toks.append(int(eng.decode_step()[1]))
    eng.release(1)
    out["imported"] = toks
    out["describe"] = eng.describe_sharding()
    out["stats"] = eng.stats()
    eng.pool.audit()
    return out


def _single(state, **over):
    return GenerationEngine(_port_model(state, **over), device="cpu", **EKW)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(2, tmp_path_factory.mktemp("mesh_world"), timeout=60)
    yield w
    w.close()


@pytest.fixture(scope="module")
def single(states):
    """The port's single-card engine: tokens, logits and the payload the
    mesh engine imports."""
    eng = _single(states["target"])
    out = {"tokens": [_run(eng, p, N, **kw) for p, kw in zip(PROMPTS, KWS)],
           "hit": _run(_single(states["target"]), HIT, 5, seed=14)}
    eng.prefill(0, PROMPTS[0], seed=0)
    out["prefill_logits"] = eng.last_prefill_logits[0].clone().numpy()
    for _ in range(3):
        eng.decode_step()
    out["decode_logits"] = eng.last_logits[0].clone().numpy()
    eng.reset()
    eng.prefill(0, PROMPTS[1], seed=5, max_new_tokens=8)
    out["payload"] = eng.export_request_kv(0)
    toks = [out["payload"]["last_token"]]
    while len(toks) < 8:
        toks.append(int(eng.decode_step()[0]))
    out["continued"] = toks
    return out


@pytest.fixture(scope="module")
def plain(world, states, single):
    (r0, c0), (r1, c1) = world.run(
        _mesh_rank, _plain_engine(states["target"]), _drive_plain,
        single["payload"])
    return r0, c0, r1, c1


# ------------------------------------------------------------- the tests --
def test_mp2_decode_bitwise_vs_single_chip(plain, single, reference):
    r0, _, followed, c1 = plain
    # greedy: the reference's single-chip engine, its mesh engine and the
    # port's mesh engine agree; sampled: the port's mesh and single card
    assert r0["tokens"][0] == reference["greedy"] == reference["mesh_greedy"]
    assert r0["tokens"] == single["tokens"]
    assert followed > 0 and c1["serving"]["mesh_calls_followed"] == followed
    assert c1["serving"].get("mesh_follower_errors", 0) == 0
    np.testing.assert_allclose(r0["prefill_logits"],
                               single["prefill_logits"], **TOL)
    np.testing.assert_allclose(r0["decode_logits"], single["decode_logits"],
                               **TOL)
    st = r0["stats"]
    assert st["mesh_axes"] == {"mp": 2} and st["paged_kernel_sharded"]
    assert st["paged_kernel"] == "torch" and not st["decode_graph"]


def test_prefix_hit_on_the_mesh(plain, single, reference):
    r0 = plain[0]
    assert r0["hits"] == 1
    assert r0["hit"] == single["hit"] == reference["hit"]


def test_steady_steps_rebuild_demote_and_fall_back_never(plain):
    _, c0, _, c1 = plain
    steady = plain[0]["steady"]
    assert steady["fastpath"]["decode_audit_runs"] >= 2
    for key in ("decode_rebuilds", "decode_demotions"):
        assert key not in steady["fastpath"]
    assert "decode_compiles" not in steady["serving"]
    # the follower's fast path audited on the same cadence and never
    # demoted
    assert c1["fastpath"]["decode_audit_runs"] == \
        c0["fastpath"]["decode_audit_runs"]
    assert c1["fastpath"].get("decode_demotions", 0) == 0
    assert c1["serving"]["decode_steps"] == c0["serving"]["decode_steps"]


def test_describe_sharding_matches_the_reference_and_lints_clean(
        plain, reference):
    got, want = plain[0]["describe"], reference["describe"]
    assert sorted(got) == sorted(want)
    assert got["mesh"] == want["mesh"] == {"axes": {"mp": 2}}
    assert got["paged_kernel_sharded"] and want["paged_kernel_sharded"]
    assert len(got["kv_pools"]) == 4
    _same_pools(got, want)
    assert all(g["spec"] == [None, None, "mp"] for g in got["kv_pools"])
    assert _lint_engine(got) == [] == _lint_engine(want)


def test_handoff_export_matches_single_and_import_continues(
        plain, single, reference):
    got, want = plain[0]["payload"], single["payload"]
    ref = reference["payload"]
    for key in ("n_blocks", "block_size", "cur_len", "last_token",
                "gen_idx", "weight_generation"):
        assert got[key] == want[key] == ref[key], key
    rows = got["cur_len"]  # the rows the request wrote; the rest is junk

    def written(a):
        return np.asarray(a).reshape(-1, 4, 32)[:rows]

    for name in ("kv_k", "kv_v"):
        assert len(got[name]) == len(want[name]) == 2
        for a, b, c in zip(got[name], want[name], ref[name]):
            assert tuple(a.shape) == tuple(b.shape) == (got["n_blocks"], 4,
                                                        4, 32)
            np.testing.assert_allclose(written(a), written(b), **TOL)
            np.testing.assert_allclose(written(a), written(c), **XTOL)
    assert plain[0]["imported"] == single["continued"]


def _spec_engine(target, draft):
    def make(mesh):
        from paddle_tpu_torch.serving import DraftVerifyEngine

        return DraftVerifyEngine(_port_model(target), _port_model(draft),
                                 draft_k=3, device="cpu", mesh=mesh, **EKW)
    return make


def _drive_spec(eng, target):
    out = {"tokens": [_run(eng, p, N, step=eng.decode_step_spec, **kw)
                      for p, kw in zip(PROMPTS, KWS)],
           "stats": eng.stats(), "describe": eng.describe_sharding()}
    # mid-stream swap: the same target, the drafter made the target's twin
    rng = np.random.default_rng(5)
    prompt = [int(t) for t in rng.integers(1, VOCAB, 7)]
    toks = [eng.prefill(0, prompt, seed=0)]
    while len(toks) < 6:
        toks.extend(eng.decode_step_spec()[0])
    eng.swap_weights(dict(target), draft_state=dict(target))
    while len(toks) < 14:
        toks.extend(eng.decode_step_spec()[0])
    eng.release(0)
    out["swap"] = (prompt, toks[:14], eng.acceptance_by_generation())
    eng.pool.audit()
    eng.draft_pool.audit()
    return out


@pytest.fixture(scope="module")
def spec(world, states):
    (r0, c0), (_, c1) = world.run(
        _mesh_rank, _spec_engine(states["target"], states["draft"]),
        _drive_spec, states["target"])
    return r0, c0, c1


def test_mp2_spec_decode_bitwise_vs_plain_with_sharded_drafter(
        spec, single, reference):
    r0, _, c1 = spec
    assert r0["tokens"] == single["tokens"]
    assert r0["tokens"][0] == reference["greedy"]
    st = r0["stats"]
    assert st["paged_kernel_sharded"] and st["draft_kernel_sharded"]
    draft = [p for p in r0["describe"]["kv_pools"] if p.get("draft")]
    assert len(draft) == 4 and all(p["spec"] == [None, None, "mp"]
                                   for p in draft)
    assert _lint_engine(r0["describe"]) == []
    assert c1["serving"]["spec_rounds"] > 0
    assert c1["serving"].get("mesh_follower_errors", 0) == 0


def test_describe_sharding_of_spec_matches_the_reference(spec):
    jmesh = jspmd.serving_mesh(2, model=_jax_model(SEEDS["target"]))
    want = JaxSpec(_jax_model(SEEDS["target"]), _jax_model(SEEDS["draft"]),
                   draft_k=3, paged_kernel="pallas", mesh=jmesh,
                   **EKW).describe_sharding()
    got = spec[0]["describe"]
    assert sorted(got) == sorted(want)
    assert len(got["kv_pools"]) == 8
    _same_pools(got, want)
    assert got["draft_kernel_sharded"] and want["draft_kernel_sharded"]


def test_draft_swap_mid_stream_rebuilds_kv_and_recovers_acceptance(
        spec, states):
    prompt, got, by_gen = spec[0]["swap"]
    plain = _single(states["target"])
    want = [plain.prefill(0, prompt, seed=0)]
    while len(want) < 6:
        want.append(int(plain.decode_step()[0]))
    plain.swap_weights(states["target"])
    while len(want) < 14:
        want.append(int(plain.decode_step()[0]))
    assert got == want
    assert spec[1]["serving"]["draft_swaps"] == 1
    assert spec[2]["serving"]["draft_swaps"] == 1  # the follower's too
    assert by_gen[1] == 1.0  # a twin drafter: every draft accepted


def test_non_mp_mesh_axes_are_refused_as_the_reference_refuses(states):
    jmesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "mp"))
    with pytest.raises(ValueError) as jerr:
        JaxSpec(_jax_model(SEEDS["target"]), _jax_model(SEEDS["draft"]),
                draft_k=3, mesh=jmesh, **EKW)
    c0 = registry.counters("serving")["spec_mesh_refused"]
    with pytest.raises(ValueError) as err:
        DraftVerifyEngine(_port_model(states["target"]),
                          _port_model(states["draft"]), draft_k=3,
                          device="cpu", mesh={"dp": 2, "mp": 2}, **EKW)
    assert str(err.value) == str(jerr.value)
    assert registry.counters("serving")["spec_mesh_refused"] == c0 + 1
    ev = explainer.events(kind="spec_mesh_refused")[-1]
    assert ev["reason"] == "non_mp_axes" and ev["axes"] == {"dp": 2}
    with pytest.raises(ValueError, match="one axis"):
        GenerationEngine(_port_model(states["target"]), device="cpu",
                         mesh={"dp": 2, "mp": 2})


def test_serving_mesh_refuses_heads_mp_does_not_divide(states):
    with pytest.raises(ValueError) as jerr:
        jspmd.serving_mesh(3, model=_jax_model(SEEDS["target"]))
    with pytest.raises(ValueError) as err:
        spmd.serving_mesh(3, model=_port_model(states["target"]))
    assert str(err.value) == str(jerr.value)
    assert "mp=3" in str(err.value) and "n_head=4" in str(err.value)


@pytest.mark.parametrize("heads", [4, 3])
def test_select_paged_kernel_resolves_per_shard(heads):
    mesh = {"mp": 2}
    kind, reason = pa.select_paged_kernel(
        None, device="cpu", head_dim=32, dtype=torch.float32, mesh=mesh,
        num_heads=heads)
    assert kind == "torch"
    assert pa.paged_sharded(mesh, heads) == (heads == 4)
    if heads == 4:
        assert "per-shard" in reason and "local heads 2" in reason
        return
    assert "3 heads" in reason and "mp=2" in reason
    ev = [e for e in explainer.events(kind="kernel_fallback")
          if e.get("mp") == 2 and e.get("num_heads") == 3]
    assert ev and ev[-1]["op"] == "paged_attention"


def test_indivisible_heads_serve_whole_on_every_rank(world, states):
    (r0, _), (_, c1) = world.run(
        _mesh_rank, _plain_engine(states["three_heads"], **THREE_HEADS),
        lambda eng: (_run(eng, PROMPTS[0], N, **KWS[0]),
                     eng.describe_sharding(), eng.stats()))
    tokens, desc, st = r0
    want = _run(_single(states["three_heads"], **THREE_HEADS), PROMPTS[0],
                N, **KWS[0])
    assert tokens == want
    assert not st["paged_kernel_sharded"] and "3 heads" in \
        st["paged_kernel_reason"]
    assert all(p["spec"] == [] and p["shape"][2] == 3
               for p in desc["kv_pools"])
    assert _lint_engine(desc) == []
    assert c1["serving"]["mesh_calls_followed"] > 0


def test_moe_target_serves_at_mp2_with_the_reference_tokens(world, states):
    moe = JaxEngine(_jax_model(SEEDS["moe"], preset="gpt2-tiny-moe"),
                    paged_kernel="xla", **EKW)
    want = [_run(moe, p, N, **KWS[0]) for p in PROMPTS]
    (got, _), _ = world.run(
        _mesh_rank, _plain_engine(states["moe"], preset="gpt2-tiny-moe"),
        lambda eng: ([_run(eng, p, N, **KWS[0]) for p in PROMPTS],
                     eng.stats()["paged_kernel_sharded"]))
    assert got == (want, True)


def _server(state):
    def make(mesh):
        from paddle_tpu_torch.serving import GenerationServer

        return GenerationServer(_port_model(state), device="cpu", mesh=mesh,
                                max_batch_size=2, buckets=(8, 16),
                                block_size=4)
    return make


def _drive_server(srv, faulty):
    from paddle_tpu_torch.testing import faults

    if faulty:
        faults.configure("decode_error:fails=1")
    try:
        reqs = [srv.submit(p, max_new_tokens=N, seed=i)
                for i, p in enumerate(PROMPTS + [HIT, PROMPTS[0][:3]])]
        out = [r.result(timeout=60).tokens for r in reqs]
    finally:
        faults.reset()
    assert srv.shutdown(timeout=60)
    return [list(t) for t in out]


def _arm_and_follow(make):
    """A follower whose faults are armed like the leader's: the leader
    decides, so they must not fire here."""
    def armed(mesh):
        from paddle_tpu_torch.testing import faults

        obj = make(mesh)
        if mesh.rank:
            faults.configure("decode_error:fails=1")
        return obj
    return armed


@pytest.fixture(scope="module")
def served(world, states):
    clean = world.run(_mesh_rank, _server(states["target"]), _drive_server,
                      False)
    faulty = world.run(_mesh_rank, _arm_and_follow(_server(
        states["target"])), _drive_server, True)
    world.run(_reset_faults)  # the follower's armed point never fired
    return clean, faulty


def _reset_faults():
    from paddle_tpu_torch.testing import faults

    faults.reset()


def test_generation_server_on_the_mesh_answers_and_followers_return(
        served, states):
    (tokens, c0), (followed, c1) = served[0]
    eng = _single(states["target"])
    want = [_run(eng, p, N, seed=i) for i, p in
            enumerate(PROMPTS + [HIT, PROMPTS[0][:3]])]
    assert tokens == want
    assert followed == c1["serving"]["mesh_calls_followed"] > 0
    assert c0["serving"]["prefills"] == c1["serving"]["prefills"] == 4


def test_armed_decode_error_reprimes_both_ranks_and_none_hangs(served):
    (clean, _), _ = served[0]
    (tokens, c0), (_, c1) = served[1]
    assert tokens == clean
    assert c0["serving"]["reprimes"] == c1["serving"]["reprimes"] == 1
    assert c0["serving"]["step_retries"] == 1
    assert c1["serving"].get("mesh_follower_errors", 0) == 0
    assert c0["serving"]["decode_steps"] == c1["serving"]["decode_steps"]


def _follower_errors(state):
    """Every rank builds a mesh server; the follower tries to submit, to
    drive its engine and to swap, then follows; rank 0 shuts down."""
    from paddle_tpu_torch.distributed import spmd

    mesh = spmd.serving_mesh(2)
    srv = _server(state)(mesh)
    if not mesh.rank:
        return srv.shutdown()
    errors = []
    for call in (lambda: srv.submit([1, 2, 3]),
                 lambda: srv.engine.prefill(0, [1, 2, 3]),
                 lambda: srv.swap_weights({})):
        try:
            call()
            errors.append(None)
        except RuntimeError as e:
            errors.append(str(e))
    srv.follow()
    return errors


def test_a_follower_cannot_drive_or_submit(world, states):
    shut, errors = world.run(_follower_errors, states["target"])
    assert shut is True
    assert len(errors) == 3 and all(e and "rank 0" in e for e in errors)
