"""The port's Mixture-of-Experts layer (``paddle_tpu_torch.nn.moe``) against
the JAX package's (``paddle_tpu.nn.moe``), and the MoE GPT trunk.

The same weights and inputs, made from a seed with numpy, go through both
packages in float32. Tolerances: the gate's masks, combine weights, aux
loss and stats within 1e-6 absolute (the routing decisions themselves are
discrete and must agree exactly); a layer's or model's outputs and
gradients within 1e-4 absolute and relative (float32 summed in another
order). The degenerate configurations (one expert; tied experts under a
zero gate) are bitwise against the dense FFN, as in the reference's
``tests/test_moe.py``.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.incubate import checkpoint as jckpt  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu.nn import moe as jmoe  # noqa: E402
from paddle_tpu.profiler import registry as jregistry  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch import jit as tjit  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.incubate import checkpoint as tckpt  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.nn import moe as tmoe  # noqa: E402
from paddle_tpu_torch.profiler import explainer as texplain  # noqa: E402
from paddle_tpu_torch.profiler import registry as tregistry  # noqa: E402

GATE_TOL = dict(atol=1e-6, rtol=0)
TOL = dict(atol=1e-4, rtol=1e-4)
D, FF = 16, 32


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


def _seeded(fn, seed):
    """``fn()`` under a JAX-package seed, the global generator put back."""
    state = paddle.get_rng_state()
    try:
        paddle.seed(seed)
        return fn()
    finally:
        paddle.set_rng_state(state)


def _x(G=2, S=12, seed=13, d=D):
    return np.random.default_rng(seed).standard_normal(
        (G, S, d)).astype(np.float32)


def _gate_pair(E, k, cf, gate_w=None, seed=3):
    jg = _seeded(lambda: jmoe.TopKGate(D, E, top_k=k, capacity_factor=cf,
                                       init_std=0.5), seed)
    if gate_w is not None:
        jg.weight.set_value(gate_w)
    tg = tmoe.TopKGate(D, E, top_k=k, capacity_factor=cf)
    with torch.no_grad():
        tg.weight.copy_(torch.from_numpy(np.array(jg.weight.numpy())))
    return jg, tg


@pytest.mark.parametrize("E,k,cf,zero", [
    (4, 1, 1.0, False), (4, 2, 1.25, False), (4, 2, 1.0, True),
    (8, 3, 2.0, False), (4, 2, 1.0, False)])
def test_gate_matches_reference(E, k, cf, zero):
    gate_w = np.zeros((D, E), np.float32) if zero else None
    jg, tg = _gate_pair(E, k, cf, gate_w)
    x = _x()
    jd, jc, jaux, jst = jg(paddle.to_tensor(x))
    td, tc, taux, tst = tg(torch.from_numpy(x))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd.numpy()))
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc.numpy()),
                               **GATE_TOL)
    np.testing.assert_allclose(float(taux.detach()), float(jaux.numpy()),
                               **GATE_TOL)
    for key in ("expert_tokens", "expert_assigned", "dropped"):
        np.testing.assert_array_equal(tst[key].numpy(),
                                      np.asarray(jst[key].numpy()))
    assert tst["total"] == jst["total"] and \
        tst["capacity"] == jst["capacity"]
    if zero:  # uniform gates crowd every token onto experts 0 and 1
        assert float(tst["dropped"]) > 0
        assert (tst["expert_assigned"].numpy()[2:] == 0).all()


@pytest.mark.parametrize("kwargs,reason", [
    (dict(num_experts=0, top_k=1, capacity_factor=1.0), "no_experts"),
    (dict(num_experts=4, top_k=5, capacity_factor=1.0),
     "top_k_exceeds_experts"),
    (dict(num_experts=4, top_k=2, capacity_factor=0.5),
     "capacity_factor_too_small"),
    (dict(num_experts=4, top_k=2, capacity_factor=1.0, ep=3),
     "experts_indivisible_by_ep")])
def test_each_refusal_reason(kwargs, reason):
    with pytest.raises(jmoe.MoEConfigError, match=reason):
        jmoe.validate_moe_config(**kwargs)
    with pytest.raises(tmoe.MoEConfigError, match=reason) as ei:
        tmoe.validate_moe_config(**kwargs)
    assert reason in str(ei.value)
    ev = texplain.events(kind="moe_config_refused")[-1]
    assert ev["reason"] == reason
    assert ev["num_experts"] == kwargs["num_experts"]
    # and at construction, before anything routes
    E, k, cf = (kwargs[n] for n in ("num_experts", "top_k",
                                    "capacity_factor"))
    with pytest.raises(tmoe.MoEConfigError, match=reason):
        tmoe.MoEMLP(D, FF, E, top_k=k, capacity_factor=cf,
                    ep=kwargs.get("ep", 1))
    if E > 0 and "ep" not in kwargs:  # moe_num_experts=0 is the dense MLP
        with pytest.raises(tmoe.MoEConfigError, match=reason):
            tgpt.GPTConfig.preset("gpt2-tiny-moe", moe_num_experts=E,
                                  moe_top_k=k, moe_capacity_factor=cf)


def test_expert_parallel_is_refused_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        tmoe.MoEMLP(D, FF, 4, ep=2)


def test_capacity_matches_reference():
    for S in (1, 5, 16, 2048):
        for E, k, cf in ((4, 2, 1.25), (8, 2, 1.25), (8, 1, 1.0),
                         (3, 2, 1.7)):
            assert tmoe.moe_capacity(S, E, k, cf) == \
                jmoe.moe_capacity(S, E, k, cf)
    assert tmoe.moe_capacity(1, 8, 2, 1.25) == 1  # a decode row


def _weights(seed=11):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((D, FF)).astype(np.float32) * 0.05,
            rng.standard_normal(FF).astype(np.float32) * 0.05,
            rng.standard_normal((FF, D)).astype(np.float32) * 0.05,
            rng.standard_normal(D).astype(np.float32) * 0.05)


def _dense(x, w1, b1, w2, b2):
    h = F.gelu(x @ torch.from_numpy(w1) + torch.from_numpy(b1),
               approximate="tanh")
    return h @ torch.from_numpy(w2) + torch.from_numpy(b2)


def _set_banks(m, E, w1, b1, w2, b2):
    with torch.no_grad():
        for p, w in ((m.w1, w1), (m.b1, b1), (m.w2, w2), (m.b2, b2)):
            p.copy_(torch.from_numpy(np.stack([w] * E)))


def test_single_expert_is_exactly_dense():
    # E=1, k=1, cf=1.0: C=S, nothing drops, the combine weight is 1.0
    w = _weights()
    m = tmoe.MoEMLP(D, FF, 1, top_k=1, capacity_factor=1.0)
    _set_banks(m, 1, *w)
    x = torch.from_numpy(_x())
    torch.testing.assert_close(m(x), _dense(x, *w), rtol=0, atol=0)


def test_tied_experts_uniform_gate_exact():
    # E=4, k=2, zero gate, cf=E/k: identical experts, uniform gates,
    # capacity never binds: bitwise the dense FFN, aux loss exactly 1.0
    E = 4
    w = _weights()
    m = tmoe.MoEMLP(D, FF, E, top_k=2, capacity_factor=E / 2)
    with torch.no_grad():
        m.gate.weight.zero_()
    _set_banks(m, E, *w)
    x = torch.from_numpy(_x())
    torch.testing.assert_close(m(x), _dense(x, *w), rtol=0, atol=0)
    assert float(m.aux_loss.detach()) == 1.0


def _layer_pair(E=4, k=2, cf=1.25, seed=5):
    jm = _seeded(lambda: jmoe.MoEMLP(D, FF, E, top_k=k, capacity_factor=cf,
                                     init_std=0.3), seed)
    tm = tmoe.MoEMLP(D, FF, E, top_k=k, capacity_factor=cf)
    state = {n: torch.from_numpy(np.array(v.numpy()))
             for n, v in jm.state_dict().items()}
    assert list(state) == [n for n, _ in tm.named_parameters()]
    tm.load_state_dict(state)
    return jm, tm


@pytest.mark.parametrize("cf", [1.0, 1.25])
def test_layer_forward_and_grads_match_reference(cf):
    jm, tm = _layer_pair(cf=cf)
    x = _x(S=16)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jy = jm(jx)
    ((jy ** 2).mean() + jm.aux_loss).backward()
    tx = torch.from_numpy(x).requires_grad_()
    ty = tm(tx)
    ((ty ** 2).mean() + tm.aux_loss).backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy.numpy()),
                               **TOL)
    np.testing.assert_allclose(float(tm.aux_loss.detach()),
                               float(jm.aux_loss.numpy()), **GATE_TOL)
    for name in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(
            getattr(tm, name).grad.numpy(),
            np.asarray(getattr(jm, name).grad.numpy()), **TOL, err_msg=name)
    np.testing.assert_allclose(tm.gate.weight.grad.numpy(),
                               np.asarray(jm.gate.weight.grad.numpy()),
                               **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad.numpy()),
                               **TOL)


VOCAB = 96
CFG = dict(vocab_size=VOCAB, n_head=2, dropout=0.0, initializer_range=0.1)


def _model_pair(seed=0, **over):
    jm = _seeded(lambda: jgpt.GPTForPretraining(jgpt.GPTModel(
        jgpt.GPTConfig.preset("gpt2-tiny-moe", **CFG, **over))), seed)
    tm = tgpt.GPTForPretraining(tgpt.GPTModel(tgpt.GPTConfig.preset(
        "gpt2-tiny-moe", **CFG, **over), device="cpu"))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    return jm, convert.load_paddle_tpu_state(tm, state)


def _batch(seed=0, B=2, T=64):
    toks = np.random.default_rng(seed).integers(0, VOCAB, (B, T))
    return toks, np.roll(toks, -1, axis=1)


def test_moe_gpt_forward_through_convert_matches_reference():
    jm, tm = _model_pair(moe_every=1)
    assert all(isinstance(b.mlp, tmoe.MoEMLP) for b in tm.gpt.blocks)
    toks, _ = _batch()
    with torch.no_grad():
        got = tm(torch.from_numpy(toks)).numpy()
    want = np.asarray(jm(paddle.to_tensor(toks)).numpy())
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(float(tm.moe_aux_loss()),
                               float(jm.moe_aux_loss().numpy()), **TOL)
    # the state goes back unchanged, banks by name and untransposed
    back = convert.state_to_paddle_tpu(tm.gpt)
    src = jm.gpt.state_dict()
    for name in ("blocks.0.mlp.w1", "blocks.1.mlp.gate.weight"):
        np.testing.assert_array_equal(back[name].numpy(),
                                      np.asarray(src[name].numpy()))


def test_moe_every_places_experts_like_the_reference():
    jm, tm = _model_pair(n_layer=4, moe_every=2)
    kinds = [type(b.mlp).__name__ for b in tm.gpt.blocks]
    assert kinds == [type(b.mlp).__name__ for b in jm.gpt.blocks] == [
        "MoEMLP", "GPTMLP", "MoEMLP", "GPTMLP"]


def test_adamw_step_with_aux_loss_matches_the_eager_loop():
    jm, tm = _model_pair()
    jcrit, tcrit = jgpt.GPTPretrainingCriterion(), \
        tgpt.GPTPretrainingCriterion()
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters())
    opt = topt.AdamW(learning_rate=1e-3, parameters=tm.parameters())

    def step_fn(tokens, labels):
        loss = tcrit(tm(tokens), labels) + tm.moe_aux_loss()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    step = tjit.TrainStep(step_fn, tm, opt)
    toks, labels = _batch()
    jloss = jcrit(jm(paddle.to_tensor(toks)), paddle.to_tensor(labels)) \
        + jm.moe_aux_loss()
    jloss.backward()
    jopt.step()
    jopt.clear_grad()
    tloss = step(toks, labels)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL)
    want = convert.state_from_paddle_tpu(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}, tm)
    # Adam's first step moves an element by about lr * sign(grad); where
    # |grad| is within float32 rounding of zero (the key projection's
    # bias, which softmax ignores, and a few small bank entries) that sign
    # is noise in either framework, so those elements (|grad| <= 1e-7,
    # under 1% of them) are left out: the first moment (0.1 grad) below
    # holds every element
    m1 = convert.optimizer_state_from_paddle_tpu(jopt.state_dict(), opt, tm)
    tm1 = opt.state_dict()
    names = [n for n, _ in tm.named_parameters()]
    resolved = {}
    for i, n in enumerate(names):
        key = f"moment1/p{i}"
        g = [t.abs().numpy() / 0.1 for t in (m1[key], tm1[key])]
        resolved[n] = ((g[0] == 0) & (g[1] == 0)) | (
            (g[0] > 1e-7) & (g[1] > 1e-7))
    assert sum(int((~r).sum()) for r in resolved.values()) <= \
        0.01 * sum(p.numel() for p in tm.parameters())
    for name, t in tm.state_dict().items():
        keep = resolved[name]
        np.testing.assert_allclose(t.numpy()[keep], want[name].numpy()[keep],
                                   **TOL, err_msg=name)
    # the optimizer's slots carry across by name, banks untransposed
    slots = convert.optimizer_state_from_paddle_tpu(jopt.state_dict(), opt,
                                                    tm)
    tsd = opt.state_dict()
    for key, t in slots.items():
        if key != "_opt_step":
            np.testing.assert_allclose(tsd[key].numpy(), t.numpy(), **TOL,
                                       err_msg=key)
    back = convert.optimizer_state_to_paddle_tpu(opt, tm)
    jsd = jopt.state_dict()
    for key in jsd:
        if key.startswith("moment"):
            np.testing.assert_allclose(back[key].numpy(),
                                       np.asarray(jsd[key].numpy()), **TOL,
                                       err_msg=key)


def _equal_states(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        a = v.detach().numpy() if isinstance(v, torch.Tensor) else \
            np.asarray(v.numpy() if hasattr(v, "numpy") else v)
        b = got[k].detach().numpy() if isinstance(got[k], torch.Tensor) \
            else np.asarray(got[k].numpy() if hasattr(got[k], "numpy")
                            else got[k])
        np.testing.assert_array_equal(b, a, err_msg=k)


def test_moe_training_state_through_checkpoints_both_ways(tmp_path):
    # the banks and the gate, and their AdamW slots, cross by name with
    # no transpose: a port checkpoint restores into the reference and the
    # reference's into the port, exactly
    jm, tm = _model_pair()
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters())
    opt = topt.AdamW(learning_rate=1e-3, parameters=tm.parameters())
    toks, labels = _batch()
    loss = tgpt.GPTPretrainingCriterion()(
        tm(torch.from_numpy(toks)), torch.from_numpy(labels)) \
        + tm.moe_aux_loss()
    loss.backward()
    opt.step()
    opt.clear_grad()
    tckpt.save_checkpoint(str(tmp_path / "port"),
                          tckpt.capture_training_state(tm, opt), 3)
    jopt._ensure_accumulators()
    state, man = jckpt.load_latest(str(tmp_path / "port"), world_size=1)
    assert man["step"] == 3
    jckpt.restore_training_state(jm, jopt, state)
    _equal_states(jm.state_dict(), convert.state_to_paddle_tpu(tm))
    ref_slots = {k: v for k, v in jopt.state_dict().items()
                 if k != "LR_Scheduler"}
    port_slots = {k: v for k, v in convert.optimizer_state_to_paddle_tpu(
        opt, tm).items() if k != "LR_Scheduler"}
    _equal_states(ref_slots, port_slots)
    # and back: the reference's checkpoint into a fresh port model
    jckpt.save_checkpoint(str(tmp_path / "ref"),
                          jckpt.capture_training_state(jm, jopt), 4)
    got, _ = tckpt.load_resharded(str(tmp_path / "ref"))
    fresh = tgpt.GPTForPretraining(tgpt.GPTModel(tgpt.GPTConfig.preset(
        "gpt2-tiny-moe", **CFG), device="cpu"))
    fresh_opt = topt.AdamW(learning_rate=1e-3,
                           parameters=fresh.parameters())
    tckpt.restore_training_state(fresh, fresh_opt, got)
    _equal_states(fresh.state_dict(), tm.state_dict())
    _equal_states(fresh_opt.state_dict(), opt.state_dict())


def test_recompute_keeps_the_first_forwards_aux_loss():
    # under use_recompute the backward reruns each block; the aux loss
    # read before backward (and after it) is the first forward's, and
    # loss and grads equal the run without recompute
    toks, labels = (torch.from_numpy(a) for a in _batch())
    runs = []
    for use_recompute in (False, True):
        tm = tgpt.GPTForPretraining(tgpt.GPTModel(
            tgpt.GPTConfig.preset("gpt2-tiny-moe", use_recompute=use_recompute,
                                  **CFG),
            device="cpu", generator=torch.Generator().manual_seed(4)))
        loss = tgpt.GPTPretrainingCriterion()(tm(toks), labels)
        aux = tm.moe_aux_loss()
        stats = [b.mlp.last_stats for b in tm.gpt.blocks]
        (loss + aux).backward()
        after = [b.mlp.last_stats for b in tm.gpt.blocks]
        assert all(a is b for a, b in zip(stats, after))
        assert torch.equal(tm.moe_aux_loss(), aux)
        runs.append((float(loss + aux), {n: p.grad for n, p in
                                         tm.named_parameters()}))
    (l0, g0), (l1, g1) = runs
    assert l0 == l1
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], **TOL)


def test_metrics_publish_matches_the_reference_registry():
    jm, tm = _model_pair()
    toks, _ = _batch(seed=2)
    jm(paddle.to_tensor(toks))
    with torch.no_grad():
        tm(torch.from_numpy(toks))
    jregistry.reset("moe")
    tregistry.reset("moe")
    want = jmoe.metrics.publish(jm)
    got = tmoe.metrics.publish(tm)
    np.testing.assert_array_equal(got["expert_tokens"],
                                  want["expert_tokens"])
    np.testing.assert_array_equal(got["expert_assigned"],
                                  want["expert_assigned"])
    assert got["dropped"] == want["dropped"]
    assert got["total"] == want["total"]
    assert got["drop_fraction"] == want["drop_fraction"]
    js, ts = jmoe.metrics.snapshot(), tmoe.metrics.snapshot()
    assert ts["counters"] == js["counters"]
    assert ts["drop_fraction"] == js["drop_fraction"]
    h = "moe.expert_load_frac"
    assert ts["hists"][h]["buckets"] == js["hists"][h]["buckets"]
    assert ts["hists"][h]["count"] == js["hists"][h]["count"] == 4
    assert tmoe.metrics.collect(tgpt.GPTModel(
        tgpt.GPTConfig.preset("gpt2-tiny", vocab_size=VOCAB),
        device="cpu")) is None


def test_bf16_model_keeps_a_bf16_gate_and_routes_in_float32():
    # the reference's model cast turns the float32 gate weight into bf16
    # (paddle_tpu/nn/layer/layers.py:256); the gate then promotes to
    # float32 inside its einsum. The port: the same weight dtype, the
    # same float32 routing from the same bf16 values.
    jm = _seeded(lambda: jgpt.GPTModel(jgpt.GPTConfig.preset(
        "gpt2-tiny-moe", dtype="bfloat16", **CFG)), 0)
    tm = tgpt.GPTModel(tgpt.GPTConfig.preset(
        "gpt2-tiny-moe", dtype="bfloat16", **CFG), device="cpu")
    jg, tg = jm.blocks[0].mlp.gate, tm.blocks[0].mlp.gate
    assert "bfloat16" in str(jg.weight.dtype)
    assert tg.weight.dtype == torch.bfloat16
    convert.load_paddle_tpu_state(
        tm, {k: np.asarray(v.numpy().astype(np.float32))
             for k, v in jm.state_dict().items()})
    seen = []
    orig = torch.einsum

    def spy(eq, *ops):
        if eq == "gsh,he->gse":
            seen.append(tuple(o.dtype for o in ops))
        return orig(eq, *ops)

    xb = torch.from_numpy(_x(d=128)).bfloat16()
    tg.requires_grad_(False)
    jd, jc, _, _ = jg(paddle.to_tensor(xb.float().numpy()).astype(
        "bfloat16"))
    torch.einsum = spy
    try:
        td, tc, _, _ = tg(xb)
    finally:
        torch.einsum = orig
    assert seen == [(torch.float32, torch.float32)]
    assert tc.dtype == torch.float32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd.numpy()))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc.numpy()),
                               **GATE_TOL)
