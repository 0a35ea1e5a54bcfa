"""MoE expert parallelism of the port against the JAX package: a
``gpt2-tiny-moe`` at ep 2 and at dp 2 x ep 2 (its batch split over
dp x ep, each rank holding ``E/ep`` experts of every bank, the dispatched
slots exchanged with one all-to-all each way) against the port at ep 1
and the reference's ep mesh: losses, the load-balancing loss and the
per-expert token counts; the ``E % ep`` refusal; and an ep checkpoint
merged back to whole ``[E, ...]`` banks loaded by the reference.

float32; tolerance 1e-5 on the losses and aux losses of 3 AdamW steps and
on the merged parameters.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.distributed import fleet as jfleet  # noqa: E402
from paddle_tpu.distributed import spmd as jspmd  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402

from torch_pp_parity import (TOL, V, assert_states_close, make_worlds,  # noqa: E402
                             ref_fleet, rng_guard, state_np)

torch.set_num_threads(1)

STEPS, B, T = 3, 8, 16
CFG = dict(vocab_size=V, n_layer=2, seq_len=T, dropout=0.0, n_head=2,
           d_model=32)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    get, close = make_worlds(tmp_path_factory)
    yield get
    close()


def _batch():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, V, (B, T)).astype(np.int64)
    return toks, np.roll(toks, -1, 1)


def _run_port(init, dp, ep, toks, labels, sgd=False):
    """``STEPS`` AdamW steps of the port's MoE GPT on this rank's rows:
    ``[(loss, aux)]`` (over the whole batch), block 0's expert counts at
    step 0, the merged state in the reference's layout, the all-to-all
    bytes of one step."""
    import torch
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import collective, fleet, spmd
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.optimizer import SGD, AdamW
    from paddle_tpu_torch.profiler import registry

    if dp * ep > 1:
        s = fleet.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": dp, "ep_degree": ep}
        fleet.init(is_collective=True, strategy=s)
    cfg = gpt.GPTConfig.preset("gpt2-tiny-moe", **CFG)
    model = gpt.GPTForPretraining(gpt.GPTModel(cfg, device="cpu"))
    if dp * ep > 1:
        fleet.distributed_model(model)
    convert.load_paddle_tpu_state(model, init)
    opt = SGD(0.1, parameters=model.parameters()) if sgd else \
        AdamW(1e-3, parameters=model.parameters())
    crit = gpt.GPTPretrainingCriterion()
    t = torch.from_numpy(toks)
    lab = torch.from_numpy(labels)
    if dp * ep > 1:
        t, lab = spmd.shard_batch(t), spmd.shard_batch(lab)
        batch_group = fleet.get_hybrid_communicate_group().get_batch_group()
    out, counts, a2a = [], None, None
    for i in range(STEPS):
        before = registry.counters("collective").get("all_to_all.bytes", 0)
        loss = crit(model(t), lab)
        aux = model.moe_aux_loss()
        (loss + aux).backward()
        opt.step()
        opt.clear_grad()
        if i == 0:
            counts = model.gpt.blocks[0].mlp.last_stats[
                "expert_tokens"].tolist()
            a2a = registry.counters("collective").get(
                "all_to_all.bytes", 0) - before
        loss = loss.detach().clone()
        if dp * ep > 1:
            collective.all_reduce(loss, collective.ReduceOp.AVG,
                                  group=batch_group)
        out.append((float(loss), float(aux)))
    merged = convert.merged_state_to_paddle_tpu(model) if dp * ep > 1 \
        else convert.state_to_paddle_tpu(model)
    state = {k: v.detach().numpy() for k, v in merged.items()}
    shapes = tuple(model.gpt.blocks[0].mlp.w1.shape)
    return dict(out=out, counts=counts, state=state, a2a=a2a, w1=shapes)


def _ref_moe(dp, ep, sgd=False):
    """The reference's eager loop under its lazy capture (one compiled
    program a step: the per-op compiles of its plain eager loop take
    three times as long)."""
    from paddle_tpu.core import lazy

    with rng_guard():
        ref_fleet(dp=dp, ep=ep, use_spmd=True)
        paddle.seed(123)
        model = jgpt.GPTForPretraining(jgpt.GPTModel(jgpt.GPTConfig.preset(
            "gpt2-tiny-moe", **CFG)))
        init = state_np(model)
        model = jfleet.distributed_model(model)
        opt = paddle.optimizer.SGD(0.1, parameters=model.parameters()) \
            if sgd else paddle.optimizer.AdamW(
                1e-3, parameters=model.parameters())
        crit = jgpt.GPTPretrainingCriterion()
        toks, labels = _batch()
        t = jspmd.shard_batch(paddle.to_tensor(toks))
        lab = jspmd.shard_batch(paddle.to_tensor(labels))
        out, counts = [], None
        for i in range(STEPS):
            with lazy.capture_guard(True), paddle.incubate.lazy_eval():
                loss = crit(model(t), lab)
                aux = model.moe_aux_loss()
                (loss + aux).backward()
                opt.step()
                opt.clear_grad()
                loss, aux = float(loss), float(aux)
            if i == 0:
                counts = np.asarray(model.gpt.blocks[0].mlp.last_stats[
                    "expert_tokens"].numpy()).tolist()
            out.append((loss, aux))
        return init, out, counts, state_np(model)


@pytest.fixture(scope="module")
def ref_ep2():
    return _ref_moe(1, 2)


@pytest.fixture(scope="module")
def port_ep1(ref_ep2):
    toks, labels = _batch()
    return _run_port(ref_ep2[0], 1, 1, toks, labels)


def test_ep2_matches_ep1_and_the_reference(worlds, ref_ep2, port_ep1):
    init, ref_out, ref_counts, ref_state = ref_ep2
    toks, labels = _batch()
    got = worlds(2).run(_run_port, init, 1, 2, toks, labels)
    np.testing.assert_allclose(port_ep1["out"], ref_out, **TOL)
    assert port_ep1["counts"] == ref_counts
    for r in got:
        assert r["w1"][0] == 2  # each rank holds E/ep = 2 of 4 experts
        np.testing.assert_allclose(r["out"], port_ep1["out"], **TOL)
        np.testing.assert_allclose(r["out"], ref_out, **TOL)
        assert r["counts"] == ref_counts
        assert_states_close(r["state"], ref_state)
    # the expert all-to-all: [E, G, C, H] float32 once each way in the
    # forward and again in the backward, per MoE layer (both are MoE)
    E, G, H = 4, B // 2, CFG["d_model"]
    C = int(np.ceil(T * 1.25 * 2 / E))
    assert got[0]["a2a"] == 2 * 2 * 2 * E * G * C * H * 4


def test_dp2_ep2_matches_the_reference(worlds):
    # SGD here: over four ranks Adam's normalised step turns the sum
    # order's rounding of a near-zero expert gradient into a step of the
    # learning rate's size (as tests/test_torch_mp.py's dropout leg)
    init, ref_out, ref_counts, ref_state = _ref_moe(2, 2, sgd=True)
    toks, labels = _batch()
    got = worlds(4).run(_run_port, init, 2, 2, toks, labels, True)
    for r in got:
        np.testing.assert_allclose(r["out"], ref_out, **TOL)
        assert r["counts"] == ref_counts
        assert_states_close(r["state"], ref_state)


def _rank_refusal():
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.nn.moe import MoEMLP
    from paddle_tpu_torch.nn.moe.gate import MoEConfigError
    from paddle_tpu_torch.profiler import explainer

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"ep_degree": 2}
    fleet.init(is_collective=True, strategy=s)
    try:
        MoEMLP(16, 32, num_experts=3)
    except MoEConfigError:
        return explainer.events(kind="moe_config_refused")[-1]["reason"]
    return None


def test_experts_indivisible_by_ep_are_refused(worlds):
    from paddle_tpu.nn.moe.gate import validate_moe_config
    from paddle_tpu.profiler import explainer as jexp

    with pytest.raises(ValueError):
        validate_moe_config(3, 2, 1.25, ep=2)
    want = jexp.events(kind="moe_config_refused")[-1]["reason"]
    assert worlds(2).run(_rank_refusal) == [want, want]


def test_merged_ep_checkpoint_loads_in_the_reference(worlds, ref_ep2):
    init = ref_ep2[0]
    toks, labels = _batch()
    got = worlds(2).run(_run_port, init, 1, 2, toks, labels)
    with rng_guard():
        paddle.seed(1)
        model = jgpt.GPTForPretraining(jgpt.GPTModel(jgpt.GPTConfig.preset(
            "gpt2-tiny-moe", **CFG)))
        model.set_state_dict(got[0]["state"])
        assert model.gpt.blocks[0].mlp.w1.shape == [4, 32, 128]
        assert_states_close(state_np(model), got[0]["state"])
