"""Pipeline parallelism of the port against the JAX package: the
``PipelineLayer`` segmentation, ``PipelineSpmdStep`` (GPipe) at pp 2,
its refusals and state export, the hapi pipeline branch, the tied word
embedding across stages, and ``convert``'s slicing helpers (dp 2 x pp 2
and mp 2 x pp 2 are in ``tests/test_torch_pp_mixed.py``).

The reference runs on the 8 virtual CPU devices (one controller, the
trunk stacked over ``'pp'``); the port as a ``testing.world.World`` of
gloo ranks, each holding its stage's blocks. Weights are carried by
``convert``; float32 throughout. Tolerance: 1e-5 on the losses of 4
AdamW steps and on the merged parameters, as ``tests/test_torch_mp.py``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.distributed import pp_spmd as jpp  # noqa: E402
from paddle_tpu.distributed.meta_parallel import pp_layers as jpl  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402

from torch_pp_parity import (GPT_CFG, TOL, V, assert_states_close,  # noqa: E402
                             batch, make_worlds, ref_fleet, ref_gpt,
                             rng_guard, state_np)

torch.set_num_threads(1)

M, STEPS = 2, 4


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    get, close = make_worlds(tmp_path_factory)
    yield get
    close()


# ----------------------------------------------------------- segmentation ---
D = 16


def _descs(mod, blocks, n_blocks):
    """The same LayerDesc list for either package (``mod``: its nn,
    ``blocks``: its block class)."""
    return [
        mod["Shared"]("embed", mod["nn"].Embedding, V, D),
        *[mod["Desc"](blocks, D) for _ in range(n_blocks)],
        mod["Desc"](mod["nn"].LayerNorm, D),
        mod["Shared"]("embed", mod["nn"].Embedding, V, D,
                      forward_func=lambda lay, x: x),
    ]


class _JBlock(jnn.Layer):
    def __init__(self, d):
        super().__init__()
        self.ln = jnn.LayerNorm(d)
        self.fc1 = jnn.Linear(d, 2 * d)
        self.fc2 = jnn.Linear(2 * d, d)

    def forward(self, x):
        return x + self.fc2(self.fc1(self.ln(x)))


class _TBlock(torch.nn.Module):
    def __init__(self, d):
        super().__init__()
        self.ln = torch.nn.LayerNorm(d)
        self.fc1 = torch.nn.Linear(d, 2 * d)
        self.fc2 = torch.nn.Linear(2 * d, d)

    def forward(self, x):
        return x + self.fc2(self.fc1(self.ln(x)))


def _both(build):
    from paddle_tpu_torch.distributed.meta_parallel import pp_layers as tpl

    ref = dict(nn=jnn, Desc=jpl.LayerDesc, Shared=jpl.SharedLayerDesc,
               Layer=jpl.PipelineLayer, Block=_JBlock)
    port = dict(nn=torch.nn, Desc=tpl.LayerDesc, Shared=tpl.SharedLayerDesc,
                Layer=tpl.PipelineLayer, Block=_TBlock)
    return build(ref), build(port)


def _summary(pre, trunk, post):
    return (len(pre), [type(b).__name__.lstrip("_JT") for b in trunk],
            [e[0] for e in post])


@pytest.mark.parametrize("case", ["pre_trunk_post", "leftover_into_post",
                                  "layer_filter"])
def test_segmentation_matches_the_reference(case):
    def build(m):
        if case == "layer_filter":
            descs = [m["Desc"](m["nn"].Linear, D, D) for _ in range(4)] + \
                [m["Desc"](m["Block"], D) for _ in range(2)]
            return m["Layer"](descs, num_stages=2,
                              seg_method="layer:" + m["Block"].__name__)
        n = 5 if case == "leftover_into_post" else 4
        return m["Layer"](_descs(m, m["Block"], n), num_stages=2)

    ref, port = _both(build)
    assert _summary(*port.segment_for_pipeline(2)) == \
        _summary(*ref.segment_for_pipeline(2))
    assert [port.get_stage_from_index(i) for i in range(6)] == \
        [ref.get_stage_from_index(i) for i in range(6)]


def test_no_uniform_run_is_refused_with_the_reference_reason():
    from paddle_tpu.profiler import explainer as jexp
    from paddle_tpu_torch.distributed.meta_parallel import pp_layers as tpl
    from paddle_tpu_torch.profiler import explainer as texp

    port = tpl.PipelineLayer([tpl.LayerDesc(torch.nn.Linear, D, 2 * D),
                              tpl.LayerDesc(torch.nn.Linear, 2 * D, D)])
    ref = jpl.PipelineLayer([jpl.LayerDesc(jnn.Linear, D, 2 * D),
                             jpl.LayerDesc(jnn.Linear, 2 * D, D)])
    with pytest.raises(tpl.PipelineStageError, match="structurally-uniform"):
        port.segment_for_pipeline(2)
    with pytest.raises(ValueError, match="structurally-uniform"):
        ref.segment_for_pipeline(2)
    want = jexp.events(kind="spmd_pp_refused")[-1]["reason"]
    assert texp.events(kind="spmd_pp_refused")[-1]["reason"] == want


def test_shared_layer_is_one_parameter_and_forward_matches():
    def build(m):
        return m["Layer"](_descs(m, m["Block"], 2), num_stages=2)

    ref, port = _both(build)
    assert sorted(port.state_dict()) == sorted(ref.state_dict())
    shared = port._shared["embed"].weight
    assert sum(t is shared for t in port.parameters()) == 1


# ------------------------------------------------------ PipelineSpmdStep ---
def _fleet(dp, mp, pp, M=M, sharding=1):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp,
                        "sharding_degree": sharding}
    s.pipeline_configs = {"accumulate_steps": M}
    fleet.init(is_collective=True, strategy=s)
    return fleet.get_hybrid_communicate_group()


def _port_gpt(init, n_layer=2, **kw):
    import torch
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import gpt

    cfg = gpt.GPTConfig.preset("gpt2-tiny", n_layer=n_layer,
                               **dict(GPT_CFG, **kw))
    model = gpt.GPTForPretraining(gpt.GPTModel(
        cfg, device="cpu", generator=torch.Generator().manual_seed(5)))
    if fleet.get_hybrid_communicate_group().get_model_parallel_world_size() \
            > 1:
        fleet.distributed_model(model)
    if init is not None:
        convert.load_paddle_tpu_state(model, init)
    return model


def _ref_layout(model, state):
    from paddle_tpu_torch import convert

    linear = convert._linear_weight_names(model)
    return {k: (v.t() if k in linear else v).numpy()
            for k, v in state.items()}


def _rank_pp(init, dp, mp, pp, toks, labels, unroll=None, M_=M,
             sharding=1, level=None):
    from paddle_tpu_torch.distributed.pp_spmd import PipelineSpmdStep
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import registry

    hcg = _fleet(dp, mp, pp, M_, sharding)
    model = _port_gpt(init)
    opt = AdamW(1e-3, parameters=model.parameters())
    net = model
    if level is not None:  # ZeRO: the facade and its sharded optimizer
        net, opt, _ = group_sharded_parallel(model, opt, level)
    step = PipelineSpmdStep(net, opt, criterion=gpt.GPTPretrainingCriterion(),
                            unroll_ticks=unroll)
    losses = [float(step.train_batch([toks, labels])) for _ in range(STEPS)]
    zero, runner = step.runner.zero, step.runner
    mine = [p for p in runner.all_params if id(p) in runner.owned]

    def whole(p):  # bytes of ``p`` unsharded
        import math

        return math.prod(getattr(p, "zero_full_shape", p.shape)) * \
            p.element_size()

    held = None if zero is None else dict(
        zero.held_bytes(), level=zero.level,
        stage_whole=sum(whole(p) for p in mine),
        held_2d=sum(p.numel() * p.element_size() for p in mine
                    if p.dim() >= 2),
        whole_2d=sum(whole(p) for p in mine if p.dim() >= 2))
    emb = model.gpt.embeddings.word_embeddings.weight.detach().clone()
    state = _ref_layout(model, step.state_dict())
    from paddle_tpu_torch import convert

    linear = convert._linear_weight_ids(model)
    plist = step.runner.full_list
    opt_state = {}
    for k, v in step.export_optimizer_state().items():
        if hasattr(v, "numpy"):
            i = int(k.rpartition("/p")[2])
            v = (v.t() if id(plist[i]) in linear else v).numpy()
        opt_state[k] = v
    return dict(losses=losses, state=state, opt=opt_state, held=held,
                emb=emb.numpy(), stage=hcg.get_stage_id(), M=step.M,
                sent=registry.gauge("pp.permute_bytes_per_step"))


def _ref_pp(dp, mp, pp, sharding=1, level=None):
    with rng_guard():
        ref_fleet(dp=dp, mp=mp, pp=pp, sharding=sharding, use_spmd=True, M=M)
        from paddle_tpu.distributed import fleet as jfleet
        from paddle_tpu.distributed.sharding import group_sharded_parallel

        model, init = ref_gpt()
        model = jfleet.distributed_model(model)
        opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters())
        net = model
        if level is not None:
            net, opt, _ = group_sharded_parallel(model, opt, level)
        step = jpp.PipelineSpmdStep(net, opt,
                                    criterion=jgpt.GPTPretrainingCriterion(),
                                    accumulate_steps=M)
        toks, labels = batch()
        losses = [float(step.train_batch([toks, labels]))
                  for _ in range(STEPS)]
        opt_state = step.export_optimizer_state()
        step.sync_params_to_model()
        return init, losses, state_np(model), {
            k: np.asarray(v.numpy()) if hasattr(v, "numpy") else v
            for k, v in opt_state.items()}


@pytest.fixture(scope="module")
def ref_pp2():
    return _ref_pp(1, 1, 2)


def _check(got, ref_losses, ref_state):
    for r in got:
        np.testing.assert_allclose(r["losses"], ref_losses, **TOL)
        assert_states_close(r["state"], ref_state)


def test_pp2_matches_the_reference_pipeline_step(worlds, ref_pp2):
    init, losses, final, ref_opt = ref_pp2
    toks, labels = batch()
    got = worlds(2).run(_rank_pp, init, 1, 1, 2, toks, labels)
    _check(got, losses, final)
    # the optimizer's state in the canonical per-layer layout: the
    # reference's keys and values
    for r in got:
        assert sorted(r["opt"]) == sorted(ref_opt)
        assert r["opt"]["_opt_step"] == ref_opt["_opt_step"] == STEPS
        for k, v in ref_opt.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_allclose(r["opt"][k], v, **TOL, err_msg=k)
    # the tied word embedding: one copy a stage, bitwise equal, and equal
    # to the reference's one weight
    assert {r["stage"] for r in got} == {0, 1}
    np.testing.assert_array_equal(got[0]["emb"], got[1]["emb"])
    np.testing.assert_allclose(got[0]["emb"],
                               final["gpt.embeddings.word_embeddings.weight"],
                               **TOL)
    # boundary bytes: M activations forward, M gradients back
    mb = toks.shape[0] // M
    assert got[0]["sent"] == got[1]["sent"] == M * mb * toks.shape[1] * \
        GPT_CFG["d_model"] * 4


def test_microbatches_below_pp_and_both_schedule_forms(worlds, ref_pp2):
    init = ref_pp2[0]
    toks, labels = batch()
    one = worlds(2).run(_rank_pp, init, 1, 1, 2, toks, labels, None, 1)
    assert one[0]["M"] == 1
    assert np.isfinite(one[0]["losses"]).all()
    assert one[0]["losses"][-1] < one[0]["losses"][0]
    # unroll_ticks is the reference's XLA knob (unrolled against scanned
    # ticks): accepted, and the one eager schedule gives the same values
    lock = worlds(2).run(_rank_pp, init, 1, 1, 2, toks, labels, 8)
    stream = worlds(2).run(_rank_pp, init, 1, 1, 2, toks, labels, 1)
    assert lock[0]["losses"] == stream[0]["losses"]
    for k, v in lock[0]["state"].items():
        np.testing.assert_array_equal(stream[0]["state"][k], v, err_msg=k)


# -------------------------------------------------------------- refusals ---
def _rank_refusals():
    import torch
    from paddle_tpu_torch.distributed.meta_parallel.pp_layers import \
        PipelineStageError
    from paddle_tpu_torch.distributed.pp_spmd import PipelineSpmdStep
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import explainer

    out = {}

    def attempt(name, fn):
        explainer._events.clear()
        try:
            fn()
            out[name] = None
        except (PipelineStageError, RuntimeError) as e:
            ev = explainer.events(kind="spmd_pp_refused")
            out[name] = (type(e).__name__, ev[-1]["reason"] if ev else None)

    _fleet(1, 1, 2)

    def build(n_layer=2, **kw):
        m = _port_gpt(None, n_layer=n_layer, **kw)
        return m, AdamW(1e-3, parameters=m.parameters())

    attempt("stages", lambda: PipelineSpmdStep(*build(3)))
    attempt("moe", lambda: PipelineSpmdStep(*build(
        2, moe_num_experts=2, moe_every=1)))

    def batch_refused():
        step = PipelineSpmdStep(*build(2), accumulate_steps=3)
        t = torch.zeros(4, 16, dtype=torch.long)
        step.train_batch([t, t])

    attempt("batch", batch_refused)
    _fleet(2, 1, 1)
    attempt("no_mesh", lambda: PipelineSpmdStep(*build(2)))
    return out


def test_refusals_carry_the_reference_reasons(worlds):
    got = worlds(2).run(_rank_refusals)[0]
    assert got["stages"] == ("PipelineStageError", "stage_indivisible")
    assert got["moe"] == ("PipelineStageError", "moe_trunk")
    assert got["batch"] == ("PipelineStageError", "batch_indivisible")
    assert got["no_mesh"][0] == "RuntimeError"
    # the reference refuses the same configurations with the same reasons
    from paddle_tpu.profiler import explainer as jexp

    with rng_guard():
        ref_fleet(pp=2, use_spmd=True)
        for kw, reason in (({"n_layer": 3}, "stage_indivisible"),
                           ({"moe_num_experts": 2, "moe_every": 1},
                            "moe_trunk")):
            model, _ = ref_gpt(**kw)
            opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters())
            with pytest.raises(jpl.PipelineStageError):
                jpp.PipelineSpmdStep(model, opt)
            assert jexp.events(kind="spmd_pp_refused")[-1]["reason"] == \
                reason


# ---------------------------------------------------------- hapi branch ---
def _rank_hapi(init, toks, labels, prefix):
    from paddle_tpu_torch import hapi
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.optimizer import AdamW

    _fleet(1, 1, 2)
    out = {}
    model = _port_gpt(init)
    m = hapi.Model(model)
    opt = AdamW(1e-3, parameters=model.parameters())
    m.prepare(optimizer=opt, loss=gpt.GPTPretrainingCriterion(),
              amp_configs="O1")
    try:
        m.train_batch([toks], [labels])
    except ValueError as e:
        out["amp"] = str(e)
    m.prepare(optimizer=opt, loss=gpt.GPTPretrainingCriterion())
    out["losses"] = [m.train_batch([toks], [labels])[0] for _ in range(3)]
    out["selected"] = type(m._pp_step).__name__
    out["eval"] = m.eval_batch([toks], [labels])[1]["loss"]
    try:
        m.train_batch([toks], [labels, labels])
    except ValueError as e:
        out["multi"] = str(e)
    m.save(prefix)
    out["next"] = m.train_batch([toks], [labels])[0]
    model2 = _port_gpt(None)
    opt2 = AdamW(1e-3, parameters=model2.parameters())
    m2 = hapi.Model(model2)
    m2.prepare(optimizer=opt2, loss=gpt.GPTPretrainingCriterion())
    m2.load(prefix)
    out["opt_step"] = opt2._opt_step
    out["resumed"] = m2.train_batch([toks], [labels])[0]
    return out


def test_hapi_selects_the_pipeline_step_and_resumes(worlds, ref_pp2,
                                                    tmp_path):
    toks, labels = batch()
    got = worlds(2).run(_rank_hapi, ref_pp2[0], toks, labels,
                        str(tmp_path / "ck"))
    r = got[0]
    assert "amp_configs is not supported" in r["amp"]
    assert r["selected"] == "PipelineSpmdStep"
    np.testing.assert_allclose(r["losses"], ref_pp2[1][:3], **TOL)
    assert r["eval"] < r["losses"][0]
    assert "(tokens, labels)" in r["multi"]
    assert r["opt_step"] == 3
    np.testing.assert_allclose(r["resumed"], r["next"], **TOL)
    # the checkpoint is the reference's: its dense model loads it
    from paddle_tpu.framework import load as jload

    with rng_guard():
        model, _ = ref_gpt()
        model.set_state_dict(jload(str(tmp_path / "ck.pdparams")))
        opt_sd = jload(str(tmp_path / "ck.pdopt"))
    assert opt_sd["_opt_step"] == 3


# ------------------------------------------------ convert's slicing helpers --
def test_convert_cuts_a_whole_state_into_each_forms_part(ref_pp2):
    import torch
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.optimizer import AdamW

    init = ref_pp2[0]
    model = gpt.GPTForPretraining(gpt.GPTModel(gpt.GPTConfig.preset(
        "gpt2-tiny", n_layer=2, **GPT_CFG), device="cpu"))
    parts = [convert.slice_stage_state(init, model, 2, s) for s in (0, 1)]
    assert not any(k.startswith("gpt.blocks.1.") for k in parts[0])
    assert not any(k.startswith("gpt.blocks.0.") for k in parts[1])
    assert "gpt.embeddings.word_embeddings.weight" in parts[1]
    merged = convert.merge_stage_states(parts)
    assert sorted(merged) == sorted(init)
    convert.load_paddle_tpu_state(model, merged)

    moe = gpt.GPTForPretraining(gpt.GPTModel(gpt.GPTConfig.preset(
        "gpt2-tiny-moe", n_layer=2, **GPT_CFG), device="cpu"))
    whole = {k: v.detach().numpy()
             for k, v in convert.state_to_paddle_tpu(moe).items()}
    mine = convert.slice_expert_state(whole, moe, 2, 1)
    w1 = "gpt.blocks.0.mlp.w1"
    np.testing.assert_array_equal(mine[w1], whole[w1][2:4])
    np.testing.assert_array_equal(mine["gpt.ln_f.weight"],
                                  whole["gpt.ln_f.weight"])

    opt = AdamW(1e-3, parameters=model.parameters())
    loss = gpt.GPTPretrainingCriterion()(
        model(torch.zeros(2, 16, dtype=torch.long)),
        torch.zeros(2, 16, dtype=torch.long))
    loss.backward()
    opt.step()
    full = opt.state_dict()
    cut = convert.slice_zero_state(full, opt, 2, 1)
    emb = "moment1/p0"  # the word embedding [64, 32]: rows 32-63
    np.testing.assert_array_equal(cut[emb].numpy(), full[emb][32:].numpy())
    assert cut["_opt_step"] == 1
