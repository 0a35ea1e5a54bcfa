"""BASELINE config 4's axes at ``gpt2-tiny`` size: mp 2 x pp 2 x
sharding 2 (ZeRO ``os_g``) as one 8-rank world of the port through
``fleet.HybridParallelEngine`` (1F1B), against the reference's engine on
its 8 virtual devices.

The reference trains behind ZeRO stage 1 over its sharding axis: behind
``group_sharded_parallel`` its engine writes stale trunk weights back
(ROADMAP queue 3), and its losses are the same either way. float32;
tolerance 1e-5 on the losses of 4 AdamW steps and on the merged
parameters.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.distributed import fleet as jfleet  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402

from torch_pp_parity import (GPT_CFG, TOL, assert_states_close, batch,  # noqa: E402
                             make_worlds, ref_fleet, ref_gpt, rng_guard,
                             state_np)

torch.set_num_threads(1)

STEPS, MP, PP, SH = 4, 2, 2, 2


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    get, close = make_worlds(tmp_path_factory, timeout=90)
    yield get
    close()


def _rank_config4(init, toks, labels):
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.optimizer import AdamW

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"mp_degree": MP, "pp_degree": PP,
                        "sharding_degree": SH}
    s.pipeline_configs = {"accumulate_steps": 2}
    fleet.init(is_collective=True, strategy=s)
    hcg = fleet.get_hybrid_communicate_group()
    cfg = gpt.GPTConfig.preset("gpt2-tiny", n_layer=2, **GPT_CFG)
    model = gpt.GPTForPretraining(gpt.GPTModel(cfg, device="cpu"))
    fleet.distributed_model(model)  # the mp slices (no optimizer yet)
    convert.load_paddle_tpu_state(model, init)
    opt = AdamW(1e-3, parameters=model.parameters())
    model, opt, _ = group_sharded_parallel(model, opt, "os_g")
    engine = fleet.HybridParallelEngine(model, opt, hcg, s,
                                        gpt.GPTPretrainingCriterion())
    losses = [float(engine.train_batch([toks, labels]))
              for _ in range(STEPS)]
    inner = model._layers
    state = engine.state_dict()
    linear = convert._linear_weight_names(inner)
    return dict(losses=losses, live=engine.live_inputs_max,
                coord=(hcg.get_stage_id(), hcg.get_sharding_parallel_rank(),
                       hcg.get_model_parallel_rank()),
                state={k: (v.t() if k in linear else v).numpy()
                       for k, v in state.items()})


def test_mp2_pp2_sharding2_matches_the_reference_engine(worlds):
    with rng_guard():
        strategy, hcg = ref_fleet(mp=MP, pp=PP, sharding=SH, M=2)
        model, init = ref_gpt()
        opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters())
        engine = jfleet.HybridParallelEngine(
            model, opt, hcg, strategy, jgpt.GPTPretrainingCriterion())
        toks, labels = batch()
        losses = [float(engine.train_batch([toks, labels]))
                  for _ in range(STEPS)]
        engine.sync_params_to_model()
        final = state_np(model)
    got = worlds(8).run(_rank_config4, init, toks, labels)
    assert sorted(r["coord"] for r in got) == sorted(
        (p, s, m) for p in range(PP) for s in range(SH) for m in range(MP))
    for r in got:
        np.testing.assert_allclose(r["losses"], losses, **TOL)
        assert_states_close(r["state"], final)
        assert r["live"] <= 2 * PP - 1
