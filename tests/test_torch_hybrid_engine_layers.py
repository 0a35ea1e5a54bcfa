"""``fleet.HybridParallelEngine`` of the port (1F1B) against the JAX
package's on layer lists: the ``PipelineLayer`` path with a
``SharedLayerDesc`` used on both stages, and the heterogeneous
``stage_layers`` split (alone and inside dp 2 x sharding 2) with its
refusals. The reference engine runs on the 8 virtual CPU devices; the
port as a ``testing.world.World`` of gloo ranks. float32; tolerance 1e-5
on the losses of 3 AdamW steps and on the merged parameters.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu import ops as jops  # noqa: E402
from paddle_tpu.distributed import fleet as jfleet  # noqa: E402
from paddle_tpu.distributed.meta_parallel import pp_layers as jpl  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402

from torch_pp_parity import (TOL, V, assert_states_close,  # noqa: E402
                             make_worlds, ref_fleet, rng_guard, state_np)

torch.set_num_threads(1)

D, TT = 16, 8


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    get, close = make_worlds(tmp_path_factory)
    yield get
    close()


def _fleet(dp=1, pp=1, sharding=1, mp=1, M=2):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp,
                        "sharding_degree": sharding}
    s.pipeline_configs = {"accumulate_steps": M}
    fleet.init(is_collective=True, strategy=s)
    return s, fleet.get_hybrid_communicate_group()


def _ref_layout(model, state):
    from paddle_tpu_torch import convert

    linear = convert._linear_weight_names(model)
    return {k: (v.t() if k in linear else v).numpy()
            for k, v in state.items()}


# --------------------------------------------------------- PipelineLayer ---
def _embed_fwd(layer, x):
    return layer(x)


def _jhead(layer, x):
    return jops.matmul(x, layer.weight, transpose_y=True)


def _thead(layer, x):
    return x @ layer.weight.t()


class _JBlock(jnn.Layer):
    def __init__(self, d):
        super().__init__()
        self.ln = jnn.LayerNorm(d)
        self.fc1 = jnn.Linear(d, 2 * d)
        self.fc2 = jnn.Linear(2 * d, d)

    def forward(self, x):
        from paddle_tpu.nn import functional as F

        return x + self.fc2(F.relu(self.fc1(self.ln(x))))


def _tblock_cls():
    import torch

    class Block(torch.nn.Module):
        def __init__(self, d):
            super().__init__()
            self.ln = torch.nn.LayerNorm(d)
            self.fc1 = torch.nn.Linear(d, 2 * d)
            self.fc2 = torch.nn.Linear(2 * d, d)

        def forward(self, x):
            return x + self.fc2(torch.relu(self.fc1(self.ln(x))))

    return Block


def _port_pipeline_layer(n_blocks, init):
    import torch
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed.meta_parallel import pp_layers as tpl

    Block = _tblock_cls()
    model = tpl.PipelineLayer([
        tpl.SharedLayerDesc("embed", torch.nn.Embedding, V, D,
                            forward_func=_embed_fwd),
        *[tpl.LayerDesc(Block, D) for _ in range(n_blocks)],
        tpl.LayerDesc(torch.nn.LayerNorm, D),
        tpl.SharedLayerDesc("embed", torch.nn.Embedding, V, D,
                            forward_func=_thead)], num_stages=2)
    convert.load_paddle_tpu_state(model, init)
    return model


def _rank_pipeline_layer(init, n_blocks, toks, labels):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import AdamW

    strategy, hcg = _fleet(pp=2, M=4)
    model = _port_pipeline_layer(n_blocks, init)
    opt = AdamW(1e-3, parameters=model.parameters())
    engine = fleet.HybridParallelEngine(model, opt, hcg, strategy)
    losses = [float(engine.train_batch([toks, labels])) for _ in range(3)]
    emb = model._shared["embed"].weight.detach().numpy().copy()
    return dict(losses=losses, emb=emb,
                state=_ref_layout(model, engine.state_dict()))


def _pl_batch():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, V, (8, TT)).astype(np.int64)
    return toks, np.roll(toks, -1, 1)


@pytest.mark.parametrize("n_blocks", [4, 5])
def test_pipeline_layer_with_a_shared_layer_matches_the_reference(
        worlds, n_blocks):
    toks, labels = _pl_batch()
    with rng_guard():
        paddle.seed(7)
        strategy, hcg = ref_fleet(pp=2, M=4)
        model = jpl.PipelineLayer([
            jpl.SharedLayerDesc("embed", jnn.Embedding, V, D,
                                forward_func=_embed_fwd),
            *[jpl.LayerDesc(_JBlock, D) for _ in range(n_blocks)],
            jpl.LayerDesc(jnn.LayerNorm, D),
            jpl.SharedLayerDesc("embed", jnn.Embedding, V, D,
                                forward_func=_jhead)], num_stages=2)
        init = state_np(model)
        opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters())
        engine = jfleet.HybridParallelEngine(model, opt, hcg, strategy)
        losses = [float(engine.train_batch([toks, labels]))
                  for _ in range(3)]
        engine.sync_params_to_model()
        final = state_np(model)
    got = worlds(2).run(_rank_pipeline_layer, init, n_blocks, toks, labels)
    for r in got:
        np.testing.assert_allclose(r["losses"], losses, **TOL)
        assert_states_close(r["state"], final)
    # the shared table, used on both stages, is one weight kept equal
    np.testing.assert_array_equal(got[0]["emb"], got[1]["emb"])


# ------------------------------------------------------- heterogeneous ---
def _port_het(init):
    import torch
    from paddle_tpu_torch import convert

    Block = _tblock_cls()

    class Het(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = torch.nn.Embedding(V, D)
            self.front = Block(D)
            self.mid = torch.nn.Linear(D, 3 * D)
            self.act = torch.nn.Tanh()
            self.back = torch.nn.Linear(3 * D, D)
            self.ln = torch.nn.LayerNorm(D)

        def stage_groups(self):
            return [[self.embed, self.front],
                    [self.mid, self.act, self.back, self.ln]]

    model = Het()
    convert.load_paddle_tpu_state(model, init)
    return model


def _rank_het(init, toks, labels, dp, sharding, split):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.optimizer import AdamW

    strategy, hcg = _fleet(dp=dp, pp=2, sharding=sharding, M=4)
    model = _port_het(init)
    ce = gpt.GPTPretrainingCriterion()

    def criterion(out, lab):
        return ce(out @ model.embed.weight.t(), lab)

    groups = model.stage_groups()
    if split == "mismatch":
        groups = [groups[0], groups[1] + [model.mid]]
    elif split == "uncovered":
        groups = [groups[0], groups[1][:3]]
    opt = AdamW(1e-3, parameters=model.parameters())
    engine = fleet.HybridParallelEngine(model, opt, hcg, strategy,
                                        criterion=criterion,
                                        stage_layers=groups)
    try:
        losses = [float(engine.train_batch([toks, labels]))
                  for _ in range(3)]
    except ValueError as e:
        return str(e)
    return dict(losses=losses, state=_ref_layout(model, engine.state_dict()))


class _JHet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.embed = jnn.Embedding(V, D)
        self.front = _JBlock(D)
        self.mid = jnn.Linear(D, 3 * D)
        self.act = jnn.Tanh()
        self.back = jnn.Linear(3 * D, D)
        self.ln = jnn.LayerNorm(D)

    def stage_groups(self):
        return [[self.embed, self.front],
                [self.mid, self.act, self.back, self.ln]]


def _ref_het():
    rng = np.random.default_rng(1)
    toks = rng.integers(0, V, (16, TT)).astype(np.int64)
    labels = np.roll(toks, -1, 1)
    with rng_guard():
        paddle.seed(11)
        strategy, hcg = ref_fleet(pp=2, M=4)
        model = _JHet()
        init = state_np(model)
        ce = jgpt.GPTPretrainingCriterion()

        def criterion(out, lab):
            return ce(jops.matmul(out, model.embed.weight, transpose_y=True),
                      lab)

        opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters())
        engine = jfleet.HybridParallelEngine(
            model, opt, hcg, strategy, criterion=criterion,
            stage_layers=model.stage_groups())
        losses = [float(engine.train_batch([toks, labels]))
                  for _ in range(3)]
        engine.sync_params_to_model()
        return init, toks, labels, losses, state_np(model)


def test_heterogeneous_split_matches_the_reference(worlds):
    init, toks, labels, losses, final = _ref_het()
    got = worlds(2).run(_rank_het, init, toks, labels, 1, 1, "ok")
    for r in got:
        np.testing.assert_allclose(r["losses"], losses, **TOL)
        assert_states_close(r["state"], final)
    # with dp 2 x sharding 2 around the same split: the same trajectory
    wide = worlds(8).run(_rank_het, init, toks, labels, 2, 2, "ok")
    np.testing.assert_allclose(wide[0]["losses"], losses, **TOL)
    assert_states_close(wide[0]["state"], final)
    assert "boundary shape" in worlds(2).run(
        _rank_het, init, toks, labels, 1, 1, "mismatch")[0]
    assert "does not cover" in worlds(2).run(
        _rank_het, init, toks, labels, 1, 1, "uncovered")[0]
