"""``fleet.HybridParallelEngine`` of the port (1F1B) against the JAX
package's: ``gpt2-tiny`` at pp 2, GPipe against 1F1B, the generic mode
(no block stack) at dp 2 x sharding 2, the live-input bound of 1F1B and
``train_batch(scaler=)`` (the ``PipelineLayer`` path and the
heterogeneous split are in ``tests/test_torch_hybrid_engine_layers.py``).

The reference engine runs on the 8 virtual CPU devices; the port as a
``testing.world.World`` of gloo ranks. float32; tolerance 1e-5 on the
losses of 4 AdamW steps and on the merged parameters.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.distributed import fleet as jfleet  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402

from torch_pp_parity import (TOL, V, assert_states_close, batch,  # noqa: E402
                             make_worlds, ref_fleet, ref_gpt, rng_guard,
                             state_np)

torch.set_num_threads(1)

STEPS = 4


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


# ------------------------------------------------------------- GPT, 1F1B ---
def _port_gpt(init):
    import torch
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models import gpt

    cfg = gpt.GPTConfig.preset("gpt2-tiny", n_layer=2, vocab_size=V,
                               seq_len=16, dropout=0.0, n_head=2, d_model=32)
    model = gpt.GPTForPretraining(gpt.GPTModel(
        cfg, device="cpu", generator=torch.Generator().manual_seed(5)))
    convert.load_paddle_tpu_state(model, init)
    return model


def _rank_engine(init, toks, labels, kind, M, scale=None):
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.pp_spmd import PipelineSpmdStep
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.optimizer import AdamW

    strategy, hcg = _fleet(pp=2, M=M)
    model = _port_gpt(init)
    opt = AdamW(1e-3, parameters=model.parameters())
    crit = gpt.GPTPretrainingCriterion()
    scaler = None if scale is None else GradScaler(init_loss_scaling=scale)
    if kind == "gpipe":
        step = PipelineSpmdStep(model, opt, criterion=crit)
        losses = [float(step.train_batch([toks, labels]))
                  for _ in range(STEPS)]
    else:
        step = fleet.HybridParallelEngine(model, opt, hcg, strategy, crit)
        losses = [float(step.train_batch([toks, labels], scaler=scaler))
                  for _ in range(STEPS)]
    out = dict(losses=losses, state=_ref_layout(model, step.state_dict()),
               live=step.runner.live_max)
    if scaler is not None:
        sc = step.sync_scaler()
        out["scaler"] = (sc._scale, sc._good_steps, sc._bad_steps)
    return out


def _ref_engine(M, scale=None):
    with rng_guard():
        strategy, hcg = ref_fleet(pp=2, M=M)
        model, init = ref_gpt()
        opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters())
        engine = jfleet.HybridParallelEngine(
            model, opt, hcg, strategy, jgpt.GPTPretrainingCriterion())
        scaler = None if scale is None else paddle.amp.GradScaler(
            init_loss_scaling=scale)
        toks, labels = batch()
        losses = [float(engine.train_batch([toks, labels], scaler=scaler))
                  for _ in range(STEPS)]
        engine.sync_params_to_model()
        out = dict(init=init, losses=losses, state=state_np(model))
        if scaler is not None:
            sc = engine.sync_scaler()
            out["scaler"] = (sc._scale, sc._good_steps, sc._bad_steps)
        return out


@pytest.fixture(scope="module")
def ref_1f1b():
    return _ref_engine(M=4)


def test_1f1b_matches_the_reference_engine_and_gpipe(worlds, ref_1f1b):
    toks, labels = batch()
    init = ref_1f1b["init"]
    f1b = worlds(2).run(_rank_engine, init, toks, labels, "1f1b", 4)
    gpipe = worlds(2).run(_rank_engine, init, toks, labels, "gpipe", 4)
    for r in f1b:
        np.testing.assert_allclose(r["losses"], ref_1f1b["losses"], **TOL)
        assert_states_close(r["state"], ref_1f1b["state"])
    np.testing.assert_allclose([r["losses"] for r in gpipe],
                               [r["losses"] for r in f1b], **TOL)
    # in-flight microbatches: 1F1B holds at most 2(pp-1-s)+1 <= 2pp-1 on
    # stage s; GPipe holds all M
    assert [r["live"] for r in f1b] == [3, 1]
    assert max(r["live"] for r in f1b) <= 2 * 2 - 1
    assert [r["live"] for r in gpipe] == [4, 4]


def test_grad_scaler_matches_the_reference_engine(worlds):
    ref = _ref_engine(M=2, scale=2.0 ** 10)
    toks, labels = batch()
    got = worlds(2).run(_rank_engine, ref["init"], toks, labels, "1f1b", 2,
                        2.0 ** 10)
    for r in got:
        np.testing.assert_allclose(r["losses"], ref["losses"], **TOL)
        assert r["scaler"] == ref["scaler"]
        assert_states_close(r["state"], ref["state"])


# ---------------------------------------------------------- generic mode ---
def _rank_generic(init, X, Y, dp, sharding, pp):
    import torch
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import AdamW

    strategy, hcg = _fleet(dp=dp, pp=pp, sharding=sharding, M=1)
    mlp = _mlp()
    convert.load_paddle_tpu_state(mlp, init)
    opt = AdamW(1e-2, parameters=mlp.parameters())
    engine = fleet.HybridParallelEngine(
        mlp, opt, hcg, strategy,
        criterion=lambda out, y: ((out - y) * (out - y)).mean())
    try:
        return [float(engine.train_batch([X, Y])) for _ in range(5)]
    except ValueError as e:
        return str(e)


def _mlp():
    import torch

    class Mlp(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a = torch.nn.Linear(16, 32)
            self.b = torch.nn.Linear(32, 8)
            self.c = torch.nn.Linear(8, 1)

        def forward(self, x):
            return self.c(torch.relu(self.b(torch.relu(self.a(x)))))

    return Mlp()


class _JMlp(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.a = jnn.Linear(16, 32)
        self.b = jnn.Linear(32, 8)
        self.c = jnn.Linear(8, 1)

    def forward(self, x):
        from paddle_tpu.nn import functional as F

        return self.c(F.relu(self.b(F.relu(self.a(x)))))


def test_generic_mode_matches_the_reference_at_dp2_sharding2(worlds):
    rng = np.random.default_rng(4)
    X = rng.normal(size=(16, 16)).astype(np.float32)
    Y = (X @ rng.normal(size=(16, 1))).astype(np.float32)
    with rng_guard():
        paddle.seed(9)
        strategy, hcg = ref_fleet(dp=2, sharding=2)
        model = _JMlp()
        init = state_np(model)
        opt = paddle.optimizer.AdamW(1e-2, parameters=model.parameters())
        engine = jfleet.HybridParallelEngine(
            model, opt, hcg, strategy,
            criterion=lambda o, y: ((o - y) * (o - y)).mean())
        losses = [float(engine.train_batch([X, Y])) for _ in range(5)]
    got = worlds(4).run(_rank_generic, init, X, Y, 2, 2, 1)
    for r in got:
        np.testing.assert_allclose(r, losses, **TOL)
    refused = worlds(2).run(_rank_generic, init, X, Y, 1, 1, 2)
    assert "pipeline parallelism" in refused[0]


# ------------------------------------- distributed_model's choice of form ---
# the form without an optimizer comes first: the reference's fleet.init
# keeps the optimizer of an earlier distributed_optimizer call (ROADMAP
# queue 3), the port's forgets it
FORMS = (("hybrid, no optimizer", {"sharding_degree": 2}, False),
         ("dp", {"dp_degree": 2}, True),
         ("hybrid", {"sharding_degree": 2}, True),
         ("use_spmd", {"pp_degree": 2, "use_spmd": True}, True))


def _forms(fleet, make_model, make_opt, strategy_cls):
    """``{form: (what distributed_model returned, whether an engine got
    the inner optimizer, whether the wrapper's inner_opt is it, the flags
    distributed_optimizer warned about)}`` for each of ``FORMS``, in
    whichever package ``fleet`` is."""
    import warnings

    out = {}
    for name, hc, known in FORMS:
        s = strategy_cls()
        s.hybrid_configs = dict({"use_spmd": False}, **hc)
        s.lars = True
        fleet.init(is_collective=True, strategy=s)
        model = make_model()
        opt = make_opt(model)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            wrapped = fleet.distributed_optimizer(opt) if known else opt
        got = fleet.distributed_model(model)
        out[name] = ("model" if got is model else type(got).__name__,
                     getattr(got, "optimizer", None) is opt,
                     getattr(wrapped, "inner_opt", None) is opt,
                     [str(w.message).split(" ")[0] for w in caught])
    return out


def _rank_forms():
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import AdamW

    return _forms(fleet, _mlp,
                  lambda m: AdamW(1e-2, parameters=m.parameters()),
                  fleet.DistributedStrategy)


def test_distributed_model_picks_the_form_as_the_reference(worlds):
    # dp only: DataParallel; hybrid with distributed_optimizer's optimizer
    # known: the engine over the inner optimizer; hybrid without one, or
    # use_spmd: the model itself, sharded in place
    got = worlds(2).run(_rank_forms)
    jfleet._fleet_state.pop("optimizer", None)  # another test's
    with rng_guard():
        want = _forms(jfleet, _JMlp, lambda m: paddle.optimizer.AdamW(
            1e-2, parameters=m.parameters()), jfleet.DistributedStrategy)
    assert got[0] == got[1] == want
    assert [want[n][0] for n, _, _ in FORMS] == [
        "model", "DataParallel", "HybridParallelEngine", "model"]
    assert want["hybrid"][1:3] == (True, True)
    assert want["dp"][3] == ["DistributedStrategy.lars"]


def test_distributed_optimizer_wrapper_writes_reach_the_optimizer():
    # a replayed TrainStep advances ``_opt_step`` on the optimizer it was
    # given: kept on the wrapper, the optimizer's own count (and the state
    # it saves) would go stale
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import AdamW

    saved = dict(fleet._fleet_state)
    try:
        opt = AdamW(1e-2, parameters=_mlp().parameters())
        wrapped = fleet.distributed_optimizer(opt)
        wrapped._opt_step += 3
        assert opt._opt_step == wrapped._opt_step == 3
        assert "_opt_step" not in vars(wrapped)
    finally:
        fleet._fleet_state.clear()
        fleet._fleet_state.update(saved)
