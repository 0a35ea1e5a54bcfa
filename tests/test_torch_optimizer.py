"""The port's optimizers, schedulers and gradient clip against the JAX
package's, on the same numpy parameters and gradients.

Gradients are handed to both sides directly, so each comparison isolates
the update rule. Tolerance: 1e-6 absolute and relative for float32 (the
same float32 operations in the same order; XLA and torch may differ in the
last bit of ``pow`` and ``sqrt``). bf16 parameters are compared after
rounding both sides to bf16, exactly.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.core.tensor import Parameter  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402

TOL = dict(atol=1e-6, rtol=1e-6)
SHAPES = {"w": (5, 4), "b": (4,), "e": (6, 3)}


def _bf16(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


def _arrays(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(s) * scale).astype(np.float32)
            for n, s in SHAPES.items()}


def _grads(step, bf16=False):
    g = _arrays(100 + step, scale=0.1)
    return {n: _bf16(a) if bf16 else a for n, a in g.items()}


def _pair(dtype="float32", named=False):
    """The same parameters as JAX Parameters and torch leaf tensors."""
    init = _arrays(0)
    if dtype == "bfloat16":
        init = {n: _bf16(a) for n, a in init.items()}
    tdt = getattr(torch, dtype)
    jp = {n: Parameter(a, dtype=dtype, name=n if named else None)
          for n, a in init.items()}
    tp = {n: torch.from_numpy(a.copy()).to(tdt).requires_grad_()
          for n, a in init.items()}
    return jp, tp


def _run(jopt, tp, topt_, jp, steps, bf16_grads=False, jsched=None,
         tsched=None):
    for s in range(steps):
        g = _grads(s, bf16_grads)
        for n in SHAPES:
            if jp is not None:
                jg = paddle.to_tensor(g[n])
                jp[n].grad = jg.astype("bfloat16") if bf16_grads else jg
            tp[n].grad = torch.from_numpy(g[n]).to(tp[n].dtype)
        if jopt is not None:
            jopt.step()
            jopt.clear_grad()
        topt_.step()
        topt_.clear_grad()
        for sched in (jsched, tsched):
            if sched is not None:
                sched.step()


def _np(t):
    return np.asarray(t.numpy(), np.float32) if hasattr(t, "numpy") and \
        not isinstance(t, torch.Tensor) else t.detach().float().numpy()


def _close(tp, jp):
    for n in SHAPES:
        np.testing.assert_allclose(_np(tp[n]), _np(jp[n]), **TOL, err_msg=n)


@pytest.mark.parametrize("kind", ["Adam", "AdamW"])
@pytest.mark.parametrize("multi_precision", [False, True])
def test_float32_updates_match(kind, multi_precision):
    jp, tp = _pair()
    kw = dict(learning_rate=0.01, multi_precision=multi_precision)
    if kind == "AdamW":
        kw["weight_decay"] = 0.1
    jopt = getattr(paddle.optimizer, kind)(parameters=list(jp.values()), **kw)
    topt_ = getattr(topt, kind)(parameters=list(tp.values()), **kw)
    _run(jopt, tp, topt_, jp, steps=4)
    _close(tp, jp)
    jsd, tsd = jopt.state_dict(), topt_.state_dict()
    assert sorted(jsd) == sorted(tsd)
    assert tsd["_opt_step"] == jsd["_opt_step"] == 4
    for i, n in enumerate(SHAPES):
        for acc in ("moment1", "moment2"):
            np.testing.assert_allclose(
                tsd[f"{acc}/p{i}"].numpy(), _np(jsd[f"{acc}/p{i}"]), **TOL)


def test_apply_decay_param_fun_takes_the_parameter_name():
    jp, tp = _pair(named=True)
    decay = lambda name: name != "b"  # noqa: E731
    kw = dict(learning_rate=0.05, weight_decay=0.5,
              apply_decay_param_fun=decay)
    jopt = paddle.optimizer.AdamW(parameters=list(jp.values()), **kw)
    topt_ = topt.AdamW(parameters=list(tp.items()), **kw)
    _run(jopt, tp, topt_, jp, steps=3)
    _close(tp, jp)
    # the same run with decay everywhere moves "b" elsewhere
    _, tp2 = _pair()
    every = topt.AdamW(parameters=list(tp2.values()), learning_rate=0.05,
                       weight_decay=0.5)
    _run(None, tp2, every, None, steps=3)
    assert not np.allclose(_np(tp2["b"]), _np(tp["b"]))
    np.testing.assert_allclose(_np(tp2["w"]), _np(tp["w"]), **TOL)


def test_bf16_master_weights_first_step_and_state_keys():
    # one step: identical to the reference, parameters and master weights
    jp, tp = _pair("bfloat16")
    kw = dict(learning_rate=0.01, weight_decay=0.1, multi_precision=True)
    jopt = paddle.optimizer.AdamW(parameters=list(jp.values()), **kw)
    topt_ = topt.AdamW(parameters=list(tp.values()), **kw)
    _run(jopt, tp, topt_, jp, steps=1, bf16_grads=True)
    jsd, tsd = jopt.state_dict(), topt_.state_dict()
    assert sorted(jsd) == sorted(tsd)
    for i, n in enumerate(SHAPES):
        assert tp[n].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(tp[n]), _np(jp[n]))
        np.testing.assert_allclose(tsd[f"master_weight/p{i}"].numpy(),
                                   _np(jsd[f"master_weight/p{i}"]), **TOL)


def test_bf16_master_weights_accumulate_like_float32():
    # several steps: the port's master weight follows a float32 run of the
    # reference fed the same (bf16-valued) gradients; the reference's own
    # bf16 run rebuilds its master from the rounded parameter each step and
    # so ends elsewhere (a fault of the reference, recorded in ROADMAP.md)
    jp32 = {n: Parameter(_bf16(a)) for n, a in _arrays(0).items()}
    _, tp = _pair("bfloat16")
    kw = dict(learning_rate=0.01, weight_decay=0.1)
    jopt = paddle.optimizer.AdamW(parameters=list(jp32.values()), **kw)
    topt_ = topt.AdamW(parameters=list(tp.values()), multi_precision=True,
                       **kw)
    _run(jopt, tp, topt_, jp32, steps=5, bf16_grads=True)
    masters = topt_.state_dict()
    for i, n in enumerate(SHAPES):
        master = masters[f"master_weight/p{i}"]
        np.testing.assert_allclose(master.numpy(), _np(jp32[n]), **TOL)
        assert torch.equal(tp[n].detach(), master.bfloat16())


def test_warmup_cosine_schedule_per_step():
    def pair():
        j = paddle.optimizer.lr.LinearWarmup(
            paddle.optimizer.lr.CosineAnnealingDecay(0.1, T_max=6,
                                                     eta_min=0.01),
            warmup_steps=4, start_lr=0.0, end_lr=0.1)
        t = topt.lr.LinearWarmup(topt.lr.CosineAnnealingDecay(
            0.1, T_max=6, eta_min=0.01), warmup_steps=4, start_lr=0.0,
            end_lr=0.1)
        return j, t

    j, t = pair()
    seen = []
    for _ in range(12):
        assert t() == j()
        seen.append(t())
        j.step()
        t.step()
    assert seen[:4] == pytest.approx([0.0, 0.025, 0.05, 0.075])
    assert 0.01 < seen[-1] < seen[4] < 0.1
    assert t.state_dict() == j.state_dict()
    # the scheduler drives the optimizer's rate, stepped by the caller
    j, t = pair()
    jp, tp = _pair()
    jopt = paddle.optimizer.AdamW(learning_rate=j,
                                  parameters=list(jp.values()))
    topt_ = topt.AdamW(learning_rate=t, parameters=list(tp.values()))
    _run(jopt, tp, topt_, jp, steps=6, jsched=j, tsched=t)
    _close(tp, jp)
    assert topt_.state_dict()["LR_Scheduler"] == \
        jopt.state_dict()["LR_Scheduler"]


@pytest.mark.parametrize("clip_norm", [0.05, 100.0])
def test_global_norm_clip(clip_norm):
    g = _grads(0)
    jpairs = [(None, paddle.to_tensor(a)) for a in g.values()]
    tpairs = [(None, torch.from_numpy(a)) for a in g.values()]
    jout = jnn.ClipGradByGlobalNorm(clip_norm)(jpairs)
    tout = tnn.ClipGradByGlobalNorm(clip_norm)(tpairs)
    for (_, a), (_, b) in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), _np(b), **TOL)
    # as an optimizer's grad_clip
    jp, tp = _pair()
    jopt = paddle.optimizer.Adam(
        learning_rate=0.01, parameters=list(jp.values()),
        grad_clip=jnn.ClipGradByGlobalNorm(clip_norm))
    topt_ = topt.Adam(learning_rate=0.01, parameters=list(tp.values()),
                      grad_clip=tnn.ClipGradByGlobalNorm(clip_norm))
    _run(jopt, tp, topt_, jp, steps=3)
    _close(tp, jp)


def _linear_models(seed=0):
    """A JAX and a torch stack of Linear(4, 4) (square: its slots are told
    apart from untransposed ones only by the model) and Linear(4, 3), with
    the same weights."""
    state = paddle.get_rng_state()
    try:
        paddle.seed(seed)
        jm = jnn.Sequential(jnn.Linear(4, 4), jnn.Linear(4, 3))
    finally:
        paddle.set_rng_state(state)
    tm = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.Linear(4, 3))
    convert.load_paddle_tpu_state(
        tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def _linear_step(jm, tm, jopt, topt_, x):
    jloss = (jm(paddle.to_tensor(x)) ** 2).mean()
    jloss.backward()
    jopt.step()
    jopt.clear_grad()
    tloss = (tm(torch.from_numpy(x)) ** 2).mean()
    tloss.backward()
    topt_.step()
    topt_.clear_grad()


def test_reference_state_resumes_to_the_same_parameters():
    x = np.random.default_rng(7).standard_normal((8, 4)).astype(np.float32)
    jm, tm = _linear_models()
    jopt = paddle.optimizer.AdamW(learning_rate=0.05,
                                  parameters=jm.parameters())
    for _ in range(2):
        jloss = (jm(paddle.to_tensor(x)) ** 2).mean()
        jloss.backward()
        jopt.step()
        jopt.clear_grad()
    # carry the trained weights and the optimizer state across, then one
    # more step on each side
    convert.load_paddle_tpu_state(
        tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    topt_ = topt.AdamW(learning_rate=0.05, parameters=tm.parameters())
    topt_.set_state_dict(convert.optimizer_state_from_paddle_tpu(
        jopt.state_dict(), topt_, tm))
    assert topt_._opt_step == 2
    _linear_step(jm, tm, jopt, topt_, x)
    assert topt_._opt_step == jopt._opt_step == 3
    want = convert.state_from_paddle_tpu(
        {k: v.numpy() for k, v in jm.state_dict().items()}, tm)
    for name, t in tm.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)


def test_optimizer_state_converter_refuses_mismatches():
    jm, tm = _linear_models()
    jopt = paddle.optimizer.AdamW(learning_rate=0.05,
                                  parameters=jm.parameters())
    jopt._ensure_accumulators()
    topt_ = topt.AdamW(learning_rate=0.05, parameters=tm.parameters())
    state = {k: (v if k == "_opt_step" else v.numpy())
             for k, v in jopt.state_dict().items()}
    # the square weight's slot is transposed: check through a non-zero slot
    state["moment1/p0"] = np.arange(16, dtype=np.float32).reshape(4, 4)
    got = convert.optimizer_state_from_paddle_tpu(state, topt_, tm)
    np.testing.assert_array_equal(got["moment1/p0"].numpy(),
                                  state["moment1/p0"].T)
    missing = dict(state)
    del missing["moment2/p3"]
    with pytest.raises(KeyError, match="missing.*moment2/p3"):
        convert.optimizer_state_from_paddle_tpu(missing, topt_, tm)
    with pytest.raises(KeyError, match="extra.*master_weight/p0"):
        convert.optimizer_state_from_paddle_tpu(
            dict(state, **{"master_weight/p0": state["moment1/p0"]}),
            topt_, tm)
    bad = dict(state, **{"moment1/p2": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="moment1/p2"):
        convert.optimizer_state_from_paddle_tpu(bad, topt_, tm)
