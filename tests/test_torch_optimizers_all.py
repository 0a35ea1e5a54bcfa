"""Every optimizer of the port beside Adam/AdamW against the JAX package's,
with the regularizers, the per-parameter rate and the two per-gradient
clips, on the same numpy parameters and float32 gradients.

SGD, Momentum (plain and Nesterov), Lars, Adamax, Adagrad, Adadelta,
RMSProp (plain and centered with momentum) and Lamb each take 5 steps in
both packages; parameter ``w`` carries ``optimize_attr = {"learning_rate":
0.5}``. Tolerance: parameters and every slot within 2e-6 (absolute and
relative) of the reference's: the same float32 operations in the same
order, where XLA and torch may differ in the last bit of ``pow``,
``sqrt`` and a reduction's order. Then the state: ``state_dict`` keys
equal the reference's, and a reference state resumes in the port (and
the port's in the reference) through ``convert`` with the same next steps.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.nn import clip as jclip  # noqa: E402
from paddle_tpu import regularizer as jreg  # noqa: E402
from paddle_tpu.core.tensor import Parameter  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch import regularizer as treg  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

TOL = dict(atol=2e-6, rtol=2e-6)
SHAPES = {"w": (5, 4), "b": (4,), "e": (6, 3)}
W_RATE = 0.5

# name -> (reference class, port class, keyword arguments)
OPTIMIZERS = {
    "SGD": ("SGD", dict(learning_rate=0.1)),
    "Momentum": ("Momentum", dict(learning_rate=0.1, momentum=0.9)),
    "Momentum-nesterov": ("Momentum", dict(learning_rate=0.1, momentum=0.9,
                                           use_nesterov=True)),
    "Lars": ("Lars", dict(learning_rate=0.5, momentum=0.9, lars_coeff=0.01,
                          lars_weight_decay=0.01)),
    "Adamax": ("Adamax", dict(learning_rate=0.01)),
    "Adagrad": ("Adagrad", dict(learning_rate=0.05,
                                initial_accumulator_value=0.1)),
    "Adadelta": ("Adadelta", dict(learning_rate=1.0, rho=0.9)),
    "RMSProp": ("RMSProp", dict(learning_rate=0.01, rho=0.9)),
    "RMSProp-centered": ("RMSProp", dict(learning_rate=0.01, rho=0.9,
                                         momentum=0.5, centered=True)),
    "Lamb": ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.02)),
}
# optimizers whose constructor takes no weight_decay (the reference's too)
NO_DECAY = {"Lars", "Lamb"}
SLOTS = {"SGD": [], "Momentum": ["velocity"], "Lars": ["velocity"],
         "Adamax": ["moment", "inf_norm"], "Adagrad": ["moment"],
         "Adadelta": ["avg_squared_grad", "avg_squared_update"],
         "RMSProp": ["mean_square", "mean_grad", "velocity"],
         "Lamb": ["moment1", "moment2"]}

DECAYS = {
    "none": lambda mod: None,
    "float": lambda mod: 0.02,
    "L1": lambda mod: mod.L1Decay(0.01),
    "L2": lambda mod: mod.L2Decay(0.03),
}
CLIPS = {
    "value": lambda mod: mod.ClipGradByValue(0.05),
    "norm": lambda mod: mod.ClipGradByNorm(0.1),
}


def _arrays(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(s) * scale).astype(np.float32)
            for n, s in SHAPES.items()}


def _pair(init=None):
    init = init or _arrays(0)
    jp = {n: Parameter(a.copy()) for n, a in init.items()}
    tp = {n: torch.from_numpy(a.copy()).requires_grad_()
          for n, a in init.items()}
    jp["w"].optimize_attr = {"learning_rate": W_RATE}
    tp["w"].optimize_attr = {"learning_rate": W_RATE}
    return jp, tp


def _build(name, jp, tp, decay="none", clip=None):
    cls, kw = OPTIMIZERS[name]
    kw = dict(kw)
    jkw, tkw = dict(kw), dict(kw)
    if decay != "none":
        jkw["weight_decay"] = DECAYS[decay](jreg)
        tkw["weight_decay"] = DECAYS[decay](treg)
    if clip is not None:
        jkw["grad_clip"] = CLIPS[clip](jnn)
        tkw["grad_clip"] = CLIPS[clip](tnn)
    jopt = getattr(paddle.optimizer, cls)(parameters=list(jp.values()),
                                          **jkw)
    topt_ = getattr(topt, cls)(parameters=list(tp.values()), **tkw)
    return jopt, topt_


def _holder(tp):
    # the module that holds the port's parameters: no Linear, so no slot
    # is transposed by convert
    return torch.nn.ParameterDict(tp)


def _stand_in():
    # parameters for the side of _build a test does not use
    return {k: torch.zeros(s, requires_grad=True) for k, s in SHAPES.items()}


def _steps(jopt, jp, topt_, tp, first, n):
    for s in range(first, first + n):
        g = _arrays(100 + s, scale=0.1)
        for k in SHAPES:
            if jopt is not None:
                jp[k].grad = paddle.to_tensor(g[k])
            if topt_ is not None:
                tp[k].grad = torch.from_numpy(g[k])
        for o in (jopt, topt_):
            if o is not None:
                o.step()
                o.clear_grad()


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.asarray(v.numpy() if hasattr(v, "numpy") else v, np.float32)


def _same_state(jopt, jp, topt_, tp, what):
    for k in SHAPES:
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), **TOL,
                                   err_msg=f"{what}: parameter {k}")
    jsd, tsd = jopt.state_dict(), topt_.state_dict()
    assert sorted(jsd) == sorted(tsd), what
    for key, v in jsd.items():
        if key == "_opt_step":
            assert tsd[key] == v
        elif key != "LR_Scheduler":
            np.testing.assert_allclose(_np(tsd[key]), _np(v), **TOL,
                                       err_msg=f"{what}: slot {key}")


def _cases():
    for name in OPTIMIZERS:
        decays = ["none"] if name.split("-")[0] in NO_DECAY else list(DECAYS)
        for decay in decays:
            yield name, decay, None
        for clip in CLIPS:
            yield name, "none", clip


@pytest.mark.parametrize("name,decay,clip", list(_cases()))
def test_five_steps_match_the_reference(name, decay, clip):
    jp, tp = _pair()
    jopt, topt_ = _build(name, jp, tp, decay, clip)
    _steps(jopt, jp, topt_, tp, 0, 5)
    _same_state(jopt, jp, topt_, tp, f"{name} decay={decay} clip={clip}")
    cls = OPTIMIZERS[name][0]
    want = {f"{acc}/p{i}" for acc in SLOTS[cls] for i in range(len(SHAPES))}
    assert set(topt_.state_dict()) - {"_opt_step"} == want


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_state_converts_both_ways_and_resumes(name):
    # the reference's state after 3 steps resumes in a fresh port
    # optimizer (and the port's in a fresh reference optimizer): 2 more
    # steps on each side then agree with an uninterrupted reference run
    jp, _ = _pair()
    jopt, _ = _build(name, jp, _stand_in())
    _steps(jopt, jp, None, None, 0, 3)
    mid = {k: _np(p).copy() for k, p in jp.items()}
    mid_state = {k: (_np(v).copy() if k not in ("_opt_step",
                                                "LR_Scheduler") else v)
                 for k, v in jopt.state_dict().items()}

    _, tp = _pair(mid)
    _, topt_ = _build(name, {k: Parameter(v) for k, v in mid.items()}, tp)
    topt_.set_state_dict(convert.optimizer_state_from_paddle_tpu(
        mid_state, topt_, _holder(tp)))
    assert topt_._opt_step == 3
    _steps(jopt, jp, topt_, tp, 3, 2)
    _same_state(jopt, jp, topt_, tp, f"{name} resumed in the port")

    # and back: the port's state into a fresh reference optimizer
    jp2, _ = _pair({k: _np(t) for k, t in tp.items()})
    jopt2, _ = _build(name, jp2, _stand_in())
    back = convert.optimizer_state_to_paddle_tpu(topt_, _holder(tp))
    # the reference restores only slots that exist, and creates them at a
    # parameter's first update (only its Adam creates them ahead)
    plist = list(jp2.values())
    for key in back:
        if "/p" in key:
            acc, _, i = key.rpartition("/p")
            jopt2._acc(acc, plist[int(i)])
    jopt2.set_state_dict({k: (_np(v) if isinstance(v, torch.Tensor) else v)
                          for k, v in back.items()})
    _steps(jopt2, jp2, topt_, tp, 5, 2)
    _same_state(jopt2, jp2, topt_, tp, f"{name} resumed in the reference")


def test_converter_refuses_a_state_of_another_optimizer():
    jp, tp = _pair()
    jopt, _ = _build("Adamax", jp, _stand_in())
    jopt._ensure_accumulators()
    _, mom = _build("Momentum", {k: Parameter(v) for k, v in
                                 _arrays(0).items()}, tp)
    with pytest.raises(KeyError, match="velocity"):
        convert.optimizer_state_from_paddle_tpu(
            {k: (_np(v) if k != "_opt_step" else v)
             for k, v in jopt.state_dict().items()}, mom, _holder(tp))


@pytest.mark.parametrize("kind", ["value", "norm"])
def test_clip_alone_matches_and_respects_need_clip(kind):
    g = _arrays(7)
    jpairs = [(Parameter(a), paddle.to_tensor(a)) for a in g.values()]
    tps = [torch.from_numpy(a).requires_grad_() for a in g.values()]
    tps[1].need_clip = False
    jpairs[1][0].need_clip = False
    tpairs = [(p, torch.from_numpy(a)) for p, a in zip(tps, g.values())]
    jout = CLIPS[kind](jnn)(jpairs)
    tout = CLIPS[kind](tnn)(tpairs)
    for (_, a), (_, b) in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), _np(b), **TOL)
    assert tout[1][1] is tpairs[1][1]


def test_functional_clips_set_the_gradients_in_place():
    g = _arrays(8)
    for fn, jfn, arg in ((tnn.clip_grad_norm_, jclip.clip_grad_norm_, 0.5),
                         (tnn.clip_grad_value_, jclip.clip_grad_value_, 0.3)):
        tps = [torch.zeros(a.shape, requires_grad=True) for a in g.values()]
        jps = [Parameter(np.zeros(a.shape, np.float32)) for a in g.values()]
        for t, j, a in zip(tps, jps, g.values()):
            t.grad = torch.from_numpy(a.copy())
            j.grad = paddle.to_tensor(a)
        assert fn(tps, arg) is None
        jfn(jps, arg)
        for t, j in zip(tps, jps):
            np.testing.assert_allclose(t.grad.numpy(), _np(j.grad), **TOL)


def test_float_weight_decay_is_l2_and_a_parameter_regularizer_wins():
    jp, tp = _pair()
    jp["b"].regularizer = jreg.L1Decay(0.5)
    tp["b"].regularizer = treg.L1Decay(0.5)
    jopt = paddle.optimizer.SGD(learning_rate=0.1, weight_decay=0.02,
                                parameters=list(jp.values()))
    topt_ = topt.SGD(learning_rate=0.1, weight_decay=0.02,
                     parameters=list(tp.values()))
    assert isinstance(topt_._weight_decay, treg.L2Decay)
    _steps(jopt, jp, topt_, tp, 0, 3)
    _same_state(jopt, jp, topt_, tp, "SGD with a parameter regularizer")


def test_set_lr_minimize_and_lars_exclusion():
    jp, tp = _pair()
    jopt = paddle.optimizer.Lars(learning_rate=0.5, lars_coeff=0.01,
                                 parameters=list(jp.values()),
                                 exclude_from_weight_decay=["b"])
    jp_named = dict(jp)
    for k, p in jp_named.items():
        p.name = k
    topt_ = topt.Lars(learning_rate=0.5, lars_coeff=0.01,
                      parameters=list(tp.items()),
                      exclude_from_weight_decay=["b"])
    for o in (jopt, topt_):
        o.set_lr(0.25)
        assert o.get_lr() == 0.25
    x = np.arange(4, dtype=np.float32)
    jloss = (paddle.matmul(jp["w"], paddle.to_tensor(x)).sum()
             + jp["b"].sum() + jp["e"].sum())
    tloss = (tp["w"] @ torch.from_numpy(x)).sum() + tp["b"].sum() + \
        tp["e"].sum()
    jopt.minimize(jloss)
    _, pairs = topt_.minimize(tloss)
    assert len(pairs) == 3
    for k in SHAPES:
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), **TOL,
                                   err_msg=k)
