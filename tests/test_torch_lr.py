"""The port's fifteen learning-rate schedulers against the JAX package's.

Each runs 50 steps in both packages (ReduceOnPlateau fed one loss
sequence) and the rates must agree to 1e-12: both are the same Python
arithmetic in double precision. A ``state_dict`` round trip into a fresh
scheduler at step 25 must then continue exactly as the uninterrupted run.
"""
import math

import numpy as np
import pytest

pytest.importorskip("jax")

from paddle_tpu.optimizer import lr as jlr  # noqa: E402
from paddle_tpu_torch.optimizer import lr as tlr  # noqa: E402

STEPS, MID = 50, 25
LOSSES = [float(x) for x in 2.0 + np.cumsum(
    np.random.default_rng(0).standard_normal(STEPS) * 0.05)]


def _lambda(epoch):
    return 0.97 ** epoch


def _mult(epoch):
    return 0.95 if epoch % 3 else 0.99


# name -> factory(module) building the scheduler
SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=512, warmup_steps=10,
                                       learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([10, 20, 35],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.1, gamma=0.05),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.1, gamma=0.2),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, decay_steps=30,
                                                   end_lr=0.001, power=2.0),
    "PolynomialDecay-cycle": lambda m: m.PolynomialDecay(
        0.1, decay_steps=12, end_lr=0.001, power=1.5, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(0.1, warmup_steps=10,
                                             start_lr=0.0, end_lr=0.1),
    "LinearWarmup-cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.1, T_max=30, eta_min=0.001),
        warmup_steps=10, start_lr=0.0, end_lr=0.1),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.1, gamma=0.93),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.1, [8, 19, 33],
                                                 gamma=0.3),
    "StepDecay": lambda m: m.StepDecay(0.1, step_size=7, gamma=0.5),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, _lambda),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(0.1, _mult),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(
        0.1, factor=0.5, patience=2, threshold=1e-3, cooldown=1,
        min_lr=0.005),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.1, T_max=20, eta_min=0.002),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, total_steps=40),
    "CyclicLR": lambda m: m.CyclicLR(0.001, 0.1, step_size_up=6,
                                     step_size_down=9),
    "CyclicLR-triangular2": lambda m: m.CyclicLR(
        0.001, 0.1, step_size_up=5, mode="triangular2"),
    "CyclicLR-exp_range": lambda m: m.CyclicLR(
        0.001, 0.1, step_size_up=5, mode="exp_range", exp_gamma=0.98),
}


def _advance(sched, i):
    if isinstance(sched, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
        sched.step(LOSSES[i])
    else:
        sched.step()


def _rates(sched, first, n):
    out = []
    for i in range(first, first + n):
        out.append(sched())
        _advance(sched, i)
    return out


def test_every_reference_scheduler_is_ported():
    assert sorted(tlr.__all__) == sorted(jlr.__all__)
    kinds = {name.split("-")[0] for name in SCHEDULERS}
    assert kinds == set(jlr.__all__) - {"LRScheduler"}


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_fifty_steps_match_the_reference(name):
    j, t = SCHEDULERS[name](jlr), SCHEDULERS[name](tlr)
    want, got = _rates(j, 0, STEPS), _rates(t, 0, STEPS)
    assert all(math.isfinite(r) for r in got)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert len(set(got)) > 1, f"{name}: the rate never moved"
    assert t.state_dict() == j.state_dict()


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_state_dict_round_trip_continues_identically(name):
    whole = SCHEDULERS[name](tlr)
    want = _rates(whole, 0, STEPS)
    first = SCHEDULERS[name](tlr)
    _rates(first, 0, MID)
    resumed = SCHEDULERS[name](tlr)
    resumed.set_state_dict(first.state_dict())
    inner = getattr(first, "lr_sched", None)
    if inner is not None:
        # a nested scheduler is an object, which state_dict leaves out in
        # both packages: its own state goes across by hand
        resumed.lr_sched.set_state_dict(inner.state_dict())
    assert _rates(resumed, MID, STEPS - MID) == want[MID:]
