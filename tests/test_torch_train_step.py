"""``jit.TrainStep`` on the CPU route, and the parts of its CUDA-graph route
that need no card: the signature, the storage check and the fault point.

The CPU route runs the step eagerly with the same update code as the
card. It is held against the reference's EAGER loop (``gpt2-tiny``,
``n_head=2``, vocab 96, float32, weights carried by ``convert``) with a
warm-up-into-cosine scheduler stepped between calls, a global-norm clip
and decoupled decay: losses, parameters and moments within 1e-4 (as in
``test_torch_train.py``). Not against the reference's ``jit.TrainStep``:
that one advances the step count twice per call and bakes the first
learning rate into its program (ROADMAP.md queue 3), which
``test_reference_trainstep_bakes_the_first_lr_port_follows_the_scheduler``
shows on a one-weight model. The graph cases themselves are in
``tests/test_torch_cuda.py`` (marker ``cuda``).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch import jit as tjit  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.profiler import registry  # noqa: E402
from paddle_tpu_torch.testing import faults  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
VOCAB, B = 96, 2
CFG = dict(vocab_size=VOCAB, n_head=2, dropout=0.0)


def _schedule(lr_mod):
    return lr_mod.LinearWarmup(lr_mod.CosineAnnealingDecay(
        3e-3, T_max=4, eta_min=1e-4), warmup_steps=2, start_lr=1e-3,
        end_lr=3e-3)


def _decay(name):
    return name is not None and not name.endswith("bias")


def _batch(seed):
    toks = np.random.default_rng(seed).integers(0, VOCAB, (B, 128))
    return toks, np.roll(toks, -1, axis=1)


def test_cpu_route_with_scheduler_clip_and_decay_matches_the_eager_loop():
    state = paddle.get_rng_state()
    try:
        paddle.seed(0)
        jm = jgpt.GPTForPretraining(jgpt.GPTModel(
            jgpt.GPTConfig.preset("gpt2-tiny", **CFG)))
    finally:
        paddle.set_rng_state(state)
    tm = tgpt.GPTForPretraining(tgpt.GPTModel(
        tgpt.GPTConfig.preset("gpt2-tiny", **CFG), device="cpu"))
    convert.load_paddle_tpu_state(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    jsched, tsched = _schedule(paddle.optimizer.lr), _schedule(topt.lr)
    jopt = paddle.optimizer.AdamW(
        learning_rate=jsched, weight_decay=0.1,
        parameters=jm.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(0.5),
        apply_decay_param_fun=_decay)
    for n, p in jm.named_parameters():
        p.name = n  # the reference's decay rule reads Parameter.name
    topt_ = topt.AdamW(learning_rate=tsched, weight_decay=0.1,
                       parameters=list(tm.named_parameters()),
                       grad_clip=tnn.ClipGradByGlobalNorm(0.5),
                       apply_decay_param_fun=_decay)
    crit = tgpt.GPTPretrainingCriterion()

    def step_fn(tokens, labels):
        loss = crit(tm(tokens), labels)
        loss.backward()
        topt_.step()
        topt_.clear_grad()
        return loss

    step = tjit.TrainStep(step_fn, tm, topt_)
    registry.reset("jit")
    jcrit = jgpt.GPTPretrainingCriterion()
    rates = []
    for s in range(3):
        rates.append(tsched())
        toks, labels = _batch(s)
        jloss = jcrit(jm(paddle.to_tensor(toks)), paddle.to_tensor(labels))
        jloss.backward()
        jopt.step()
        jopt.clear_grad()
        tloss = step(toks, labels)
        np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                                   **TOL)
        jsched.step()
        tsched.step()
    assert registry.counters("jit")["train_step_eager"] == 3
    assert registry.counters("jit")["train_step_captures"] == 0
    # the device scalars hold the last step's rate and count
    assert topt_._opt_step == 3 and float(topt_._t_buf) == 3.0
    assert float(topt_._lr_buf) == np.float32(rates[-1])
    assert len(set(rates)) == 3
    want = convert.state_from_paddle_tpu(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}, tm)
    for name, t in tm.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)
    # the reference keys a named parameter's slots by its name
    names = [n for n, _ in jm.named_parameters()]
    jsd = {}
    for key, v in jopt.state_dict().items():
        acc, _, pname = key.rpartition("/")
        jsd[f"{acc}/p{names.index(pname)}" if pname in names else key] = v
    slots = convert.optimizer_state_from_paddle_tpu(jsd, topt_, tm)
    tsd = topt_.state_dict()
    for key, t in slots.items():
        if key not in ("_opt_step", "LR_Scheduler"):
            np.testing.assert_allclose(tsd[key].numpy(), t.numpy(), **TOL,
                                       err_msg=key)


def test_reference_trainstep_bakes_the_first_lr_port_follows_the_scheduler():
    # one weight w = 0, loss = w * 1 (gradient 1), SGD under StepDecay(1.0,
    # step_size=1, gamma=0.1) stepped between calls: the eager loop moves
    # w by 1, 0.1, 0.01; the reference's TrainStep keeps the rate it traced
    # (1.0) at every call, the port's TrainStep follows the scheduler
    def run_reference(compiled):
        lin = paddle.nn.Linear(1, 1, bias_attr=False)
        lin.weight.set_value(np.zeros((1, 1), np.float32))
        sched = paddle.optimizer.lr.StepDecay(1.0, step_size=1, gamma=0.1)
        opt = paddle.optimizer.SGD(learning_rate=sched,
                                   parameters=lin.parameters())

        def step_fn(x):
            loss = lin(x).sum()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        step = paddle.jit.TrainStep(step_fn, lin, opt) if compiled \
            else step_fn
        ws = []
        for _ in range(3):
            step(paddle.to_tensor(np.ones((1, 1), np.float32)))
            sched.step()
            ws.append(float(lin.weight.numpy().ravel()[0]))
        return ws

    def run_port():
        lin = torch.nn.Linear(1, 1, bias=False)
        with torch.no_grad():
            lin.weight.zero_()
        sched = topt.lr.StepDecay(1.0, step_size=1, gamma=0.1)
        opt = topt.SGD(learning_rate=sched, parameters=lin.parameters())

        def step_fn(x):
            loss = lin(x).sum()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        step = tjit.TrainStep(step_fn, lin, opt)
        ws = []
        for _ in range(3):
            step(np.ones((1, 1), np.float32))
            sched.step()
            ws.append(float(lin.weight.detach().ravel()[0]))
        return ws

    eager = run_reference(compiled=False)
    np.testing.assert_allclose(eager, [-1.0, -1.1, -1.11], rtol=1e-6)
    np.testing.assert_allclose(run_reference(compiled=True),
                               [-1.0, -2.0, -3.0], rtol=1e-6)
    np.testing.assert_allclose(run_port(), eager, rtol=1e-6)


def _tiny():
    lin = torch.nn.Linear(3, 2)
    opt = topt.Momentum(learning_rate=0.1, parameters=lin.parameters())

    def step_fn(x):
        loss = lin(x).square().sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return lin, opt, tjit.TrainStep(step_fn, lin, opt)


def test_signature_covers_shape_dtype_and_values():
    a, b = torch.zeros(2, 3), torch.zeros(2, 3, dtype=torch.float64)
    assert tjit._aval(a) == ((2, 3), torch.float32)
    assert tjit._aval(a) != tjit._aval(b)
    assert tjit._aval(a) != tjit._aval(torch.zeros(3, 3))
    assert tjit._aval(7) == ("value", 7)
    out = tjit._detached((a, 5))
    assert out[1] == 5 and out[0] is not a and torch.equal(out[0], a)


def test_storage_check_sees_rebinding_not_in_place_restores():
    lin, opt, step = _tiny()
    x = np.ones((4, 3), np.float32)
    step(x)
    opt._ensure_accumulators()
    key = step._storage_key()
    # an in-place restore keeps every address: the graphs stay valid
    sd = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
          for k, v in opt.state_dict().items()}
    opt.set_state_dict(sd)
    lin.load_state_dict({k: v.clone() for k, v in lin.state_dict().items()})
    assert step._storage_key() == key
    # rebinding a parameter's storage, or a slot's, changes the key
    with torch.no_grad():
        lin.weight.data = lin.weight.detach().clone()
    key2 = step._storage_key()
    assert key2 != key
    opt._accumulators["velocity"][0] = \
        opt._accumulators["velocity"][0].clone()
    assert step._storage_key() != key2


def test_mutate_signature_parses_arms_and_perturbs_an_aval():
    spec = faults.parse_spec("mutate_signature:nth=2,mode=aval")
    assert spec == {"mutate_signature": {"nth": 2, "mode": "aval"}}
    _, _, step = _tiny()
    avals = (((4, 3), torch.float32), ("value", 1))
    graph = tjit._Graph(avals, None, None, None)
    try:
        faults.configure("mutate_signature:nth=2,mode=aval")
        assert faults.ACTIVE
        assert faults.fire("mutate_signature") is False
        assert faults.fire("mutate_signature") is True
        step._perturb(graph)
        assert graph.avals == (((5, 4), torch.float32), ("value", 1))
        faults.configure("mutate_signature:nth=1")  # mode=scalar
        graph.avals = avals
        assert faults.fire("mutate_signature") is True
        step._perturb(graph)
        assert graph.avals == avals  # nothing pinned: nothing perturbed
    finally:
        faults.reset()


def test_cpu_route_never_captures_and_checks_the_step_count():
    lin, opt, step = _tiny()
    registry.reset("jit")
    for _ in range(3):
        step(np.ones((4, 3), np.float32))
    assert opt._opt_step == 3
    assert registry.counters("jit") == {"train_step_captures": 0,
                                        "train_step_replays": 0,
                                        "train_step_eager": 3}

    def no_step(x):
        return lin(x).sum()

    with pytest.raises(RuntimeError, match="exactly once"):
        tjit.TrainStep(no_step, lin, opt)(np.ones((4, 3), np.float32))
