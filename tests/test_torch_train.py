"""The port's GPT pretraining step against the JAX package's eager loop.

Model: the ``gpt2-tiny`` preset with ``n_head=2`` (head_dim 64, seq_len 128:
shapes the flash kernels take), vocab 96, float32, dropout 0, weights made
by the JAX package from a seed and carried across by
``paddle_tpu_torch.convert``. On the CPU the port's attention takes its
plain path, the reference's takes XLA. Tolerance: 1e-4 absolute and
relative for logits, loss, gradients and, after three AdamW steps,
parameters and moments (float32 in both frameworks, summed in another
order).

The reference's eager loop is the yardstick, not its ``jit.TrainStep``:
that one advances the optimizer's step count twice per call (see
ROADMAP.md), and the port's ``TrainStep`` follows the eager semantics.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch import jit as tjit  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.ops.attention import \
    scaled_dot_product_attention  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
VOCAB, B, LR = 96, 2, 1e-3
CFG = dict(vocab_size=VOCAB, n_head=2, dropout=0.0)


def _jax_model(seed=0, **over):
    state = paddle.get_rng_state()
    try:
        paddle.seed(seed)
        cfg = jgpt.GPTConfig.preset("gpt2-tiny", **CFG, **over)
        return jgpt.GPTForPretraining(jgpt.GPTModel(cfg))
    finally:
        paddle.set_rng_state(state)


def _np_state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _torch_model(jm, **over):
    cfg = tgpt.GPTConfig.preset("gpt2-tiny", **CFG, **over)
    tm = tgpt.GPTForPretraining(tgpt.GPTModel(cfg, device="cpu"))
    return convert.load_paddle_tpu_state(tm, _np_state(jm))


def _batch(seed=0):
    toks = np.random.default_rng(seed).integers(0, VOCAB, (B, 128))
    return toks, np.roll(toks, -1, axis=1)


def _jax_grads(jm):
    linear = {f"{n}.weight" for n, m in jm.named_sublayers()
              if type(m).__name__ == "Linear"}
    out = {}
    for name, p in jm.named_parameters():
        g = np.asarray(p.grad.numpy())
        out[name] = g.T if name in linear else g
    return out


def test_logits_loss_and_every_grad_match():
    jm = _jax_model()
    tm = _torch_model(jm)
    toks, labels = _batch()
    jlogits = jm(paddle.to_tensor(toks))
    jloss = jgpt.GPTPretrainingCriterion()(jlogits, paddle.to_tensor(labels))
    jloss.backward()
    tlogits = tm(torch.from_numpy(toks))
    tloss = tgpt.GPTPretrainingCriterion()(tlogits, torch.from_numpy(labels))
    tloss.backward()
    np.testing.assert_allclose(tlogits.detach().numpy(),
                               np.asarray(jlogits.numpy()), **TOL)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL)
    want = _jax_grads(jm)
    got = dict(tm.named_parameters())
    assert sorted(want) == sorted(got)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g, **TOL,
                                   err_msg=name)


def test_masked_criterion_matches():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 7)).astype(np.float32)
    labels = rng.integers(0, 7, (2, 5))
    for mask in (rng.random((2, 5)) > 0.5, np.zeros((2, 5))):
        mask = mask.astype(np.float32)
        want = jgpt.GPTPretrainingCriterion()(
            paddle.to_tensor(logits), paddle.to_tensor(labels),
            paddle.to_tensor(mask))
        got = tgpt.GPTPretrainingCriterion()(
            torch.from_numpy(logits), torch.from_numpy(labels),
            torch.from_numpy(mask))
        np.testing.assert_allclose(float(got), float(want), **TOL)


def _three_steps(use_recompute):
    jm = _jax_model(use_recompute=use_recompute)
    tm = _torch_model(jm, use_recompute=use_recompute)
    jcrit, tcrit = jgpt.GPTPretrainingCriterion(), \
        tgpt.GPTPretrainingCriterion()
    jopt = paddle.optimizer.AdamW(learning_rate=LR,
                                  parameters=jm.parameters())
    topt_ = topt.AdamW(learning_rate=LR, parameters=tm.parameters())

    def step_fn(tokens, labels):
        loss = tcrit(tm(tokens), labels)
        loss.backward()
        topt_.step()
        topt_.clear_grad()
        return loss

    step = tjit.TrainStep(step_fn, tm, topt_)
    jlosses, tlosses = [], []
    for s in range(3):
        toks, labels = _batch(s)
        jloss = jcrit(jm(paddle.to_tensor(toks)), paddle.to_tensor(labels))
        jloss.backward()
        jopt.step()
        jopt.clear_grad()
        jlosses.append(float(jloss))
        tlosses.append(float(step(toks, labels).detach()))
        assert topt_._opt_step == s + 1
    return jm, tm, jopt, topt_, jlosses, tlosses


@pytest.mark.parametrize("use_recompute", [False, True])
def test_three_adamw_steps_match_the_eager_loop(use_recompute):
    jm, tm, jopt, topt_, jlosses, tlosses = _three_steps(use_recompute)
    np.testing.assert_allclose(tlosses, jlosses, **TOL)
    assert topt_._opt_step == jopt._opt_step == 3
    want = convert.state_from_paddle_tpu(_np_state(jm), tm)
    for name, t in tm.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)
    jsd = jopt.state_dict()
    tsd = topt_.state_dict()
    assert sorted(jsd) == sorted(tsd)
    slots = convert.optimizer_state_from_paddle_tpu(jsd, topt_, tm)
    for key, t in slots.items():
        if key != "_opt_step":
            np.testing.assert_allclose(tsd[key].numpy(), t.numpy(), **TOL,
                                       err_msg=key)


def test_trainstep_steps_each_optimizer_exactly_once():
    jm = _jax_model()
    tm = _torch_model(jm)
    opt = topt.AdamW(learning_rate=LR, parameters=tm.parameters())
    crit = tgpt.GPTPretrainingCriterion()

    def twice(tokens, labels):
        loss = crit(tm(tokens), labels)
        loss.backward()
        opt.step()
        opt.step()
        opt.clear_grad()
        return loss

    with pytest.raises(RuntimeError, match="exactly once"):
        tjit.TrainStep(twice, tm, opt)(*_batch())


def test_attention_dropout_scale_and_keep_rate():
    # torch's generator is not the reference's threefry: only the
    # distribution is compared (ROADMAP known divergences)
    x = torch.ones(4, 256, 4, 64)
    g = torch.Generator().manual_seed(0)
    out = scaled_dot_product_attention(x, x, x, dropout_p=0.25,
                                       is_causal=True, generator=g)
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    np.testing.assert_allclose(out[kept].numpy(), 1 / 0.75, rtol=1e-5)
    # no dropout outside training, and none at p = 0
    for kw in (dict(dropout_p=0.25, training=False), dict(dropout_p=0.0)):
        torch.testing.assert_close(scaled_dot_product_attention(
            x, x, x, is_causal=True, **kw), torch.ones_like(x))


def test_recompute_replays_the_attention_dropout_masks():
    # with attention dropout drawn from the model's generator, recompute
    # must give the loss and grads of the same model run without it
    cfg = dict(CFG, attn_dropout=0.3)
    toks, labels = (torch.from_numpy(a) for a in _batch())
    runs = []
    for use_recompute in (False, True):
        c = tgpt.GPTConfig.preset("gpt2-tiny", use_recompute=use_recompute,
                                  **cfg)
        tm = tgpt.GPTForPretraining(tgpt.GPTModel(
            c, device="cpu", generator=torch.Generator().manual_seed(4)))
        loss = tgpt.GPTPretrainingCriterion()(tm(toks), labels)
        loss.backward()
        runs.append((float(loss.detach()), {n: p.grad for n, p in
                                   tm.named_parameters()},
                     tm.gpt.blocks[0].attn.generator.get_state()))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert l0 == l1
    assert torch.equal(s0, s1)  # the generator ends where the forward left it
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], **TOL)
    # the named policies are ported (tests/test_torch_recompute.py holds
    # each against the reference); an unknown one is refused at build
    tgpt.GPTModel(tgpt.GPTConfig.preset(
        "gpt2-tiny", use_recompute=True, recompute_policy="dots"),
        device="cpu")
    with pytest.raises(ValueError, match="recompute policy"):
        tgpt.GPTModel(tgpt.GPTConfig.preset(
            "gpt2-tiny", use_recompute=True, recompute_policy="bogus"),
            device="cpu")
