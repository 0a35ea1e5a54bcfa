"""The named recompute policies against the JAX package's, and what each
keeps.

Model: ``gpt2-tiny`` with ``n_head=2`` (head_dim 64, seq_len 128), vocab
96, float32, dropout 0, weights made by the JAX package from a seed and
carried across by ``convert``. Each policy (None = full recompute,
``"dots"``, ``"attn"``, ``"dots_attn"``, and a callable keeping the
attention) runs one forward and backward in both packages. Tolerances:
loss and every gradient within 1e-5 of the reference's with the same
policy (float32 in both, summed in another order); within 1e-6 of the
port's own run without recompute (the recomputation repeats the same
operations, so in practice they are equal). On the CPU the attention is
the plain route of ``ops.flash_attention.attention_op``, whose forwards
count as ``flash_attention_ref``: a policy that keeps the attention runs
it once per layer, full recompute twice.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch.distributed.fleet.utils import (  # noqa: E402
    recompute, recompute_policy_fn)
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.profiler import registry  # noqa: E402

VOCAB, B, T = 96, 2, 128
CFG = dict(vocab_size=VOCAB, n_head=2, dropout=0.0)
N_LAYER = 2


def _keep_attention(op, *args, **kwargs):
    return op is torch.ops.paddle_tpu_torch.flash_attention.default


# name -> (port policy, reference policy)
POLICIES = {
    "full": (None, None),
    "dots": ("dots", "dots"),
    "attn": ("attn", "attn"),
    "dots_attn": ("dots_attn", "dots_attn"),
    "callable": (_keep_attention,
                 jax.checkpoint_policies.save_only_these_names("attn_out")),
}
# attention forwards per step: kept by the policy, or run again
ATTN_FORWARDS = {"full": 2, "dots": 2, "attn": 1, "dots_attn": 1,
                 "callable": 1}


@pytest.fixture(scope="module")
def weights():
    state = paddle.get_rng_state()
    try:
        paddle.seed(0)
        jm = jgpt.GPTForPretraining(jgpt.GPTModel(
            jgpt.GPTConfig.preset("gpt2-tiny", **CFG)))
    finally:
        paddle.set_rng_state(state)
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _batch():
    toks = np.random.default_rng(1).integers(0, VOCAB, (B, T))
    return toks, np.roll(toks, -1, axis=1)


def _torch_run(weights, **over):
    cfg = tgpt.GPTConfig.preset("gpt2-tiny", **CFG, **over)
    tm = tgpt.GPTForPretraining(tgpt.GPTModel(cfg, device="cpu"))
    convert.load_paddle_tpu_state(tm, weights)
    toks, labels = (torch.from_numpy(a) for a in _batch())
    registry.reset("kernels")
    loss = tgpt.GPTPretrainingCriterion()(tm(toks), labels)
    loss.backward()
    return (float(loss.detach()),
            {n: p.grad.clone() for n, p in tm.named_parameters()},
            fa.launches()["flash_attention_ref"])


def _jax_run(weights, **over):
    cfg = jgpt.GPTConfig.preset("gpt2-tiny", **CFG, **over)
    jm = jgpt.GPTForPretraining(jgpt.GPTModel(cfg))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in weights.items()})
    toks, labels = _batch()
    loss = jgpt.GPTPretrainingCriterion()(jm(paddle.to_tensor(toks)),
                                          paddle.to_tensor(labels))
    loss.backward()
    linear = {f"{n}.weight" for n, m in jm.named_sublayers()
              if type(m).__name__ == "Linear"}
    grads = {}
    for name, p in jm.named_parameters():
        g = np.asarray(p.grad.numpy())
        grads[name] = g.T if name in linear else g
    return float(loss), grads


@pytest.fixture(scope="module")
def plain(weights):
    return _torch_run(weights)


@pytest.mark.parametrize("name", list(POLICIES))
def test_policy_matches_the_reference_and_the_plain_run(name, weights,
                                                         plain):
    tpol, jpol = POLICIES[name]
    loss, grads, attn_forwards = _torch_run(
        weights, use_recompute=True, recompute_policy=tpol)
    jloss, jgrads = _jax_run(weights, use_recompute=True,
                             recompute_policy=jpol)
    np.testing.assert_allclose(loss, jloss, atol=1e-5, rtol=1e-5)
    assert sorted(grads) == sorted(jgrads)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[n], atol=1e-5,
                                   rtol=1e-5, err_msg=f"{name}: {n}")
    ploss, pgrads, plain_forwards = plain
    np.testing.assert_allclose(loss, ploss, atol=1e-6, rtol=1e-6)
    for n, g in grads.items():
        torch.testing.assert_close(g, pgrads[n], atol=1e-6, rtol=1e-6)
    assert plain_forwards == N_LAYER
    assert attn_forwards == ATTN_FORWARDS[name] * N_LAYER


def test_attention_output_is_saved_not_recomputed():
    # the attention op alone under each policy: "attn" keeps (out, lse) and
    # the backward's recomputation takes them, running no second forward
    q, k, v = (torch.randn(1, 128, 2, 64, requires_grad=True)
               for _ in range(3))

    def block(a, b, c):
        out = fa.flash_attention(a, b, c, causal=True)
        return (out * out).sum()

    grads = {}
    for policy in (None, "dots", "attn", "dots_attn"):
        registry.reset("kernels")
        recompute(block, q, k, v, policy=policy).backward()
        want = 1 if policy in ("attn", "dots_attn") else 2
        assert fa.launches()["flash_attention_ref"] == want, policy
        grads[policy] = [t.grad.clone() for t in (q, k, v)]
        for t in (q, k, v):
            t.grad = None
    for policy, gs in grads.items():
        for a, b in zip(gs, grads[None]):
            assert torch.equal(a, b), policy


def test_unknown_policies_are_refused():
    assert recompute_policy_fn(None) is None
    with pytest.raises(ValueError, match="unknown recompute policy"):
        recompute_policy_fn("everything")
    with pytest.raises(ValueError, match="unknown recompute policy"):
        tgpt.GPTModel(tgpt.GPTConfig.preset(
            "gpt2-tiny", use_recompute=True, recompute_policy="dot"),
            device="cpu")


@pytest.mark.parametrize("policy", ["attn", "dots"])
def test_dropout_masks_replay_under_a_policy(policy, weights):
    # the attention's dropout masks come from the model's generator, which
    # the recomputation rewinds: a kept or recomputed block gives the loss
    # and grads of the same model run without recompute
    runs = []
    for over in (dict(), dict(use_recompute=True, recompute_policy=policy)):
        cfg = tgpt.GPTConfig.preset("gpt2-tiny", attn_dropout=0.3, **CFG,
                                    **over)
        tm = tgpt.GPTForPretraining(tgpt.GPTModel(
            cfg, device="cpu", generator=torch.Generator().manual_seed(4)))
        convert.load_paddle_tpu_state(tm, weights)
        toks, labels = (torch.from_numpy(a) for a in _batch())
        loss = tgpt.GPTPretrainingCriterion()(tm(toks), labels)
        loss.backward()
        runs.append((float(loss.detach()),
                     {n: p.grad for n, p in tm.named_parameters()},
                     tm.gpt.blocks[0].attn.generator.get_state()))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert l0 == l1
    assert torch.equal(s0, s1)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], atol=1e-6, rtol=1e-6)
