"""The port's plain versions of the flash kernels K1-K3 against the JAX
package's Pallas kernels, run through the Pallas interpreter on the CPU
(``pltpu.force_tpu_interpret_mode()``: the real kernel bodies of
``_flash_fwd_call`` and ``_flash_flat_bwd``), plus the dispatcher's
eligibility rule, route choice and counters.

The same numpy inputs go to both sides: ``[B, T, N, H]`` for the port,
flattened to ``[B * N, T, H]`` for the reference's kernels. Tolerance: 1e-4
absolute and relative in float32 (the same float32 formulas summed in
another order; the interpreter's blocks of 128 keys against one sum over
all keys).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from paddle_tpu.ops import pallas_ops  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.profiler import explainer, registry  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
BLOCK = 128


def _inputs(B, T, N, H, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, N, H)).astype(np.float32)
            for _ in range(4)]


def _flat(x):
    B, T, N, H = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * N, T, H))


def _unflat(x, B, N):
    BN, T, H = x.shape
    return np.asarray(x).reshape(B, N, T, H).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H", [64, 128])
@pytest.mark.parametrize("T", [128, 256])
def test_plain_kernels_match_interpreted_pallas(causal, H, T):
    B, N = 2, 2
    q, k, v, do = _inputs(B, T, N, H, seed=T + H + causal)
    scale = H ** -0.5
    jq, jk, jv, jdo = (_flat(x) for x in (q, k, v, do))
    with pltpu.force_tpu_interpret_mode():
        jout, jlse = pallas_ops._flash_fwd_call(jq, jk, jv, causal, scale,
                                                BLOCK, BLOCK)
        jdq, jdk, jdv = pallas_ops._flash_flat_bwd(
            causal, scale, BLOCK, BLOCK, (jq, jk, jv, jout, jlse), jdo)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))

    out, lse = fa.flash_fwd_ref(tq, tk, tv, causal, scale)
    np.testing.assert_allclose(out.numpy(), _unflat(jout, B, N), **TOL)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jlse).reshape(B, N, T), **TOL)

    # the backward kernels from the reference's own out and lse
    ref_out = torch.from_numpy(_unflat(jout, B, N).copy())
    ref_lse = torch.from_numpy(np.asarray(jlse).reshape(B, N, T).copy())
    delta = fa.flash_delta(ref_out, tdo)
    dq = fa.flash_bwd_dq_ref(tq, tk, tv, tdo, ref_lse, delta, causal, scale)
    dk, dv = fa.flash_bwd_dkv_ref(tq, tk, tv, tdo, ref_lse, delta, causal,
                                  scale)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), _unflat(want, B, N), **TOL)


def test_autograd_function_matches_pallas_custom_vjp():
    # FlashAttentionFunction on CPU tensors runs the plain K1 forward and
    # K2 + K3 backward; the reference differentiates its custom_vjp
    B, T, N, H = 1, 256, 2, 64
    q, k, v, do = _inputs(B, T, N, H, seed=11)

    def loss(a, b, c):
        out = pallas_ops._flash_attention_tpu(a, b, c, causal=True,
                                              block_q=BLOCK, block_k=BLOCK)
        return jnp.sum(out * jnp.asarray(do)), out

    with pltpu.force_tpu_interpret_mode():
        (_, jout), jgrads = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    registry.reset("kernels")
    out = fa.FlashAttentionFunction.apply(*ins, True, H ** -0.5)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for t, want in zip(ins, jgrads):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), **TOL)
    counts = fa.launches()
    assert (counts["flash_fwd_ref"], counts["flash_bwd_dq_ref"],
            counts["flash_bwd_dkv_ref"]) == (1, 1, 1)
    assert counts["flash_fwd"] == counts["flash_bwd_dq"] == 0


def test_plain_attention_path_matches_reference_xla_path():
    # the "torch" route (and every ineligible call) is the reference's
    # _attention_xla, masked or causal
    B, T, N, H = 2, 40, 2, 32
    q, k, v, _ = _inputs(B, T, N, H, seed=5)
    mask = np.random.default_rng(6).random((B, 1, T, T)) > 0.3
    mask[..., 0] = True
    for kw in (dict(causal=True), dict(mask=mask)):
        want = pallas_ops._attention_xla(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            mask=None if "mask" not in kw else jnp.asarray(mask),
            causal=kw.get("causal", False))
        got = fa.flash_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            mask=None if "mask" not in kw else torch.from_numpy(mask),
            causal=kw.get("causal", False))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrappers_compute_plain_versions_on_cpu_tensors():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 128, 2, 64, 3))
    registry.reset("kernels")
    out, lse = fa.flash_fwd(q, k, v, True)
    ref_out, ref_lse = fa.flash_fwd_ref(q, k, v, True)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    delta = fa.flash_delta(out, do)
    assert torch.equal(fa.flash_bwd_dq(q, k, v, do, lse, delta, True),
                       fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, True))
    for a, b in zip(fa.flash_bwd_dkv(q, k, v, do, lse, delta, True),
                    fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, True)):
        assert torch.equal(a, b)
    counts = fa.launches()
    assert counts["flash_fwd"] == counts["flash_bwd_dq"] == \
        counts["flash_bwd_dkv"] == 0
    assert counts["flash_fwd_ref"] == counts["flash_bwd_dq_ref"] == \
        counts["flash_bwd_dkv_ref"] == 2
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (1, 2, 128)


def _bf16_forward(q, k, v, drop_key_tile=None, tile=64):
    """Causal attention as the kernel forms it in bf16: probabilities
    rounded to bf16 before the PV product, their sum in float32, the output
    rounded; optionally one tile of keys left out of every row."""
    T, H = q.shape[1], q.shape[-1]
    s = torch.einsum("btnh,bsnh->bnts", q.float() * H ** -0.5, k.float())
    keep = torch.ones(T, T, dtype=torch.bool).tril()
    if drop_key_tile is not None:
        keep &= (torch.arange(T) // tile != drop_key_tile)[None, :]
    p = torch.exp(s.masked_fill(~keep, float("-inf"))
                  - s.masked_fill(~keep, float("-inf")).amax(-1, True))
    out = torch.einsum("bnts,bsnh->btnh", p.bfloat16().float(), v.float())
    return (out / p.sum(-1).transpose(1, 2).unsqueeze(-1)).bfloat16()


@pytest.mark.parametrize("tile,drop", [(64, 30), (64, 28), (128, 14)])
def test_bf16_relative_bound_separates_rounding_from_a_dropped_key_tile(
        tile, drop):
    # FLASH_PARITY_REL's bf16 bound against what it must tell apart, at
    # the training step's seq_len: the kernel's own rounding stays well
    # inside it, and one key tile dropped late in every row lands far
    # outside. Tiles of 64 keys are the WMMA design's (tile 30: rows past
    # 1920 see it) and the Hopper design's K2 (tile 28: rows past 1792), of
    # 128 the Hopper design's K1 (tile 14: rows past 1792)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2048, 2, 64, generator=g).bfloat16()
               for _ in range(3))
    ref, _ = fa.flash_fwd_ref(q, k, v, causal=True)
    bound = fa.FLASH_PARITY_REL[torch.bfloat16]
    assert fa.flash_rel_err(_bf16_forward(q, k, v), ref) < bound / 2
    assert fa.flash_rel_err(_bf16_forward(q, k, v, drop_key_tile=drop,
                                          tile=tile), ref) > 5 * bound
    assert fa.flash_rel_err(ref, ref) == 0.0


def test_eligibility_rule_is_the_reference_rule():
    def t(B=1, T=128, N=2, H=64, dtype=torch.float32):
        return torch.zeros(B, T, N, H, dtype=dtype)

    assert fa.flash_ineligible(t(), t()) is None
    assert fa.flash_ineligible(t(H=256, dtype=torch.bfloat16), t()) is None
    assert "attn_mask" in fa.flash_ineligible(t(), t(), mask=torch.ones(1))
    assert "cross-length" in fa.flash_ineligible(t(), t(T=256))
    assert "multiple of 128" in fa.flash_ineligible(t(T=192), t(T=192))
    assert "head_dim 32" in fa.flash_ineligible(t(H=32), t(H=32))
    assert "float16" in fa.flash_ineligible(t(dtype=torch.float16), t())


def test_routes_resolve_once_and_never_demote_quietly():
    q = torch.zeros(1, 128, 2, 64)
    registry.reset("kernels")
    fa.flash_attention(q, q, q, causal=True)
    assert fa.launches()["flash_attention_ref"] == 1
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(q, q, q, causal=True, kernel="cuda")
    with pytest.raises(ValueError, match="cuda | torch"):
        fa.flash_attention(q, q, q, kernel="pallas")
    assert fa.select_flash_kernel(None, device="cpu", head_dim=32,
                                  dtype=torch.float32) == "torch"
    assert fa.select_flash_kernel("torch", device="cpu", head_dim=64,
                                  dtype=torch.float32) == "torch"
    with pytest.raises(ValueError, match="CUDA device"):
        fa.select_flash_kernel("cuda", device="cpu", head_dim=64,
                               dtype=torch.float32)
    with pytest.raises(ValueError, match="auto | cuda | torch"):
        fa.select_flash_kernel("pallas", device="cpu", head_dim=64,
                               dtype=torch.float32)
    cfg = tgpt.GPTConfig.preset("gpt2-tiny", vocab_size=96, n_head=2)
    assert tgpt.GPTModel(cfg, device="cpu").attn_kernel == "torch"
    with pytest.raises(ValueError, match="CUDA device"):
        tgpt.GPTModel(cfg, device="cpu", attn_kernel="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["causal", "bool_mask", "float_mask",
                                  "cross_length"])
def test_plain_route_is_attention_under_autograd(case, dtype):
    # the plain route (attention_op's, one op for a recompute policy) keeps
    # attention()'s numbers: its output and every gradient equal plain
    # attention under torch autograd bit for bit, in bf16 too (scores and
    # probabilities rounded as the reference's _attention_xla rounds them)
    from paddle_tpu_torch.ops.attention import attention, attention_logits

    S = 192 if case == "cross_length" else 128
    rng = np.random.default_rng(5)
    q, do = (torch.from_numpy(rng.standard_normal((2, 128, 2, 64)).astype(
        np.float32)).to(dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, S, 2, 64)).astype(
        np.float32)).to(dtype) for _ in range(2))
    keep = torch.from_numpy(rng.random((2, 1, 128, S)) > 0.3)
    keep[..., 0] = True
    mask = {"bool_mask": keep,
            "float_mask": torch.where(keep, 0.0, -1e4),
            }.get(case)
    kw = dict(mask=mask, causal=case == "causal")
    runs = []
    for fn in (fa.flash_attention, attention):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ins, **kw)
        out.backward(do)
        runs.append((out.detach(), *(t.grad for t in ins)))
    for got, want in zip(*runs):
        assert torch.equal(got, want)
    _, lse = fa.attention_op(q, k, v, mask, kw["causal"], 64 ** -0.5, False)
    assert torch.equal(lse, torch.logsumexp(
        attention_logits(q, k, **kw), -1))


def test_fallback_on_the_cuda_route_records_its_reason(monkeypatch):
    # an ineligible call on the "cuda" route takes the plain path and says
    # why; the device check is the only part that needs a card, so the
    # tensor's device type is stood in for
    q = torch.zeros(1, 96, 2, 64)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    registry.reset("kernels")
    fa.flash_attention(q, q, q, kernel="cuda")
    monkeypatch.undo()
    assert fa.launches()["flash_attention_ref"] == 1
    ev = explainer.events(kind="kernel_fallback")[-1]
    assert ev["op"] == "flash_attention"
    assert "seq_len 96 not a multiple of 128" in ev["why"]


def test_library_hash_covers_the_headers(tmp_path, monkeypatch):
    # the Hopper kernels' PTX wrappers live in csrc/hopper.cuh: an edited
    # header must give the library that includes it a new name, so it
    # rebuilds instead of loading the stale one
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("k")
    assert before.name.startswith("k-") and before.suffix == ".so"
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.library_path("k") != before
