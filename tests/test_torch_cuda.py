"""paddle_tpu_torch's CUDA kernels on the card, against their plain versions.

Needs a CUDA device and nvcc; skipped elsewhere. On the card run
``python -m pytest --noconftest tests/test_torch_cuda.py`` (the repo's
conftest imports JAX, which the card machine need not have).
Tolerances: ``PAGED_PARITY_TOL`` for the paged kernel (float32 reduction
order; bf16 probabilities rounded before the PV product in the plain
version); ``FLASH_PARITY_TOL`` elementwise and ``FLASH_PARITY_REL`` block
by block relative to the plain version's norm for the flash kernels
(float32 summation order; bf16 P and dS rounded before the tensor-core
products in the kernels).
"""
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode "
                    "(the CPU suite covers its plain version)")
    return torch.device("cuda", 0)


def _case(dev, dtype, T, Dh, bs, lens, seed):
    g = torch.Generator().manual_seed(seed)
    B, H = len(lens), 4
    M = max(-(-n // bs) for n in lens) + 1
    Nb = 1 + B * M
    q = torch.randn(B, T, H, Dh, generator=g).to(dev, dtype)
    kp = torch.randn(Nb, bs, H, Dh, generator=g).to(dev, dtype)
    vp = torch.randn(Nb, bs, H, Dh, generator=g).to(dev, dtype)
    bt = (torch.randperm(Nb - 1, generator=g) + 1).view(B, M)
    sl = torch.tensor(lens)
    qo = (sl - T).clamp(min=0)
    bt[1] = 0          # an inactive lane on the garbage block
    sl[1], qo[1] = 1, 0
    bt[-1, 0] = bt[0, 0]  # a physical block shared by two lanes
    return (q, kp, vp, bt.to(dev, torch.int32), sl.to(dev, torch.int32),
            qo.to(dev, torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 3, 8])
@pytest.mark.parametrize("Dh,bs", [(64, 16), (128, 16), (64, 5), (128, 1)])
def test_kernel_matches_plain_version(cuda, dtype, T, Dh, bs):
    args = _case(cuda, dtype, T, Dh, bs, [37, 9, 16, 300], seed=T + bs)
    out = pa.paged_attention(*args)
    torch.cuda.synchronize()
    ref = pa.paged_attention_ref(*args)
    atol, rtol = pa.PAGED_PARITY_TOL[dtype]
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)


def test_kernel_refuses_what_it_does_not_take(cuda):
    args = list(_case(cuda, torch.float32, 1, 64, 16, [20, 9, 16, 30], 0))
    args[3] = args[3].long()
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention(*args)


def test_engine_tokens_kernel_equals_plain(cuda):
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel)
    from paddle_tpu_torch.serving import GenerationEngine

    cfg = GPTConfig(vocab_size=512, n_layer=2, n_head=4, d_model=256,
                    seq_len=256, initializer_range=0.2)
    model = GPTForPretraining(GPTModel(
        cfg, device=cuda, generator=torch.Generator(cuda).manual_seed(0)))
    outs = []
    for kind in ("cuda", "torch"):
        eng = GenerationEngine(model, max_batch_size=2, rng_seed=3,
                               block_size=16, paged_kernel=kind,
                               device=cuda)
        toks = [eng.prefill(0, list(range(3, 40)), seed=0),
                eng.prefill(1, list(range(7, 20)), seed=1, temperature=0.8)]
        for _ in range(12):
            toks.extend(eng.decode_step().tolist())
        outs.append(toks)
    assert outs[0] == outs[1]


def _flash_case(dev, dtype, B, T, N, H, seed, strided=False):
    """q, k, v [B, T, N, H] (as unbind views of one fused projection when
    ``strided``) and an output gradient, from a seeded CPU generator."""
    g = torch.Generator().manual_seed(seed)
    if strided:
        qkv = torch.randn(B, T, 3, N, H, generator=g).to(dev, dtype)
        q, k, v = qkv.unbind(2)
    else:
        q, k, v = (torch.randn(B, T, N, H, generator=g).to(dev, dtype)
                   for _ in range(3))
    do = torch.randn(B, T, N, H, generator=g).to(dev, dtype)
    return q, k, v, do


def _assert_flash_close(got, want, dtype):
    atol, rtol = fa.FLASH_PARITY_TOL[dtype]
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert fa.flash_rel_err(got, want) <= fa.FLASH_PARITY_REL[dtype]


def _check_flash_kernels(q, k, v, do, causal):
    dtype = q.dtype
    out, lse = fa.flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_fwd_ref(q, k, v, causal)
    _assert_flash_close(out, ref_out, dtype)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    # both backward kernels from the plain forward's lse and one delta
    delta = fa.flash_delta(ref_out, do)
    dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal)
    torch.cuda.synchronize()
    _assert_flash_close(dq, fa.flash_bwd_dq_ref(q, k, v, do, ref_lse, delta,
                                                causal), dtype)
    ref_dk, ref_dv = fa.flash_bwd_dkv_ref(q, k, v, do, ref_lse, delta, causal)
    _assert_flash_close(dk, ref_dk, dtype)
    _assert_flash_close(dv, ref_dv, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H", [64, 96, 128, 256])
@pytest.mark.parametrize("T", [128, 256, 2048])
def test_flash_kernels_match_plain_versions(cuda, dtype, causal, H, T):
    B, N = (1, 2) if T == 2048 else (2, 3)
    q, k, v, do = _flash_case(cuda, dtype, B, T, N, H, seed=T + H,
                              strided=T == 256)
    _check_flash_kernels(q, k, v, do, causal)


def test_flash_kernels_at_the_training_step_shape(cuda):
    # gpt3-1.3B's attention at batch 4 x 2048: 32 heads of 64, bf16,
    # causal, on the unbind views of the fused QKV projection
    q, k, v, do = _flash_case(cuda, torch.bfloat16, 4, 2048, 32, 64,
                              seed=9, strided=True)
    _check_flash_kernels(q, k, v, do, True)


@pytest.mark.parametrize("B,T,N,H", [(4, 2048, 32, 64), (2, 2048, 8, 128)])
def test_flash_kernels_repeat_bitwise(cuda, B, T, N, H):
    # two launches on the same inputs give the same bits: the kernels sum
    # in a fixed order without atomics, so a difference means a tile ring
    # stage was read after its next load overwrote it
    q, k, v, do = _flash_case(cuda, torch.bfloat16, B, T, N, H, seed=11,
                              strided=True)
    fwd = [fa.flash_fwd(q, k, v, True) for _ in range(2)]
    delta = fa.flash_delta(fwd[0][0], do)
    dkv = [fa.flash_bwd_dkv(q, k, v, do, fwd[0][1], delta, True)
           for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(fwd[0] + dkv[0], fwd[1] + dkv[1]):
        assert torch.equal(a, b)


def test_flash_function_grads_on_strided_views(cuda):
    q, k, v, do = _flash_case(cuda, torch.float32, 2, 256, 2, 64, seed=3,
                              strided=True)
    grads = []
    for fn in (lambda a, b, c: fa.FlashAttentionFunction.apply(
                   a, b, c, True, 0.125),
               lambda a, b, c: fa.flash_attention_ref(a, b, c, causal=True,
                                                      scale=0.125)):
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        fn(*ins).backward(do)
        grads.append([t.grad for t in ins])
    for got, want in zip(*grads):
        assert got.shape == want.shape
        _assert_flash_close(got, want, torch.float32)


def test_flash_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v, _ = _flash_case(cuda, torch.float32, 1, 128, 2, 64, seed=0)
    # a CPU tensor forced onto the "cuda" route
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(q.cpu(), k.cpu(), v.cpu(), kernel="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        fa.check_flash_args(q.cpu(), k.cpu(), v.cpu())
    # a pointer off the 16-byte grid
    flat = torch.zeros(1 * 128 * 2 * 64 + 1, device=cuda)
    odd = flat[1:].view(1, 128, 2, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_fwd(odd, k, v)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_fwd(q, k.bfloat16(), v)
