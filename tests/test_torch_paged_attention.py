"""The port's plain paged attention against the JAX package's kernel K4.

The same numpy inputs go through ``paddle_tpu_torch``'s plain version (and
its kernel wrapper, which on CPU tensors computes the plain version) and
through ``pallas_ops.paged_attention`` twice: ``kernel="interpret"`` runs
the real Pallas kernel body through the interpreter, ``kernel="xla"`` the
gather oracle. Cases are those of tests/test_paged_kernel.py. Tolerance:
``PAGED_PARITY_TOL`` (float32 3e-5 — reduction order only; bf16 0.05 — the
Pallas body keeps probabilities in fp32 where the gather paths round them
to bf16 before the PV product).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.ops import pallas_ops  # noqa: E402
from paddle_tpu_torch.ops import paged_attention as pa  # noqa: E402
from paddle_tpu_torch.ops.attention import attention  # noqa: E402
from paddle_tpu_torch.profiler import registry  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _case(B, T, H, Dh, Nb, bs, M, dtype, seed=0):
    """Random q / pools / per-lane tables over distinct nonzero blocks, as
    float32 numpy already rounded to ``dtype`` (so both frameworks start
    from the same values)."""
    rng = np.random.default_rng(seed)
    tdt = DTYPES[dtype][0]

    def arr(shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.to(tdt).float().numpy()

    q, kp, vp = arr((B, T, H, Dh)), arr((Nb, bs, H, Dh)), arr((Nb, bs, H, Dh))
    bt = rng.permutation(np.arange(1, Nb))[:B * M].reshape(B, M)
    return q, kp, vp, bt.astype(np.int32)


def _both(q, kp, vp, bt, sl, qo, dtype):
    """(port plain, port wrapper, JAX interpret, JAX xla) as float32."""
    tdt, jdt = DTYPES[dtype]
    sl, qo = np.asarray(sl, np.int32), np.asarray(qo, np.int32)
    targs = ([torch.from_numpy(a).to(tdt) for a in (q, kp, vp)]
             + [torch.from_numpy(a) for a in (bt, sl, qo)])
    jargs = ([jnp.asarray(a, jdt) for a in (q, kp, vp)]
             + [jnp.asarray(a, jnp.int32) for a in (bt, sl, qo)])
    ref = pa.paged_attention_ref(*targs)
    wrapped = pa.paged_attention(*targs)
    interp = pallas_ops.paged_attention(*jargs, kernel="interpret")
    xla = pallas_ops.paged_attention(*jargs, kernel="xla")
    return (ref.float().numpy(), wrapped.float().numpy(),
            np.asarray(interp, np.float32), np.asarray(xla, np.float32))


def _check(q, kp, vp, bt, sl, qo, dtype):
    ref, wrapped, interp, xla = _both(q, kp, vp, bt, sl, qo, dtype)
    atol, rtol = pallas_ops.PAGED_PARITY_TOL[dtype]
    np.testing.assert_allclose(ref, interp, atol=atol, rtol=rtol)
    np.testing.assert_allclose(ref, xla, atol=atol, rtol=rtol)
    np.testing.assert_array_equal(wrapped, ref)
    assert np.isfinite(ref).all()
    return ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
class TestAgainstJaxKernel:
    def test_decode_straddles_block_boundaries(self, dtype):
        # bs=4: valid lengths 3 / 4 / 5 / 10 sit under, on, over and across
        # block edges; decode rows at the cursor (q_offset = seq_len - 1)
        q, kp, vp, bt = _case(4, 1, 2, 16, 16, 4, 3, dtype)
        sl = [3, 4, 5, 10]
        _check(q, kp, vp, bt, sl, [s - 1 for s in sl], dtype)

    def test_inactive_lane_on_garbage_block0(self, dtype):
        # lane 1 is released: zeroed table row, seq_len 1, cursor 0; its
        # output is finite and the live lanes equal a batch without it
        q, kp, vp, bt = _case(3, 1, 2, 16, 12, 4, 3, dtype, seed=1)
        bt[1] = 0
        out = _check(q, kp, vp, bt, [9, 1, 6], [8, 0, 5], dtype)
        solo = pa.paged_attention_ref(
            torch.from_numpy(q[::2]).to(DTYPES[dtype][0]),
            torch.from_numpy(kp).to(DTYPES[dtype][0]),
            torch.from_numpy(vp).to(DTYPES[dtype][0]),
            torch.from_numpy(bt[::2].copy()),
            torch.tensor([9, 6], dtype=torch.int32),
            torch.tensor([8, 5], dtype=torch.int32))
        np.testing.assert_array_equal(out[::2], solo.float().numpy())

    def test_verify_span_causal_mask(self, dtype):
        # a T=4 verify span: row t reads positions <= q_offset + t. Bumping
        # the pool rows past q_offset + 1 leaves rows 0 and 1 unchanged and
        # changes row 3 (the probe is live)
        B, T, bs = 2, 4, 4
        q, kp, vp, bt = _case(B, T, 2, 16, 16, bs, 4, dtype, seed=2)
        cur = [5, 9]
        sl = [c + T for c in cur]
        base = _check(q, kp, vp, bt, sl, cur, dtype)
        kp2, vp2 = kp.copy(), vp.copy()
        for b in range(B):
            for pos in range(cur[b] + 2, sl[b]):
                blk = bt[b, pos // bs]
                kp2[blk, pos % bs] += 3.0
                vp2[blk, pos % bs] += 3.0
        bumped = _check(q, kp2, vp2, bt, sl, cur, dtype)
        np.testing.assert_array_equal(base[:, :2], bumped[:, :2])
        assert not np.array_equal(base[:, 3], bumped[:, 3])

    def test_ragged_batch_with_shared_blocks(self, dtype):
        # every lane's first logical block is one physical block (a shared
        # prompt prefix), lengths ragged across the batch
        q, kp, vp, bt = _case(4, 1, 2, 16, 20, 4, 4, dtype, seed=3)
        bt[:, 0] = bt[0, 0]
        sl = [2, 6, 11, 16]
        _check(q, kp, vp, bt, sl, [s - 1 for s in sl], dtype)

    def test_serving_head_dim(self, dtype):
        # the kernel's head_dim (64) and block size (16), a short ragged
        # batch with an inactive lane
        q, kp, vp, bt = _case(3, 1, 2, 64, 13, 16, 4, dtype, seed=4)
        bt[2] = 0
        _check(q, kp, vp, bt, [40, 17, 1], [39, 16, 0], dtype)


def test_tolerances_match_the_reference():
    assert {str(k)[6:]: v for k, v in pa.PAGED_PARITY_TOL.items()} \
        == pallas_ops.PAGED_PARITY_TOL


def test_wrapper_counts_plain_route_on_cpu():
    q, kp, vp, bt = _case(2, 1, 2, 16, 8, 4, 2, "float32")
    args = ([torch.from_numpy(a) for a in (q, kp, vp, bt)]
            + [torch.tensor([5, 7], dtype=torch.int32),
               torch.tensor([4, 6], dtype=torch.int32)])
    registry.reset("kernels")
    pa.paged_attention(*args)
    assert pa.launches() == {"paged_attention": 0, "paged_attention_ref": 1}


def _good_args(T=1, Dh=64, dtype=torch.float32):
    return (torch.zeros(2, T, 2, Dh, dtype=dtype),
            torch.zeros(5, 4, 2, Dh, dtype=dtype),
            torch.zeros(5, 4, 2, Dh, dtype=dtype),
            torch.zeros(2, 3, dtype=torch.int32),
            torch.ones(2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32))


def test_kernel_argument_checks():
    pa.check_paged_args(*_good_args())
    pa.check_paged_args(*_good_args(T=8, Dh=128, dtype=torch.bfloat16))
    cases = {
        "span of 9 rows": _good_args(T=9),
        "head_dim 48": _good_args(Dh=48),
        "dtype torch.float16": _good_args(dtype=torch.float16),
    }
    a = list(_good_args())
    a[3] = a[3].long()
    cases["block_tables must be int32"] = tuple(a)
    a = list(_good_args())
    a[0] = torch.zeros(2, 1, 2, 128)[..., :64]
    cases["q is not contiguous"] = tuple(a)
    a = list(_good_args())
    a[4] = torch.ones(3, dtype=torch.int32)
    cases["seq_lens must be"] = tuple(a)
    for msg, args in cases.items():
        with pytest.raises(ValueError, match=msg):
            pa.check_paged_args(*args)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 4])
def test_split_arithmetic_at_chunk_edges(dtype, T):
    # the kernel's split-KV arithmetic with chunks of C = 8 keys over blocks
    # of 4: live lengths C-1, C, C+1 and C+2, a slot shorter than one chunk
    # beside one of three chunks, and an inactive lane (lane 6). At T = 4
    # the C+2 lane's rows end at positions 6, 7, 8 and 9, so rows 0 and 1
    # find every key of chunk 1 masked (a partial with m = -inf) while
    # rows 2 and 3 end in it. Chunks of 3 keys do not align with the
    # blocks, as the kernel does not require
    C, bs, M = 8, 4, 6
    lens = [C - 1, C, C + 1, C + 2, 3, M * bs, 1]
    q, kp, vp, bt = _case(len(lens), T, 2, 16, 48, bs, M, dtype, seed=5)
    bt[6] = 0
    sl = [max(n, T) for n in lens[:6]] + [1]
    qo = [max(n - T, 0) for n in sl[:6]] + [0]
    ref = _check(q, kp, vp, bt, sl, qo, dtype)
    tdt = DTYPES[dtype][0]
    targs = ([torch.from_numpy(a).to(tdt) for a in (q, kp, vp)]
             + [torch.from_numpy(bt), torch.tensor(sl, dtype=torch.int32),
                torch.tensor(qo, dtype=torch.int32)])
    _, _, interp, _ = _both(q, kp, vp, bt, sl, qo, dtype)
    atol, rtol = pallas_ops.PAGED_PARITY_TOL[dtype]
    for chunk in (C, 3):
        split = pa.paged_attention_split_ref(*targs, chunk=chunk)
        split = split.float().numpy()
        assert np.isfinite(split).all()
        np.testing.assert_allclose(split, ref, atol=atol, rtol=rtol)
        np.testing.assert_allclose(split, interp, atol=atol, rtol=rtol)


def _drop_keys_out(q, kp, vp, bt, sl, qo, drop):
    """The exact output with the key positions in ``drop`` left out, as a
    kernel that lost them would give it, rounded to q's dtype."""
    f32 = [t.float() for t in (q, kp, vp)]
    k_view, v_view = pa.paged_view(f32[1], bt), pa.paged_view(f32[2], bt)
    S = k_view.shape[1]
    keep = pa.position_mask(qo, sl, q.shape[1], S)
    keep = keep & ~torch.isin(torch.arange(S), torch.tensor(drop))
    return attention(f32[0], k_view, v_view, mask=keep).to(q.dtype)


@pytest.mark.parametrize("lens,T", [([1024, 1024], 1), ([2048, 300], 1),
                                    ([257, 700], 4)],
                         ids=["2x1024", "2048_beside_300", "verify_span"])
@pytest.mark.parametrize("drop", [[300], list(range(320, 384))],
                         ids=["one_key", "one_fetch"])
def test_bf16_relative_bound_separates_rounding_from_a_dropped_key(
        lens, T, drop):
    # PAGED_PARITY_REL's bf16 bound against what it must tell apart, at
    # the serving shapes (head_dim 64, blocks of 16): the kernel's own
    # rounding (float32 arithmetic over chunks, the output rounded to bf16:
    # paged_attention_split_ref) stays within bf16's unit roundoff of the
    # plain version in float32 on the same values, below the bound, while
    # one key, or one fetch of 64 keys, left out of each slot lands more
    # than twice the bound away. The elementwise PAGED_PARITY_TOL misses
    # the dropped key: that is why both are held.
    g = torch.Generator().manual_seed(len(drop) + T)
    B, H, Dh, bs, M = len(lens), 4, 64, 16, 128
    q = torch.randn(B, T, H, Dh, generator=g).bfloat16()
    kp, vp = (torch.randn(B * M + 1, bs, H, Dh, generator=g).bfloat16()
              for _ in range(2))
    bt = (torch.randperm(B * M, generator=g) + 1).view(B, M).int()
    sl = torch.tensor(lens, dtype=torch.int32)
    qo = sl - T
    args = (q, kp, vp, bt, sl, qo)
    exact = pa.paged_attention_ref(*[t.float() for t in args[:3]], *args[3:])
    plain = pa.paged_attention_ref(*args)
    bound = pa.PAGED_PARITY_REL[torch.bfloat16]
    honest = pa.paged_attention_split_ref(*args, chunk=256)
    assert pa.paged_rel_err(honest, exact) <= 2 ** -8
    faulty = _drop_keys_out(*args, drop)
    assert pa.paged_rel_err(faulty, exact) > 2 * bound
    if drop == [300]:
        atol, rtol = pa.PAGED_PARITY_TOL[torch.bfloat16]
        err = (faulty.float() - plain.float()).abs()
        assert bool((err <= atol + rtol * plain.float().abs()).all())


def test_relative_error_is_per_slot_and_head():
    want = torch.ones(2, 3, 4, 8)
    got = want.clone()
    assert pa.paged_rel_err(got, want) == 0.0
    got[1, :, 2] *= 1.1     # one (slot, head): 10% off in norm
    assert abs(pa.paged_rel_err(got, want) - 0.1) < 1e-6
    got[0, 0, 0, 0] = float("nan")
    assert not pa.paged_rel_err(got, want) <= 1.0
