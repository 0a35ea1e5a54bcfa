"""The port's functional routes to the attention kernels against the JAX
package's: ``scaled_dot_product_attention`` (plain, causal, masked: the
reference's plain route on the CPU, as its own tests run it; the port's
kernel route on the CPU is the kernels' plain versions) and
``paged_attention`` under each ``kernel`` name (the reference's
"interpret" runs its Pallas kernel body through the interpreter) and on
a mesh of two ranks.

Inputs: small float32 arrays from a seeded numpy generator; attention is
held to 1e-4 absolute and relative (the routes sum the keys in another
order, as in ``test_torch_flash_attention.py``), paged attention to the
reference's ``PAGED_PARITY_TOL``. The reference fault of the attention
dropout (ROADMAP queue 3) runs both packages.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.nn.functional as jF  # noqa: E402
from functional_parity import (ATTN_TOL, _arr, _close, _equal, _j,  # noqa: E402
                               _np, _parity, _t)
from paddle_tpu.ops import pallas_ops  # noqa: E402
from paddle_tpu_torch.nn import functional as tF  # noqa: E402
from paddle_tpu_torch.ops import paged_attention as pa  # noqa: E402
from paddle_tpu_torch.testing.world import World  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)


# ---------------------------------------------------------- attention ---
@pytest.mark.parametrize("case", ["plain", "causal", "mask"])
def test_scaled_dot_product_attention(case):
    B, T, N, H = 2, 128, 2, 64
    q, k, v = (_arr((B, T, N, H), s) for s in (1, 2, 3))
    mask = (np.random.default_rng(4).random((B, 1, T, T)) > 0.3) \
        if case == "mask" else None
    causal = case == "causal"

    def jfn(a, b, c):
        m = None if mask is None else _j(mask)
        return jF.scaled_dot_product_attention(a, b, c, m, is_causal=causal)

    def tfn(a, b, c):
        m = None if mask is None else _t(mask)
        return tF.scaled_dot_product_attention(a, b, c, m, is_causal=causal)

    _parity(jfn, tfn, [q, k, v], ATTN_TOL)


def test_reference_fault_sdpa_dropout():
    """Paddle drops the attention probabilities; the reference drops the
    output. The port drops the probabilities on CPU tensors (on CUDA
    tensors it raises: ``test_torch_cuda.py``)."""
    B, T, N, H = 2, 128, 2, 64
    q, k, v = (_arr((B, T, N, H), s) for s in (1, 2, 3))
    key = torch.tensor([3, 5])
    got = tF.scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                          dropout_p=0.5, dropout_key=key)
    # by hand: softmax, the same keyed mask on the probabilities, PV
    s = torch.einsum("bqnh,bknh->bnqk", _t(q), _t(k)) * H ** -0.5
    p = tF.dropout(torch.softmax(s, -1), 0.5, key=key)
    _close(got, torch.einsum("bnqk,bknh->bqnh", p, _t(v)), tol=ATTN_TOL)
    # the reference's output has whole elements dropped; the port's none
    paddle.seed(0)
    ref = _np(jF.scaled_dot_product_attention(_j(q), _j(k), _j(v),
                                              dropout_p=0.5))
    assert 0.4 < (ref == 0).mean() < 0.6
    assert (_np(got) == 0).mean() < 0.01
    _close(tF.scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                           dropout_p=0.5, training=False),
           jF.scaled_dot_product_attention(_j(q), _j(k), _j(v),
                                           dropout_p=0.5, training=False),
           tol=ATTN_TOL)


def _paged_case(seed=0, B=3, T=1, H=4, Dh=64, Nb=12, bs=4, M=3):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    kp = rng.standard_normal((Nb, bs, H, Dh)).astype(np.float32)
    vp = rng.standard_normal((Nb, bs, H, Dh)).astype(np.float32)
    bt = rng.permutation(np.arange(1, Nb))[:B * M].reshape(B, M) \
        .astype(np.int32)
    sl = np.array([5, 12, 9], np.int32)[:B]
    qo = (sl - T).astype(np.int32)
    return q, kp, vp, bt, sl, qo


@pytest.mark.parametrize("kernel", ["pallas", "interpret", "xla"])
def test_paged_attention(kernel):
    args = _paged_case()
    want = np.asarray(pallas_ops.paged_attention(
        *map(jnp.asarray, args),
        kernel="xla" if kernel == "xla" else "interpret"))
    got = tF.paged_attention(*map(_t, args), kernel=kernel)
    _close(got, want, tol=dict(zip(("atol", "rtol"),
                                   pallas_ops.PAGED_PARITY_TOL["float32"])))
    direct = (pa.paged_attention_ref if kernel == "xla"
              else pa.paged_attention)(*map(_t, args))
    _equal(got, direct)
    with pytest.raises(ValueError, match="kernel"):
        tF.paged_attention(*map(_t, args), kernel="mosaic")


def _paged_on_mesh(args):
    from paddle_tpu_torch.distributed import spmd
    from paddle_tpu_torch.nn import functional as F

    mesh = spmd.serving_mesh(2)
    out = F.paged_attention(*map(torch.from_numpy, args), kernel="pallas",
                            mesh=mesh)
    return out.numpy()


def test_paged_attention_per_shard_on_a_mesh(tmp_path):
    """``mesh=`` of two ranks: each runs K4 (on the CPU, its plain
    version) over its half of the heads and gathers the rest; both ranks
    return the single-card result, bitwise."""
    args = _paged_case(seed=1)
    single = tF.paged_attention(*map(_t, args), kernel="pallas")
    world = World(2, tmp_path, timeout=60)
    try:
        outs = world.run(_paged_on_mesh, args)
    finally:
        world.close()
    for out in outs:
        _equal(out, single)
