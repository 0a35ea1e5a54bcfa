"""The port's sampling against the JAX package's.

``sample_tokens`` and the two filters must give the reference's results
exactly for the same numpy logits and the same Gumbel noise. The noise
itself cannot match: the reference draws it from JAX's threefry, the port
from a counter-based generator in torch integer ops, whose own contract —
deterministic, and a function of (request key, token index) only — is
tested here.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.serving import sampling as jsamp  # noqa: E402
from paddle_tpu_torch.serving import sampling as tsamp  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

B, V = 8, 64


def _inputs(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    gumbel = rng.gumbel(size=(B, V)).astype(np.float32)
    # rows: greedy, temperature, top-k, top-p, top-k + top-p, tiny top-p,
    # top-k of 1, greedy that ignores its filters
    temp = np.array([0.0, 0.7, 1.0, 0.9, 1.3, 0.5, 2.0, 0.0], np.float32)
    top_k = np.array([0, 0, 5, 0, 10, 0, 1, 3], np.int32)
    top_p = np.array([1.0, 1.0, 1.0, 0.8, 0.6, 1e-3, 1.0, 0.5], np.float32)
    return logits, gumbel, temp, top_k, top_p


@pytest.mark.parametrize("seed", range(4))
def test_sample_tokens_match_reference(seed):
    logits, gumbel, temp, top_k, top_p = _inputs(seed)
    want = np.asarray(jsamp.sample_tokens(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p), jnp.asarray(gumbel)))
    got = tsamp.sample_tokens(
        torch.from_numpy(logits), torch.from_numpy(temp),
        torch.from_numpy(top_k), torch.from_numpy(top_p),
        torch.from_numpy(gumbel)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert (got[[0, 7]] == logits[[0, 7]].argmax(-1)).all()


@pytest.mark.parametrize("seed", range(2))
def test_filters_match_reference(seed):
    logits, _, _, top_k, top_p = _inputs(seed)
    jk = np.asarray(jsamp.filter_top_k(jnp.asarray(logits),
                                       jnp.asarray(top_k)))
    tk = tsamp.filter_top_k(torch.from_numpy(logits),
                            torch.from_numpy(top_k)).numpy()
    np.testing.assert_array_equal(tk, jk)
    jp = np.asarray(jsamp.filter_top_p(jnp.asarray(logits),
                                       jnp.asarray(top_p)))
    tp = tsamp.filter_top_p(torch.from_numpy(logits),
                            torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(tp, jp)


def _keys(seeds):
    base = torch.tensor([12345, 678], dtype=torch.int64)
    return torch.stack([tsamp.request_key(base, s) for s in seeds])


def test_gumbel_rows_deterministic_and_batch_independent():
    keys = _keys([0, 1, 2, 3])
    idx = torch.tensor([0, 5, 5, 9])
    rows = tsamp.gumbel_rows(keys, idx, 1000)
    assert rows.shape == (4, 1000) and rows.dtype == torch.float32
    assert torch.isfinite(rows).all()
    assert torch.equal(rows, tsamp.gumbel_rows(keys, idx, 1000))
    # a row depends on its own (key, token index) only: permuted or solo
    perm = [2, 0, 3, 1]
    assert torch.equal(tsamp.gumbel_rows(keys[perm], idx[perm], 1000),
                       rows[perm])
    for b in range(4):
        assert torch.equal(tsamp.gumbel_rows(keys[b:b + 1], idx[b:b + 1],
                                             1000), rows[b:b + 1])
    # other token index or other request: other noise
    assert not torch.equal(tsamp.gumbel_rows(keys[:1], idx[:1] + 1, 1000),
                           rows[:1])
    assert not torch.equal(rows[1], rows[2])


def test_gumbel_rows_distribution():
    # standard Gumbel: mean = Euler's gamma, std = pi / sqrt(6); 200k
    # draws put the sample mean within 0.01 and the std within 0.01
    keys = _keys(range(4))
    x = tsamp.gumbel_rows(keys, torch.arange(4), 50_000).double()
    assert abs(x.mean().item() - 0.5772156649) < 0.01
    assert abs(x.std().item() - np.pi / np.sqrt(6)) < 0.01


def test_request_key_depends_on_base_and_seed():
    base = torch.tensor([1, 2], dtype=torch.int64)
    k = tsamp.request_key(base, 7)
    assert torch.equal(k, tsamp.request_key(base, 7))
    assert not torch.equal(k, tsamp.request_key(base, 8))
    assert not torch.equal(k, tsamp.request_key(torch.tensor([1, 3]), 7))
    assert ((k >= 0) & (k < 2 ** 32)).all()
