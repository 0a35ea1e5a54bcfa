"""The reference's two older KV-cache forms of ``GPTModel.forward``, ported:
the slot cache (``caches`` of ``[B, S, H, Dh]`` buffers with
``cache_offsets`` and ``seq_lens``) and the growing concat (``caches``
alone), against the JAX package's.

Model: ``gpt2-tiny`` with vocab 96, float32, the JAX model's weights carried
into the port by ``convert``. Tolerance: hidden states and cache buffers
within 1e-5 absolute and relative (float32 summed in another order).
The reference's concat branch attends without a mask, so a span of more
than one row sees its own later rows (ROADMAP queue 3); the port masks by
absolute position, which equals the reference for one-row spans and the
causal cache-less forward for any span.
"""
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402

VOCAB = 96
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def models():
    state = paddle.get_rng_state()
    try:
        paddle.seed(17)
        jm = jgpt.GPTModel(jgpt.GPTConfig.preset("gpt2-tiny",
                                                 vocab_size=VOCAB))
    finally:
        paddle.set_rng_state(state)
    tm = tgpt.GPTModel(tgpt.GPTConfig.preset("gpt2-tiny", vocab_size=VOCAB),
                       device="cpu")
    convert.load_paddle_tpu_state(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return jm, tm


def _empty(m, B, S, zeros):
    return [(zeros([B, S, b.attn.n_head, b.attn.head_dim]),
             zeros([B, S, b.attn.n_head, b.attn.head_dim]))
            for b in m.blocks]


def _both(models, toks, pos, jc, tc, **kw):
    """One forward of each package; returns both hidden states (numpy) and
    both new caches."""
    jm, tm = models
    jkw = {k: paddle.to_tensor(v) for k, v in kw.items()}
    with paddle.no_grad():
        jh, jc = jm(paddle.to_tensor(toks), paddle.to_tensor(pos),
                    caches=jc, **jkw)
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    with torch.no_grad():
        th, tc = tm(torch.from_numpy(toks), torch.from_numpy(pos),
                    caches=tc, **tkw)
    return np.asarray(jh.numpy()), th.numpy(), jc, tc


def test_slot_cache_matches_reference(models):
    B, S = 2, 24
    rng = np.random.default_rng(0)
    jc = _empty(models[0], B, S, lambda s: paddle.zeros(s))
    tc = _empty(models[1], B, S, lambda s: torch.zeros(s))
    # a prefill span (slot 1 padded past its length), three decode
    # steps, then a span that runs past the buffer's end in both slots:
    # its rows at or past S are dropped, as the reference's scatter does
    steps = [(np.zeros(B, np.int32), np.array([8, 5], np.int32), 8)]
    steps += [(np.array([8 + i, 5 + i], np.int32),
               np.array([9 + i, 6 + i], np.int32), 1) for i in range(3)]
    steps.append((np.array([21, 22], np.int32),
                  np.array([25, 26], np.int32), 4))
    for offsets, lens, T in steps:
        toks = rng.integers(0, VOCAB, (B, T))
        pos = offsets[:, None].astype(np.int64) + np.arange(T)
        jh, th, jc, tc = _both(models, toks, pos, jc, tc,
                               cache_offsets=offsets, seq_lens=lens)
        np.testing.assert_allclose(th, jh, **TOL)
        for (jk, jv), (tk, tv) in zip(jc, tc):
            assert tuple(tk.shape) == (B, S, 4, 32)
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk.numpy()),
                                       **TOL)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv.numpy()),
                                       **TOL)


def test_one_row_concat_decoding_matches_reference_and_full_forward(models):
    _, tm = models
    toks = np.random.default_rng(1).integers(0, VOCAB, (2, 8))
    jc = _empty(models[0], 2, 0, lambda s: paddle.zeros(s))
    tc = _empty(tm, 2, 0, lambda s: torch.zeros(s))
    outs = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for t in range(8):
            pos = np.full((2, 1), t, np.int64)
            jh, th, jc, tc = _both(models, toks[:, t:t + 1], pos, jc, tc)
            np.testing.assert_allclose(th, jh, **TOL)
            outs.append(th)
    assert tuple(tc[0][0].shape) == (2, 8, 4, 32)
    with torch.no_grad():
        full = tm(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(np.concatenate(outs, axis=1), full, **TOL)


def test_multi_row_concat_span_is_causal_in_the_port_only(models):
    # Reference fault (ROADMAP queue 3): its concat branch passes
    # is_causal=False and no mask, so a 6-row span from an empty cache
    # attends to its own later rows and differs from the causal forward;
    # the port's equals the causal forward (the same in both packages)
    jm, tm = models
    toks = np.random.default_rng(2).integers(0, VOCAB, (2, 6))
    pos = np.broadcast_to(np.arange(6), (2, 6)).copy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jh, th, _, _ = _both(
            models, toks, pos, _empty(jm, 2, 0, lambda s: paddle.zeros(s)),
            _empty(tm, 2, 0, lambda s: torch.zeros(s)))
    with paddle.no_grad():
        jfull = np.asarray(jm(paddle.to_tensor(toks)).numpy())
    with torch.no_grad():
        tfull = tm(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(th, tfull, **TOL)
    assert not np.allclose(jh, jfull, atol=1e-3)
    np.testing.assert_allclose(tfull, jfull, **TOL)


def test_growing_concat_cache_warns_once(models):
    _, tm = models
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, VOCAB, (1, 4)))
    caches = _empty(tm, 1, 0, lambda s: torch.zeros(s))
    tgpt._legacy_cache_warned = False
    with torch.no_grad():
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            _, caches = tm(toks[:, :1], caches=caches)
        hits = [w for w in rec if "serving.GenerationEngine" in
                str(w.message)]
        assert len(hits) == 1 and "CUDA graph" in str(hits[0].message)
        with warnings.catch_warnings(record=True) as rec2:
            warnings.simplefilter("always")
            tm(toks[:, 1:2], torch.tensor([[1]]), caches=caches)
        assert not [w for w in rec2 if "serving.GenerationEngine" in
                    str(w.message)]
    # the slot cache is not the legacy concat path: no warning
    tgpt._legacy_cache_warned = False
    with torch.no_grad(), warnings.catch_warnings(record=True) as rec3:
        warnings.simplefilter("always")
        tm(toks, caches=_empty(tm, 1, 8, lambda s: torch.zeros(s)),
           cache_offsets=torch.zeros(1, dtype=torch.int32),
           seq_lens=torch.full((1,), 4, dtype=torch.int32))
    assert not rec3
    with pytest.raises(ValueError, match="seq_lens"):
        tm(toks, caches=_empty(tm, 1, 8, lambda s: torch.zeros(s)),
           cache_offsets=torch.zeros(1, dtype=torch.int32))
