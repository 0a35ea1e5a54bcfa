"""The port's GPT against the JAX package's, with the JAX model's weights
carried across by ``paddle_tpu_torch.convert``.

Model: the ``gpt2-tiny`` preset with vocab 96 and initializer_range 0.35 (as
tests/test_paged_kernel.py builds it), float32. Tolerance: 1e-4 absolute and
relative — float32 matmuls in both frameworks ("highest" precision in the
reference, TF32 off in the port) that differ only in reduction order.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.core import dispatch  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
VOCAB = 96


def _jax_model(seed=3):
    # seeded, then the global generator is put back: later tests in this
    # process draw what they would have drawn without this file
    state = paddle.get_rng_state()
    try:
        paddle.seed(seed)
        cfg = jgpt.GPTConfig.preset("gpt2-tiny", vocab_size=VOCAB,
                                    initializer_range=0.35)
        m = jgpt.GPTForPretraining(jgpt.GPTModel(cfg))
    finally:
        paddle.set_rng_state(state)
    m.eval()
    return m


def _np_state(jmodel):
    return {k: np.asarray(v.numpy()) for k, v in jmodel.state_dict().items()}


def _torch_model(np_state):
    cfg = tgpt.GPTConfig.preset("gpt2-tiny", vocab_size=VOCAB,
                                initializer_range=0.35)
    m = tgpt.GPTForPretraining(tgpt.GPTModel(cfg, device="cpu"))
    convert.load_paddle_tpu_state(m, np_state)
    return m.eval()


@pytest.fixture(scope="module")
def pair():
    jm = _jax_model()
    return jm, _torch_model(_np_state(jm))


def test_cacheless_logits_match(pair):
    jm, tm = pair
    ids = np.random.default_rng(0).integers(0, VOCAB, (2, 40))
    with paddle.no_grad():
        want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_paged_prefill_and_decode_per_layer(pair):
    # two slots (prompts of 11 and 7 tokens, one 16-row bucket) through one
    # paged prefill, then three paged decode steps; every layer's output is
    # held against the reference's. Decode runs the reference's Pallas body
    # (interpreter) and the port's plain version of the kernel.
    jm, tm = pair
    # the reference's per-op jit cache keys a scalar attribute by value, so
    # after an earlier test's `x * 4.0` its `phys * bs` comes out float
    # (ROADMAP queue 3): start from an empty cache
    dispatch._jit_cache.clear()
    rng = np.random.default_rng(1)
    bs, M = 4, 32
    Nb = 1 + 2 * M
    H, Dh, L = 4, 32, 16
    bt = np.arange(1, Nb, dtype=np.int32).reshape(2, M)
    lens = np.array([11, 7], np.int32)
    ids = np.zeros((2, L), np.int64)
    ids[0, :11] = rng.integers(0, VOCAB, 11)
    ids[1, :7] = rng.integers(0, VOCAB, 7)
    jcache = [(paddle.to_tensor(np.zeros((Nb, bs, H, Dh), np.float32)),
               paddle.to_tensor(np.zeros((Nb, bs, H, Dh), np.float32)))
              for _ in jm.gpt.blocks]
    tcache = [(torch.zeros(Nb, bs, H, Dh), torch.zeros(Nb, bs, H, Dh))
              for _ in tm.gpt.blocks]

    def run(tokens, positions, offsets, seq_lens, kinds):
        jk, tk = kinds
        with paddle.no_grad():
            jx = jm.gpt.embeddings(paddle.to_tensor(tokens),
                                   paddle.to_tensor(positions))
            jouts = []
            for i, blk in enumerate(jm.gpt.blocks):
                jx, jcache[i] = blk(
                    jx, cache=jcache[i],
                    cache_offset=paddle.to_tensor(offsets),
                    seq_lens=paddle.to_tensor(seq_lens),
                    block_tables=paddle.to_tensor(bt), paged_kernel=jk)
                jouts.append(np.asarray(jx.numpy()))
        with torch.no_grad():
            off_t = torch.from_numpy(offsets)
            sl_t = torch.from_numpy(seq_lens)
            bt_t = torch.from_numpy(bt)
            rows = tgpt.paged_write_rows(off_t, sl_t, bt_t, bs,
                                         tokens.shape[1])
            tx = tm.gpt.embeddings(torch.from_numpy(tokens),
                                   torch.from_numpy(positions))
            touts = []
            for i, blk in enumerate(tm.gpt.blocks):
                tx = blk(tx, cache=tcache[i],
                         paged=(bt_t, sl_t, off_t, rows, tk))
                touts.append(tx.numpy())
        for layer, (got, want) in enumerate(zip(touts, jouts)):
            # padded prefill rows carry garbage in both; compare live rows
            live = np.arange(tokens.shape[1])[None] < (seq_lens - offsets)[
                :, None]
            np.testing.assert_allclose(got[live], want[live], **TOL,
                                       err_msg=f"layer {layer}")

    positions = np.broadcast_to(np.arange(L), (2, L)).copy()
    run(ids, positions, np.zeros(2, np.int32), lens, (None, None))
    cur = lens.copy()
    for _ in range(3):
        tok = rng.integers(0, VOCAB, (2, 1))
        run(tok, cur[:, None].astype(np.int64), cur.copy(), cur + 1,
            ("interpret", "torch"))
        cur += 1
    # the pools themselves agree row for row
    for (jk, jv), (tk, tv) in zip(jcache, tcache):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk.numpy()), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv.numpy()), **TOL)


def test_converter_accepts_a_framework_save_pickle(pair, tmp_path):
    jm, tm = pair
    path = tmp_path / "gpt.pdparams"
    paddle.save(jm.state_dict(), str(path))
    fresh = _torch_model(str(path))
    for (n, a), (_, b) in zip(tm.state_dict().items(),
                              fresh.state_dict().items()):
        assert torch.equal(a, b), n
    # the inner trunk takes the wrapper's "gpt." names too
    inner = tgpt.GPTModel(tm.gpt.cfg, device="cpu")
    convert.load_paddle_tpu_state(inner, _np_state(jm))
    assert torch.equal(inner.blocks[0].attn.qkv_proj.weight,
                       tm.gpt.blocks[0].attn.qkv_proj.weight)


def test_converter_transposes_and_casts(pair):
    jm, tm = pair
    state = _np_state(jm)
    w = state["gpt.blocks.0.mlp.fc1.weight"]
    assert w.shape == (128, 512)
    got = tm.gpt.blocks[0].mlp.fc1.weight
    assert tuple(got.shape) == (512, 128)
    np.testing.assert_array_equal(got.detach().numpy(), w.T)
    cfg = tgpt.GPTConfig.preset("gpt2-tiny", vocab_size=VOCAB,
                                dtype="bfloat16")
    half = convert.state_from_paddle_tpu(
        state, tgpt.GPTForPretraining(tgpt.GPTModel(cfg, device="cpu")))
    assert all(t.dtype == torch.bfloat16 for t in half.values())


def test_converter_refuses_mismatches(pair):
    jm, tm = pair
    state = _np_state(jm)
    missing = dict(state)
    del missing["gpt.ln_f.bias"]
    with pytest.raises(KeyError, match="missing.*ln_f.bias"):
        convert.state_from_paddle_tpu(missing, tm)
    extra = dict(state, **{"gpt.blocks.9.ln1.weight": np.ones(128)})
    with pytest.raises(KeyError, match="extra.*blocks.9"):
        convert.state_from_paddle_tpu(extra, tm)
    bad = dict(state)
    bad["gpt.blocks.1.attn.out_proj.weight"] = np.zeros((128, 64))
    with pytest.raises(ValueError, match="out_proj.weight"):
        convert.state_from_paddle_tpu(bad, tm)


def test_config_accounting_matches_reference():
    for name in tgpt.GPTConfig.PRESETS:
        if "moe" in name:
            continue
        a = tgpt.GPTConfig.preset(name)
        b = jgpt.GPTConfig.preset(name)
        assert (a.num_params(), a.flops_per_token()) \
            == (b.num_params(), b.flops_per_token())
    assert tgpt.GPTConfig.PRESETS == jgpt.GPTConfig.PRESETS
    # the MoE preset builds, with the reference's MoE defaults
    a = tgpt.GPTConfig.preset("gpt2-tiny-moe")
    b = jgpt.GPTConfig.preset("gpt2-tiny-moe")
    fields = ("moe_num_experts", "moe_top_k", "moe_capacity_factor",
              "moe_every", "moe_aux_weight")
    assert [getattr(a, f) for f in fields] == [getattr(b, f) for f in fields]
    model = tgpt.GPTModel(a, device="cpu")
    assert type(model.blocks[0].mlp).__name__ == "MoEMLP"


def test_seeded_init_is_reproducible():
    cfg = tgpt.GPTConfig.preset("gpt2-tiny", vocab_size=VOCAB)
    a, b = (tgpt.GPTModel(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(5))
            for _ in range(2))
    for (n, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), n
    std = a.blocks[0].attn.qkv_proj.weight.std().item()
    assert abs(std - 0.02) < 0.002
    assert torch.equal(a.ln_f.weight, torch.ones(128))
