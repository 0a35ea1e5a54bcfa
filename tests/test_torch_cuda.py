"""paddle_tpu_torch's CUDA kernels on the card, against their plain versions.

Needs a CUDA device and nvcc; skipped elsewhere. On the card run
``python -m pytest --noconftest tests/test_torch_cuda.py`` (the repo's
conftest imports JAX, which the card machine need not have).
Tolerances: ``PAGED_PARITY_TOL`` for the paged kernel (float32 reduction
order; bf16 probabilities rounded before the PV product in the plain
version) and ``PAGED_PARITY_REL`` per (slot, head) relative to the plain
version computed in float32 (the kernel's bf16 output rounding);
``FLASH_PARITY_TOL`` elementwise and ``FLASH_PARITY_REL`` block
by block relative to the plain version's norm for the flash kernels
(float32: summation order, and split TF32's dropped lo.lo term in K1, K2
and K3 at head_dim 64 and 128; bf16 P and dS rounded before the tensor-core
products in the kernels).
"""
import math

import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import paged_attention as pa

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode "
                    "(the CPU suite covers its plain version)")
    return torch.device("cuda", 0)


def _case(dev, dtype, T, Dh, bs, lens, seed, M=None):
    g = torch.Generator().manual_seed(seed)
    B, H = len(lens), 4
    if M is None:
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


# live lengths, given the kernel's split chunk C: ragged; on the edges of
# C; and a slot shorter than one chunk beside one of 2048 and one of C + 2,
# whose verify span ends in two splits (lane 1 is the inactive lane)
SPLIT_LENS = {"ragged": lambda C: [37, 9, 16, 300],
              "chunk_edges": lambda C: [C - 1, 9, C, C + 1],
              "short_beside_long": lambda C: [100, 9, 2048, C + 2]}


@pytest.mark.parametrize("lens", list(SPLIT_LENS.values()),
                         ids=list(SPLIT_LENS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 3, 5, 8])
@pytest.mark.parametrize("Dh,bs", [(64, 16), (128, 16), (64, 5), (128, 1)])
def test_kernel_matches_plain_version(cuda, dtype, T, Dh, bs, lens):
    args = _case(cuda, dtype, T, Dh, bs, lens(pa.split_keys()), seed=T + bs)
    _assert_kernel_matches(args, dtype)


def _assert_kernel_matches(args, dtype):
    out = pa.paged_attention(*args)
    torch.cuda.synchronize()
    ref = pa.paged_attention_ref(*args)
    atol, rtol = pa.PAGED_PARITY_TOL[dtype]
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)
    exact = pa.paged_attention_ref(*(a.float() for a in args[:3]), *args[3:])
    assert pa.paged_rel_err(out, exact) <= pa.PAGED_PARITY_REL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [5, 8])
@pytest.mark.parametrize("Dh", [64, 128])
def test_kernel_stops_at_the_tables_last_row(cuda, dtype, T, Dh):
    # a verify span at the cache ceiling: cursors up to the table's last
    # row (M = 4 blocks of 16), seq_lens = cursor + T past it; the keys end
    # at row 63, as in the plain version's view
    args = _case(cuda, dtype, T, Dh, 16, [63 + T, 9, 62 + T, 60 + T],
                 seed=T + Dh, M=4)
    _assert_kernel_matches(args, dtype)


def test_kernel_refuses_what_it_does_not_take(cuda):
    args = list(_case(cuda, torch.float32, 1, 64, 16, [20, 9, 16, 30], 0))
    args[3] = args[3].long()
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention(*args)


def test_launch_tally_counts_each_instance_and_graph_replays(cuda):
    # the card counts every launch of the split pass per instance, replays
    # of a captured graph included (the Python counter moves at capture)
    dec = _case(cuda, torch.bfloat16, 1, 64, 16, [20, 9, 16, 30], 1)
    ver = _case(cuda, torch.float32, 5, 128, 16, [20, 9, 16, 30], 2)
    pa.paged_attention(*dec)
    pa.paged_attention(*ver)  # loads the library, sizes the workspaces
    pa.reset_device_launches()
    pa.paged_attention(*ver)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pa.paged_attention(*dec)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        pa.paged_attention(*dec)
    for _ in range(3):
        graph.replay()
    assert pa.device_launches() == {("bfloat16", 64, 1): 4,
                                    ("float32", 128, 8): 1}
    pa.reset_device_launches()
    assert pa.device_launches() == {}


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


def _tiny_gpt(dev, n_layer, seed, **over):
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel)

    cfg = GPTConfig(vocab_size=512, n_layer=n_layer, n_head=4, d_model=256,
                    seq_len=256, initializer_range=0.2, **over)
    return GPTForPretraining(GPTModel(
        cfg, device=dev, generator=torch.Generator(dev).manual_seed(seed)))


def test_graph_step_equals_its_body_called_eagerly(cuda):
    import numpy as np

    from paddle_tpu_torch.serving import GenerationEngine

    model = _tiny_gpt(cuda, 2, 0)
    outs = []
    for replay in (True, False):
        eng = GenerationEngine(model, max_batch_size=2, rng_seed=3,
                               block_size=16, device=cuda)
        toks = [eng.prefill(0, list(range(3, 40)), seed=0),
                eng.prefill(1, list(range(7, 20)), seed=1, temperature=0.8)]
        if not replay:  # the same buffers, the body run from Python
            for buf, host in eng._mirrors():
                buf.copy_(torch.from_numpy(np.ascontiguousarray(host)))
        for _ in range(12):
            if replay:
                toks.extend(eng.decode_step().tolist())
            else:
                eng._decode_body()
                t = eng._d_toks.cpu().numpy()
                eng._finish_decode(eng._active, 2, t)
                toks.extend(t.tolist())
        outs.append(toks)
    assert outs[0] == outs[1]
    assert eng._decode_graph.replays == 0


@pytest.mark.parametrize("drafter_seed,n_layer", [(0, 2), (5, 1)],
                         ids=["twin", "independent"])
def test_spec_graphs_equal_plain_decode(cuda, drafter_seed, n_layer):
    from paddle_tpu_torch.serving import DraftVerifyEngine, GenerationEngine

    model = _tiny_gpt(cuda, 2, 0)
    spec = DraftVerifyEngine(model, _tiny_gpt(cuda, n_layer, drafter_seed),
                             draft_k=4, max_batch_size=2, rng_seed=3,
                             block_size=16, device=cuda)
    plain = GenerationEngine(model, max_batch_size=2, rng_seed=3,
                             block_size=16, device=cuda)
    for opts in (dict(seed=0), dict(seed=2, temperature=0.8)):
        got = [spec.prefill(0, list(range(3, 40)), **opts)]
        while len(got) < 30:
            got.extend(spec.decode_step_spec()[0])
        want = [plain.prefill(0, list(range(3, 40)), **opts)]
        while len(want) < 30:
            want.append(int(plain.decode_step()[0]))
        assert got[:30] == want[:30]
        spec.release(0)
        plain.release(0)
    assert spec._verify_graph.captured and spec._draft_graph.captured
    spec.pool.audit()
    spec.draft_pool.audit()


def _greedy(eng, prompt=tuple(range(3, 40)), n=16):
    toks = [eng.prefill(0, list(prompt), seed=0)]
    while len(toks) < n:
        toks.append(int(eng.decode_step()[0]))
    eng.release(0)
    return toks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swap_on_a_captured_engine_copies_in_place(cuda, dtype):
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel)
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import GenerationEngine

    def build(seed):
        cfg = GPTConfig(vocab_size=512, n_layer=2, n_head=4, d_model=256,
                        seq_len=256, initializer_range=0.2, dtype=dtype)
        return GPTForPretraining(GPTModel(
            cfg, device=cuda,
            generator=torch.Generator(cuda).manual_seed(seed)))

    kw = dict(max_batch_size=2, rng_seed=3, block_size=16, device=cuda)
    eng = GenerationEngine(build(0), **kw)
    _greedy(eng)  # captures the decode graph
    assert eng._decode_graph.captured
    ptrs = {k: v.data_ptr() for k, v in eng._state.items()}
    head = eng._head_w.data_ptr()
    b = build(1)
    # the reference's layout, as a checkpoint holds it
    state = {k: v.float().cpu().numpy()
             for k, v in convert.state_to_paddle_tpu(b.gpt).items()}
    c0 = registry.counters("serving")["decode_compiles"]
    eng.swap_weights(state)
    assert {k: v.data_ptr() for k, v in eng._state.items()} == ptrs
    assert eng._head_w.data_ptr() == head
    got = _greedy(eng)
    assert registry.counters("serving")["decode_compiles"] == c0
    assert got == _greedy(GenerationEngine(b, **kw))


def test_reprime_recaptures_once(cuda):
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import GenerationEngine

    eng = GenerationEngine(_tiny_gpt(cuda, 2, 0), max_batch_size=2,
                           rng_seed=3, block_size=16, device=cuda)
    want = _greedy(eng)
    c0 = registry.counters("serving")
    eng.reprime()
    assert not eng._decode_graph.captured
    assert _greedy(eng) == want
    c1 = registry.counters("serving")
    assert c1["decode_compiles"] == c0["decode_compiles"] + 1
    assert c1["reprimes"] == c0["reprimes"] + 1


def test_one_prefill_graph_per_bucket_equal_to_its_body(cuda):
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import GenerationEngine

    eng = GenerationEngine(_tiny_gpt(cuda, 2, 0), max_batch_size=2,
                           rng_seed=3, block_size=16, device=cuda)
    c0 = registry.counters("serving")["prefill_compiles"]
    # two prompts in bucket 16, one in 32, one in 64, one sampled
    for n, opts in ((9, {}), (15, {}), (20, {}),
                    (50, dict(temperature=0.8, top_p=0.9))):
        tok = eng.prefill(0, list(range(3, 3 + n)), seed=n, **opts)
        pb = eng._prefill_buckets[eng.bucket_for(n)]
        idx = torch.tensor(eng._slot_blocks[0], device=cuda)
        rows = [(k[idx].clone(), v[idx].clone()) for k, v in eng._kv]
        with torch.no_grad():
            pb.body()  # the same body on the same buffers, from Python
        assert int(pb.token.item()) == tok
        for (k, v), (k0, v0) in zip(eng._kv, rows):
            assert torch.equal(k[idx], k0) and torch.equal(v[idx], v0)
        eng.release(0)
    assert registry.counters("serving")["prefill_compiles"] == c0 + 3
    assert sorted(eng._prefill_buckets) == [16, 32, 64]
    assert all(pb.graph.captured for pb in eng._prefill_buckets.values())


def test_chunked_prefill_replays_the_bucket_graph(cuda):
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import GenerationEngine

    model = _tiny_gpt(cuda, 2, 0)
    prompt = list(range(5, 58))  # 53 tokens: chunks of 16, 16, 16, 5
    want = _greedy(GenerationEngine(model, max_batch_size=2, rng_seed=3,
                                    block_size=16, device=cuda), prompt)
    eng = GenerationEngine(model, max_batch_size=2, rng_seed=3,
                           block_size=16, device=cuda)
    c0 = registry.counters("serving")["prefill_compiles"]
    assert eng.begin_prefill(0, prompt, seed=0, chunk_tokens=16) == 4
    toks = [eng.prefill_chunk(0) for _ in range(4)]
    assert toks[:3] == [None] * 3
    assert registry.counters("serving")["prefill_compiles"] == c0 + 1
    assert list(eng._prefill_buckets) == [16]
    assert eng._prefill_buckets[16].graph.replays == 4
    got = [toks[-1]]
    while len(got) < 16:
        got.append(int(eng.decode_step()[0]))
    assert got == want


def test_prefill_after_a_swap_uses_the_new_weights(cuda):
    from paddle_tpu_torch.serving import GenerationEngine

    kw = dict(max_batch_size=2, rng_seed=3, block_size=16, device=cuda)
    eng = GenerationEngine(_tiny_gpt(cuda, 2, 0), **kw)
    _greedy(eng)  # captures the bucket's prefill graph and the decode graph
    b = _tiny_gpt(cuda, 2, 1)
    eng.swap_weights({k: v.detach() for k, v in b.gpt.state_dict().items()})
    assert eng._prefill_buckets[64].graph.captured
    assert _greedy(eng) == _greedy(GenerationEngine(b, **kw))


MOE = dict(moe_num_experts=4, moe_top_k=2, moe_capacity_factor=1.25)


def _zero_gates(model):
    from paddle_tpu_torch.nn.moe import MoEMLP

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MoEMLP):
                m.gate.weight.zero_()
    return model


@pytest.mark.parametrize("gate", ["random", "zero"])
def test_moe_decode_graph_equals_its_body_called_eagerly(cuda, gate):
    import numpy as np

    from paddle_tpu_torch.nn.moe import metrics
    from paddle_tpu_torch.serving import GenerationEngine

    model = _tiny_gpt(cuda, 2, 0, **MOE)
    if gate == "zero":
        _zero_gates(model)
    outs = []
    for replay in (True, False):
        eng = GenerationEngine(model, max_batch_size=2, rng_seed=3,
                               block_size=16, device=cuda)
        toks = [eng.prefill(0, list(range(3, 40)), seed=0),
                eng.prefill(1, list(range(7, 20)), seed=1, temperature=0.8)]
        if not replay:
            for buf, host in eng._mirrors():
                buf.copy_(torch.from_numpy(np.ascontiguousarray(host)))
        for i in range(12):
            if replay:
                toks.extend(eng.decode_step().tolist())
                if i == 0:  # captured: the stats are a warm-up's
                    seen = metrics.collect(model)
                    stats = [m.last_stats for m in model.modules()
                             if hasattr(m, "last_stats")]
            else:
                eng._decode_body()
                t = eng._d_toks.cpu().numpy()
                eng._finish_decode(eng._active, 2, t)
                toks.extend(t.tolist())
        if replay:
            # replays (and the graph pool's reuse) leave what collect
            # reads alone: it is the last eager forward's
            assert [m.last_stats for m in model.modules()
                    if hasattr(m, "last_stats")] == stats
            again = metrics.collect(model)
            np.testing.assert_array_equal(again["expert_tokens"],
                                          seen["expert_tokens"])
        outs.append(toks)
    assert outs[0] == outs[1]


@pytest.mark.parametrize("gate", ["random", "zero"])
def test_moe_spec_graphs_equal_plain_decode(cuda, gate):
    from paddle_tpu_torch.serving import DraftVerifyEngine, GenerationEngine

    model = _tiny_gpt(cuda, 2, 0, **MOE)
    twin = _tiny_gpt(cuda, 2, 0, **MOE)
    if gate == "zero":
        _zero_gates(model)
        _zero_gates(twin)
    spec = DraftVerifyEngine(model, twin, draft_k=4, max_batch_size=2,
                             rng_seed=3, block_size=16, device=cuda)
    plain = GenerationEngine(model, max_batch_size=2, rng_seed=3,
                             block_size=16, device=cuda)
    for opts in (dict(seed=0), dict(seed=2, temperature=0.8)):
        got = [spec.prefill(0, list(range(3, 40)), **opts)]
        while len(got) < 30:
            got.extend(spec.decode_step_spec()[0])
        want = [plain.prefill(0, list(range(3, 40)), **opts)]
        while len(want) < 30:
            want.append(int(plain.decode_step()[0]))
        assert got[:30] == want[:30]
        spec.release(0)
        plain.release(0)


def test_drafter_prefill_graph_per_bucket_equal_to_its_body(cuda):
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import DraftVerifyEngine

    eng = DraftVerifyEngine(_tiny_gpt(cuda, 2, 0), _tiny_gpt(cuda, 1, 5),
                            draft_k=4, max_batch_size=2, rng_seed=3,
                            block_size=16, device=cuda)
    c0 = registry.counters("serving")["draft_prefill_compiles"]
    for n in (9, 15, 20, 50):
        eng.prefill(0, list(range(3, 3 + n)), seed=n)
        pb = eng._draft_buckets[eng.bucket_for(n)]
        idx = torch.tensor(eng._draft_blocks[0], device=cuda)
        rows = [(k[idx].clone(), v[idx].clone()) for k, v in eng._dkv]
        with torch.no_grad():
            pb.body()  # the same body on the same buffers, from Python
        for (k, v), (k0, v0) in zip(eng._dkv, rows):
            assert torch.equal(k[idx], k0) and torch.equal(v[idx], v0)
        eng.release(0)
    assert registry.counters("serving")["draft_prefill_compiles"] == c0 + 3
    assert sorted(eng._draft_buckets) == [16, 32, 64]
    assert eng._draft_buckets[16].graph.replays == 2
    eng.draft_pool.audit()


def test_kernel_mismatch_baked_into_a_captured_graph(cuda):
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import GenerationEngine
    from paddle_tpu_torch.testing import faults

    model = _tiny_gpt(cuda, 2, 0)
    route = gpt.paged_attention_route
    for armed in (True, False):
        calls = []

        def record(kernel, *args, **kw):
            out = route(kernel, *args, **kw)
            if torch.cuda.is_current_stream_capturing():
                calls.append((args, out))
            return out

        gpt.paged_attention_route = record
        try:
            if armed:
                faults.configure("kernel_mismatch")
            eng = GenerationEngine(model, max_batch_size=2, rng_seed=3,
                                   block_size=16, device=cuda)
            eng.prefill(0, list(range(3, 40)), seed=0)
            eng.decode_step()  # captures, then replays the perturbed graph
            eng.decode_step()
            torch.cuda.synchronize()
        finally:
            faults.reset()
            gpt.paged_attention_route = route
        args, out = calls[0]  # layer 0, rewritten by the last replay
        want = pa.paged_attention_ref(*args)
        atol, rtol = pa.PAGED_PARITY_TOL[torch.float32]
        close = torch.allclose(out, want, atol=atol, rtol=rtol)
        assert close != armed
        if armed:
            assert float((out - want)[0, 0, 0, 0]) == pytest.approx(
                1.0, abs=1e-4)


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


def test_flash_kernels_at_the_bert_pretraining_shape(cuda):
    # bert-base pretraining in float32 at the reference benchmark's 16 x
    # 128: 12 heads of 64, non-causal, on the unbind views of the fused
    # QKV projection (K1, K2 and K3 on the split-TF32 design)
    q, k, v, do = _flash_case(cuda, torch.float32, 16, 128, 12, 64,
                              seed=13, strided=True)
    _check_flash_kernels(q, k, v, do, False)


@pytest.mark.parametrize("H", [64, 128])
def test_float32_k2_launches_the_split_tf32_instance(cuda, H):
    # float32 K2 at head_dim 64 and 128 runs design (c), named
    # flash_bwd_dq_kernel_tf32<H> on the card, and no other K2 instance
    q, k, v, do = _flash_case(cuda, torch.float32, 2, 256, 2, H, seed=4,
                              strided=True)
    out, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.flash_delta(out, do)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fa.flash_bwd_dq(q, k, v, do, lse, delta, True)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    dq = [n for n in names if "flash_bwd_dq_kernel" in n]
    assert len(dq) == 1, names
    assert "flash_bwd_dq_kernel_tf32" in dq[0] and f"<{H}>" in dq[0], dq


@pytest.mark.parametrize("dtype,causal,B,T,N,H", [
    (torch.bfloat16, True, 4, 2048, 32, 64),
    (torch.bfloat16, True, 2, 2048, 8, 128),
    (torch.float32, False, 16, 128, 12, 64),
    (torch.float32, False, 4, 256, 4, 128),
    (torch.float32, True, 1, 2048, 2, 64),
    (torch.float32, True, 1, 2048, 2, 128)])
def test_flash_kernels_repeat_bitwise(cuda, dtype, causal, B, T, N, H):
    # two launches on the same inputs give the same bits: the kernels sum
    # in a fixed order without atomics, so a difference means a tile ring
    # stage was read after its next load overwrote it
    q, k, v, do = _flash_case(cuda, dtype, B, T, N, H, seed=11,
                              strided=True)
    fwd = [fa.flash_fwd(q, k, v, causal) for _ in range(2)]
    delta = fa.flash_delta(fwd[0][0], do)
    dq = [fa.flash_bwd_dq(q, k, v, do, fwd[0][1], delta, causal)
          for _ in range(2)]
    dkv = [fa.flash_bwd_dkv(q, k, v, do, fwd[0][1], delta, causal)
           for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(fwd[0] + (dq[0],) + dkv[0], fwd[1] + (dq[1],) + dkv[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("lens", [[1024] * 8, [2048] * 2],
                         ids=["8x1024", "2x2048"])
def test_paged_kernel_repeats_bitwise(cuda, lens):
    # the split pass and the combine read the splits in a fixed order with
    # no atomic touching a result: two launches on the same inputs give
    # the same bits
    g = torch.Generator().manual_seed(5)
    B, H, Dh, bs, M = len(lens), 32, 64, 16, 128
    q = torch.randn(B, 1, H, Dh, generator=g).to(cuda, torch.bfloat16)
    kp, vp = (torch.randn(B * M + 1, bs, H, Dh, generator=g).to(
        cuda, torch.bfloat16) for _ in range(2))
    bt = (torch.randperm(B * M, generator=g) + 1).view(B, M)
    sl = torch.tensor(lens)
    args = (q, kp, vp, bt.to(cuda, torch.int32), sl.to(cuda, torch.int32),
            (sl - 1).to(cuda, torch.int32))
    a, b = pa.paged_attention(*args), pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    exact = pa.paged_attention_ref(*(t.float() for t in args[:3]), *args[3:])
    assert pa.paged_rel_err(a, exact) <= pa.PAGED_PARITY_REL[torch.bfloat16]


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


# ------------------------------------------------- TrainStep's CUDA graph --
def _train_run(cuda, graph, steps=4, dtype="bfloat16", policy=None,
               recompute=False, attn_dropout=0.0, sched=True, dropout=0.0):
    """A small GPT (head_dim 64, seq_len 128: the kernels' shapes) under
    AdamW with master weights, a warm-up-into-cosine schedule stepped
    between calls and a global-norm clip: ``steps`` calls of TrainStep
    (``graph``) or of the same step_fn eagerly. Returns (losses, model,
    optimizer, step)."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import gpt as tgpt

    cfg = tgpt.GPTConfig.preset("gpt2-tiny", vocab_size=256, n_head=2,
                                dtype=dtype, attn_dropout=attn_dropout,
                                dropout=dropout, use_recompute=recompute,
                                recompute_policy=policy)
    model = tgpt.GPTForPretraining(tgpt.GPTModel(
        cfg, device=cuda, generator=torch.Generator(cuda).manual_seed(0)))
    lr = topt.lr.LinearWarmup(topt.lr.CosineAnnealingDecay(
        1e-3, T_max=6), warmup_steps=2, start_lr=1e-4, end_lr=1e-3) \
        if sched else 1e-3
    opt = topt.AdamW(learning_rate=lr, multi_precision=True,
                     parameters=model.parameters(),
                     grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    crit = tgpt.GPTPretrainingCriterion()

    def step_fn(tokens, labels):
        loss = crit(model(tokens), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 256, (2, 128), generator=g).to(cuda)
    labels = toks.roll(-1, 1)
    step = TrainStep(step_fn, model, opt) if graph else step_fn
    losses = []
    for _ in range(steps):
        losses.append(step(toks, labels).detach().float())
        if sched:
            lr.step()
    torch.cuda.synchronize()
    return losses, model, opt, step


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_graph_equals_the_eager_loop_bitwise(cuda, dtype):
    from paddle_tpu_torch.profiler import registry

    registry.reset("jit")
    fa.reset_device_launches()
    lg, mg, og, _ = _train_run(cuda, True, dtype=dtype)
    counts = fa.device_launches()
    assert registry.counters("jit")["train_step_captures"] == 1
    assert registry.counters("jit")["train_step_replays"] == 3
    # every call launched K1-K3 once per layer, replays included
    assert counts["flash_fwd"] == counts["flash_bwd_dq"] == \
        counts["flash_bwd_dkv"] == 4 * 2
    le, me, oe, _ = _train_run(cuda, False, dtype=dtype)
    assert all(torch.equal(a, b) for a, b in zip(lg, le))
    assert all(torch.equal(a, b) for a, b in zip(mg.parameters(),
                                                 me.parameters()))
    sg, se = og.state_dict(), oe.state_dict()
    for k, v in sg.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, se[k]), k


@pytest.mark.parametrize("policy,k1", [(None, 2), ("dots", 2), ("attn", 1),
                                       ("dots_attn", 1)])
def test_recompute_policies_in_the_graph_launch_k1_as_kept(cuda, policy, k1):
    fa.reset_device_launches()
    lr, _, _, _ = _train_run(cuda, True, steps=3, policy=policy,
                             recompute=True)
    counts = fa.device_launches()
    assert counts["flash_fwd"] == 3 * 2 * k1
    assert counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == 3 * 2
    lp, _, _, _ = _train_run(cuda, True, steps=3)
    assert all(torch.equal(a, b) for a, b in zip(lr, lp))


def test_train_step_recaptures_on_rebinding_and_mutate_signature(cuda):
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.testing import faults

    registry.reset("jit")
    plain, _, _, _ = _train_run(cuda, True, steps=5, sched=False)
    try:
        faults.configure("mutate_signature:nth=2,mode=aval")
        armed, _, _, _ = _train_run(cuda, True, steps=5, sched=False)
    finally:
        faults.reset()
    assert registry.counters("jit")["train_step_captures"] == 1 + 2
    assert all(torch.equal(a, b) for a, b in zip(plain, armed))
    # a rebinding restore: the next call captures again, and the run goes
    # on as it did from the snapshot
    losses, model, opt, step = _train_run(cuda, True, steps=3, sched=False)
    snap = [p.detach().clone() for p in model.parameters()]
    slots = {k: v.clone() if isinstance(v, torch.Tensor) else v
             for k, v in opt.state_dict().items()}
    toks = torch.randint(0, 256, (2, 128),
                         generator=torch.Generator().manual_seed(1)).to(cuda)
    want = [step(toks, toks.roll(-1, 1)) for _ in range(2)]
    before = registry.counters("jit")["train_step_captures"]
    with torch.no_grad():
        for p, v in zip(model.parameters(), snap):
            p.data = v.clone()
    opt.set_state_dict(slots)
    got = [step(toks, toks.roll(-1, 1)) for _ in range(2)]
    assert registry.counters("jit")["train_step_captures"] == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_dropout_masks_change_between_replays(cuda):
    # the masks are hashed from a key each replay draws anew from the
    # model's generator, registered with the graph
    from paddle_tpu_torch.models import gpt as tgpt

    kept = []
    orig = tgpt.hashed_dropout

    def rec(y, p, key, site, *shard):
        res = orig(y, p, key, site, *shard)
        if p > 0 and torch.cuda.is_current_stream_capturing():
            kept.append(res)
        return res

    tgpt.hashed_dropout = rec
    try:
        losses, model, opt, step = _train_run(cuda, True, steps=2,
                                              attn_dropout=0.25,
                                              dtype="float32")
    finally:
        tgpt.hashed_dropout = orig
    out = kept[0]
    toks = torch.randint(0, 256, (2, 128),
                         generator=torch.Generator().manual_seed(1)).to(cuda)
    masks = []
    for _ in range(2):
        step(toks, toks.roll(-1, 1))
        torch.cuda.synchronize()
        masks.append(out != 0)
        assert abs(masks[-1].float().mean().item() - 0.75) < 0.02
    assert (masks[0] != masks[1]).float().mean().item() > 0.25


def test_train_step_refuses_a_step_that_reads_the_host(cuda):
    # the read is caught in the first call, before any capture: the stream
    # stays usable, and a good step captures and replays after it
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.profiler import registry

    lin = torch.nn.Linear(4, 4).to(cuda)
    opt = topt.SGD(0.1, parameters=lin.parameters())

    def reads_host(x):
        loss = lin(x).sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
        if float(loss) > 1e9:  # a Python branch on a tensor
            print("large")
        return loss

    registry.reset("jit")
    step = TrainStep(reads_host, lin, opt)
    x = torch.ones(2, 4, device=cuda)
    for _ in range(2):  # refused every time, never captured
        with pytest.raises(RuntimeError, match="could not be captured"):
            step(x)
    assert registry.counters("jit")["train_step_captures"] == 0
    assert torch.cuda.get_sync_debug_mode() == 0
    losses, _, _, _ = _train_run(cuda, True, steps=3, sched=False)
    assert registry.counters("jit")["train_step_captures"] == 1
    assert all(torch.isfinite(v) for v in losses)


def test_train_step_refuses_a_sparse_embedding_on_the_card(cuda):
    """Under the graph a sparse embedding takes the dense gradient path,
    with a recorded fallback (it was refused before the dense path came):
    losses and parameters equal the same model's with a dense embedding;
    the eager loop keeps its row-wise update."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.profiler import explainer

    ids = torch.tensor([[1, 3, 3, 0], [5, 1, 2, 3]], device=cuda)
    runs = []
    for sparse in (True, False):
        emb = torch.nn.Embedding(16, 8, sparse=sparse).to(cuda)
        with torch.no_grad():
            emb.weight.copy_(torch.arange(128.0, device=cuda).view(16, 8)
                             / 128)
        opt = topt.Adam(0.1, parameters=emb.parameters(), lazy_mode=True)

        def step_fn(i, emb=emb, opt=opt):
            loss = emb(i).square().sum()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        n0 = len(explainer.events(kind="kernel_fallback"))
        train = TrainStep(step_fn, emb, opt)
        events = explainer.events(kind="kernel_fallback")[n0:]
        assert len(events) == int(sparse)
        losses = [train(ids) for _ in range(4)]
        torch.cuda.synchronize()
        runs.append((losses, emb.weight.detach().clone()))
        if sparse:
            before = emb.weight.detach().clone()
            step_fn(torch.tensor([1, 3, 3], device=cuda))
            moved = (emb.weight.detach() != before).any(1)
            assert moved.nonzero().flatten().tolist() == [1, 3]
            runs[-1] = (losses, before)
    (ls, ws), (ld, wd) = runs
    assert all(torch.equal(a, b) for a, b in zip(ls, ld))
    assert torch.equal(ws, wd)


def test_recomputed_dropout_blocks_in_the_graph_equal_the_eager_loop(cuda):
    """gpt2-tiny with dropout 0.1 everywhere and use_recompute: the
    recomputed blocks draw their masks from the counter-based hash, so
    TrainStep's graph (one capture) equals the eager recompute loop
    bitwise, and the masks are live (dropout 0 trains otherwise)."""
    from paddle_tpu_torch.profiler import registry

    runs = []
    for graph, p in ((True, 0.1), (False, 0.1), (True, 0.0)):
        registry.reset("jit")
        losses, model, _, _ = _train_run(cuda, graph, steps=4, dtype="float32",
                                         recompute=True, dropout=p,
                                         attn_dropout=p, sched=False)
        if graph:
            assert registry.counters("jit")["train_step_captures"] == 1
        runs.append((losses, [t.detach().clone()
                              for t in model.parameters()]))
    (lg, pg), (le, pe), (l0, _) = runs
    assert all(torch.equal(a, b) for a, b in zip(lg, le))
    assert all(torch.equal(a, b) for a, b in zip(pg, pe))
    assert not torch.equal(lg[-1], l0[-1])


def _rank_gloo_on_the_card():
    import torch
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import collective, get_rank
    from paddle_tpu_torch.jit import TrainStep

    dev = torch.device("cuda", 0)
    t = torch.full((4,), float(get_rank() + 1), device=dev)
    collective.all_reduce(t)
    lin = torch.nn.Linear(4, 4).to(dev)
    opt = topt.SGD(0.1, parameters=lin.parameters())

    def step_fn(x):
        loss = lin(x).sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    try:
        TrainStep(step_fn, lin, opt)
        refused = None
    except ValueError as e:
        refused = str(e)
    staged = collective._counters.get("host_staged.all_reduce", 0)
    return t.cpu().numpy().tolist(), str(t.device), refused, staged


def test_two_gloo_ranks_on_the_card_all_reduce_and_refuse_the_graph(
        cuda, tmp_path):
    """Two ranks on cuda:0 over gloo: an all_reduce of CUDA tensors (or
    its host staging, counted), and TrainStep refusing to capture a step
    over a gloo process group, naming the backend."""
    from paddle_tpu_torch.testing.world import World

    world = World(2, tmp_path, timeout=120, device="cuda:0", backend="gloo")
    try:
        got = world.run(_rank_gloo_on_the_card)
    finally:
        world.close()
    for values, device, refused, staged in got:
        assert values == [3.0] * 4 and device == "cuda:0"
        assert refused is not None and "gloo" in refused
        assert staged in (0, 1)


# -------------------------------------------- serving on a mesh (mp = 2) --
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 5])
def test_paged_kernel_per_shard_equals_the_whole_kernels_heads(cuda, dtype,
                                                               T):
    """K4 on rank r's contiguous heads of a head-sharded pool: bitwise the
    whole kernel's output on those heads (each head is computed on its
    own; the split chunk does not depend on the head count)."""
    g = torch.Generator().manual_seed(T)
    B, H, Dh, bs, M = 4, 8, 64, 16, 40
    Nb = 1 + B * M
    q = torch.randn(B, T, H, Dh, generator=g).to(cuda, dtype)
    kp = torch.randn(Nb, bs, H, Dh, generator=g).to(cuda, dtype)
    vp = torch.randn(Nb, bs, H, Dh, generator=g).to(cuda, dtype)
    bt = (torch.randperm(Nb - 1, generator=g) + 1).view(B, M).to(
        cuda, torch.int32)
    sl = torch.tensor([600, 9, 257, 33], dtype=torch.int32, device=cuda)
    qo = (sl - T).clamp(min=0)
    whole = pa.paged_attention(q, kp, vp, bt, sl, qo)
    for r in range(2):
        heads = slice(r * H // 2, (r + 1) * H // 2)
        part = pa.paged_attention(
            *(x[:, :, heads].contiguous() for x in (q, kp, vp)), bt, sl, qo)
        torch.cuda.synchronize()
        assert torch.equal(part, whole[:, :, heads])


def _rank_mesh_decode(prompts):
    import torch
    from paddle_tpu_torch.distributed import spmd
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import GenerationEngine

    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel)

    dev = torch.device("cuda", 0)
    cfg = GPTConfig(vocab_size=512, n_layer=2, n_head=4, d_model=256,
                    seq_len=256, initializer_range=0.2)
    model = GPTForPretraining(GPTModel(
        cfg, device=dev, generator=torch.Generator(dev).manual_seed(0)))
    mesh = spmd.serving_mesh(2)
    c0 = dict(registry.counters("serving"))
    eng = GenerationEngine(model, max_batch_size=2, rng_seed=3,
                           block_size=16, device=dev, mesh=mesh)
    if mesh.rank:
        eng.follow()
        out = None
    else:
        try:
            out = []
            for i, p in enumerate(prompts):
                toks = [eng.prefill(0, p, seed=i, temperature=0.8 * i)]
                while len(toks) < 12:
                    toks.append(int(eng.decode_step()[0]))
                eng.release(0)
                out.append(toks)
        finally:
            eng.close()
    c1 = registry.counters("serving")
    st = eng.stats()
    return out, st["decode_graph"], st["decode_graph_reason"], {
        k: c1[k] - c0.get(k, 0) for k in ("decode_compiles",
                                          "prefill_compiles",
                                          "uncaptured_steps")}


def test_mp2_decode_over_gloo_on_the_card_equals_one_engine(cuda, tmp_path):
    """Two ranks on cuda:0 over gloo serve a 2-layer float32 model at mp =
    2, greedy and sampled: rank 0's tokens equal one engine's on the
    card, bitwise. The gloo route is decided at build and reported: no
    graph is captured, every step body runs uncaptured and is counted."""
    import numpy as np

    from paddle_tpu_torch.serving import GenerationEngine
    from paddle_tpu_torch.testing.world import World

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n).tolist() for n in (20, 37)]
    single = GenerationEngine(_tiny_gpt(cuda, 2, 0), max_batch_size=2,
                              rng_seed=3, block_size=16, device=cuda)
    want = []
    for i, p in enumerate(prompts):
        toks = [single.prefill(0, p, seed=i, temperature=0.8 * i)]
        while len(toks) < 12:
            toks.append(int(single.decode_step()[0]))
        single.release(0)
        want.append(toks)
    world = World(2, tmp_path, timeout=120, device="cuda:0", backend="gloo")
    try:
        got = world.run(_rank_mesh_decode, prompts)
    finally:
        world.close()
    assert got[0][0] == want
    for _, graph, why, moved in got:
        assert graph is False and "gloo" in why
        assert moved["decode_compiles"] == moved["prefill_compiles"] == 0
        assert moved["uncaptured_steps"] == 2 * 11 + 2  # decodes, prefills


# ------------------------------------------- Model.fit, AMP, GradScaler --
def test_fit_under_o1_runs_the_bf16_kernels_through_one_graph(cuda):
    """hapi.Model.fit on a float32 model under O1, fed by a DataLoader with
    two shm-ring workers: one capture, every K1-K3 launch on the bf16
    instance (eager warm-up and replays alike), finite losses."""
    import numpy as np

    from paddle_tpu_torch import hapi, io
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import gpt as tgpt
    from paddle_tpu_torch.profiler import registry

    cfg = tgpt.GPTConfig.preset("gpt2-tiny", vocab_size=256, n_head=2)
    net = tgpt.GPTForPretraining(tgpt.GPTModel(
        cfg, device=cuda, generator=torch.Generator(cuda).manual_seed(0)))
    model = hapi.Model(net)
    model.prepare(topt.AdamW(learning_rate=1e-3,
                             parameters=net.parameters()),
                  tgpt.GPTPretrainingCriterion(), amp_configs="O1")
    toks = np.random.default_rng(0).integers(0, 256, (8, 129))
    loader = io.DataLoader(io.TensorDataset([toks[:, :-1], toks[:, 1:]]),
                           batch_size=2, shuffle=True, num_workers=2)
    registry.reset("jit")
    torch.cuda.synchronize()
    fa.reset_device_launches()
    hist = model.fit(loader, epochs=2, verbose=0)
    counts = fa.device_launches()
    assert registry.counters("jit")["train_step_captures"] == 1
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert counts["by_dtype"]["bfloat16"][name] == 8 * cfg.n_layer
        assert counts["by_dtype"]["float32"][name] == 0
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert all(p.dtype == torch.float32 for p in net.parameters())


def test_grad_scaler_is_refused_under_train_step(cuda):
    """The scaler reads its all-finite flag on the host (as the
    reference's does), so TrainStep refuses a step that calls it, in the
    first (eager) call, before anything is captured."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.profiler import registry

    lin = torch.nn.Linear(8, 8).to(cuda)
    opt = topt.SGD(0.1, parameters=lin.parameters())
    scaler = amp.GradScaler(init_loss_scaling=1024.0)

    def step_fn(x):
        with amp.auto_cast(dtype="float16"):
            loss = lin(x).float().square().mean()
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        return loss

    registry.reset("jit")
    step = TrainStep(step_fn, lin, opt)
    with pytest.raises(RuntimeError, match="could not be captured"):
        step(torch.ones(4, 8, device=cuda))
    assert registry.counters("jit")["train_step_captures"] == 0
    # eagerly the same step runs, and an inf gradient skips the update
    step_fn(torch.ones(4, 8, device=cuda))
    before = [p.detach().clone() for p in lin.parameters()]
    scale = scaler._scale
    loss = lin(torch.ones(4, 8, device=cuda)).sum() * float("inf")
    scaler.scale(loss).backward()
    scaler.step(opt)
    scaler.update()
    assert all(torch.equal(a, p) for a, p in zip(before, lin.parameters()))
    assert scaler._scale == scale / 2


def test_float16_attention_takes_the_plain_route_and_says_why(cuda):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.profiler import explainer

    q = torch.randn(1, 128, 2, 64, device=cuda)
    torch.cuda.synchronize()
    fa.reset_device_launches()
    n0 = len(explainer.events(kind="kernel_fallback"))
    with amp.auto_cast(dtype="float16"):
        out = fa.flash_attention(q, q, q, causal=True, kernel="cuda")
    assert out.dtype == torch.float16
    why = explainer.events(kind="kernel_fallback")[n0:]
    assert len(why) == 1 and "float16" in why[0]["why"]
    assert fa.device_launches()["flash_fwd"] == 0
    with amp.auto_cast():  # bf16: the kernel
        assert fa.flash_attention(q, q, q, causal=True,
                                  kernel="cuda").dtype == torch.bfloat16
    assert fa.device_launches()["by_dtype"]["bfloat16"]["flash_fwd"] == 1


# ------------------------------------------------------ the encoder path --
def _bert_tiny(cuda, kernel=None, dropout=0.0, seed=0):
    """bert_tiny (head_dim 64) with vocab 256 and its pretraining heads."""
    from paddle_tpu_torch.models import bert as tbert

    return tbert.BertForPretraining(tbert.bert_tiny(
        device=cuda, attn_kernel=kernel, vocab_size=256,
        hidden_dropout_prob=dropout, attention_probs_dropout_prob=dropout,
        generator=torch.Generator(cuda).manual_seed(seed)))


def _bert_batch(cuda, B=2, T=128):
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 256, (B, T), generator=g).to(cuda)
    return ids, torch.zeros(B, 1, dtype=torch.int64, device=cuda)


def test_bert_kernel_route_matches_its_plain_route(cuda):
    # float32: the non-causal K1-K3 against plain attention, through two
    # layers into the logits, the loss and every gradient
    from paddle_tpu_torch.models import bert as tbert

    tol = dict(zip(("atol", "rtol"), fa.FLASH_PARITY_TOL[torch.float32]))
    models = [_bert_tiny(cuda, k) for k in ("cuda", "torch")]
    ids, nsp = _bert_batch(cuda)
    crit = tbert.BertPretrainingCriterion(256)
    fa.reset_device_launches()
    outs = []
    for m in models:
        scores, rel = m(ids)
        loss = crit(scores, rel, ids, nsp)
        loss.backward()
        outs.append((scores.detach(), loss.detach()))
    counts = fa.device_launches()["by_dtype"]["float32"]
    assert counts == {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    torch.testing.assert_close(outs[0][0], outs[1][0], **tol)
    torch.testing.assert_close(outs[0][1], outs[1][1], **tol)
    plain = dict(models[1].named_parameters())
    for name, p in models[0].named_parameters():
        torch.testing.assert_close(p.grad, plain[name].grad, **tol,
                                   msg=name)


def test_bert_padding_mask_takes_the_plain_route_and_says_why(cuda):
    from paddle_tpu_torch.profiler import explainer

    model = _bert_tiny(cuda)
    ids, _ = _bert_batch(cuda)
    mask = torch.ones_like(ids)
    mask[1, 100:] = 0
    torch.cuda.synchronize()
    fa.reset_device_launches()
    seq0 = explainer.events()[-1]["seq"] if explainer.events() else 0
    model(ids, attention_mask=mask)[0].sum().backward()
    why = [e for e in explainer.events(kind="kernel_fallback")
           if e["seq"] > seq0]
    assert len(why) == 2 and all("attn_mask" in e["why"] for e in why)
    counts = fa.device_launches()
    assert counts["flash_fwd"] == counts["flash_bwd_dq"] == \
        counts["flash_bwd_dkv"] == 0


def test_bert_train_step_with_dropout_equals_the_eager_loop(cuda):
    # the dropout key is drawn on the card from the model's generator,
    # registered with the graph: replays draw the eager loop's keys
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import bert as tbert
    from paddle_tpu_torch.profiler import registry

    ids, nsp = _bert_batch(cuda)
    crit = tbert.BertPretrainingCriterion(256)
    runs = []
    for graph in (True, False):
        model = _bert_tiny(cuda, dropout=0.1)
        opt = topt.AdamW(learning_rate=1e-3, parameters=model.parameters())

        def step_fn(ids, nsp, model=model, opt=opt):
            scores, rel = model(ids)
            loss = crit(scores, rel, ids, nsp)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        registry.reset("jit")
        step = TrainStep(step_fn, model, opt) if graph else step_fn
        losses = [step(ids, nsp).detach() for _ in range(4)]
        torch.cuda.synchronize()
        if graph:
            assert registry.counters("jit")["train_step_captures"] == 1
        runs.append((losses, model))
    (lg, mg), (le, me) = runs
    assert all(torch.equal(a, b) for a, b in zip(lg, le))
    assert len(set(float(x) for x in lg)) == 4
    assert all(torch.equal(a, b) for a, b in zip(mg.parameters(),
                                                 me.parameters()))


def _resnet18(dev, seed=0):
    from paddle_tpu_torch.vision.models import resnet18

    return resnet18(num_classes=10, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed))


def test_resnet18_train_step_graph_equals_the_eager_loop(cuda):
    """BASELINE config 1's step at its tiny scale (4 x 3 x 32 x 32,
    Momentum 0.1) through ``TrainStep``'s graph against the same step
    called eagerly, under cudnn.deterministic: losses, parameters and the
    batch norms' running statistics (updated in place at every replay)
    equal."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.profiler import registry

    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 3, 32, 32, generator=g).to(cuda)
    y = torch.randint(0, 10, (4,), generator=g).to(cuda)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for graph in (True, False):
            model = _resnet18(cuda)
            opt = Momentum(0.1, parameters=model.parameters())

            def step_fn(xb, yb, model=model, opt=opt):
                loss = F.cross_entropy(model(xb), yb)
                loss.backward()
                opt.step()
                opt.clear_grad()
                return loss

            registry.reset("jit")
            step = TrainStep(step_fn, model, opt) if graph else step_fn
            losses = [step(x, y).detach() for _ in range(4)]
            torch.cuda.synchronize()
            if graph:
                jit = registry.counters("jit")
                assert jit["train_step_captures"] == 1
                assert jit["train_step_replays"] == 3
            runs.append((losses, model))
    finally:
        torch.backends.cudnn.deterministic = det
    (lg, mg), (le, me) = runs
    for a, b in zip(lg, le):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert len(set(float(v) for v in lg)) == 4
    for (name, a), b in zip(mg.state_dict().items(),
                            me.state_dict().values()):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5, msg=name)
    assert float(mg.bn1._mean.abs().sum()) > 0


def test_conv_and_batch_norm_under_o1(cuda):
    """Under O1 a convolution runs in bf16 (white list) and a batch norm in
    float32 (black list) on the card too; the O1 step through the graph
    gives finite losses and float32 gradients."""
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum

    model = _resnet18(cuda)
    x = torch.randn(4, 3, 32, 32, device=cuda)
    y = torch.randint(0, 10, (4,), device=cuda)
    # no autograd graph out here: one kept alive into the capture would
    # hold AccumulateGrad nodes of the default stream
    with torch.no_grad(), auto_cast(level="O1"):
        h = model.conv1(x)
        b = model.bn1(h)
    assert h.dtype == torch.bfloat16 and b.dtype == torch.float32
    torch.testing.assert_close(
        b, F.batch_norm(h.float(), torch.zeros(64, device=cuda),
                        torch.ones(64, device=cuda), model.bn1.weight,
                        model.bn1.bias, True), atol=1e-5, rtol=1e-5)
    opt = Momentum(0.1, parameters=model.parameters())

    def step_fn(xb, yb):
        with auto_cast(level="O1"):
            loss = F.cross_entropy(model(xb), yb)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    step = TrainStep(step_fn, model, opt)
    losses = [float(step(x, y)) for _ in range(3)]
    assert all(math.isfinite(v) for v in losses)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def _static_ernie(dev, **over):
    """A 2-layer ERNIE classifier at bert-base width (the kernels' head
    size 64, T 128), float32, seed-0 weights."""
    from paddle_tpu_torch.models.ernie import (
        ErnieConfig, ErnieForSequenceClassification, ErnieModel)

    ernie = ErnieModel(ErnieConfig(num_hidden_layers=2, **over), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
    return ErnieForSequenceClassification(ernie, 3)


def _static_ids(model, batch, seed=0):
    import numpy as np

    return np.random.default_rng(seed).integers(
        0, model.ernie.cfg.vocab_size, (batch, 128)).astype(np.int64)


def test_static_executor_graph_equals_the_eager_forward(cuda):
    """Executor.run's captured graph (runs 2 and 3) against the module's
    eager forward: the same kernels, so equal; K1 once a layer a run."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.models.ernie import build_static_inference_program
    from paddle_tpu_torch.profiler import registry

    model = _static_ernie(cuda).eval()
    ids = _static_ids(model, 4)
    with torch.no_grad():
        want = model(torch.from_numpy(ids).to(cuda)).cpu().numpy()
    prog, _, fetch = build_static_inference_program(model, seq_len=128)
    registry.reset("jit")
    with static.scope_guard(static.Scope()):
        exe = static.Executor()
        outs = []
        for _ in range(3):
            fa.reset_device_launches()
            outs.append(exe.run(prog, feed={"input_ids": ids},
                                fetch_list=[fetch])[0])
            assert fa.device_launches()["flash_fwd"] == 2
    assert registry.counters("jit")["train_step_captures"] == 1
    for got in outs:
        torch.testing.assert_close(torch.from_numpy(got),
                                   torch.from_numpy(want), rtol=0, atol=0)


def test_static_predictor_serves_two_batches_from_one_artifact(
        cuda, tmp_path):
    from paddle_tpu_torch import inference, static
    from paddle_tpu_torch.models.ernie import build_static_inference_program

    model = _static_ernie(cuda).eval()
    prog, _, fetch = build_static_inference_program(model, seq_len=128)
    with static.scope_guard(static.Scope()):
        exe = static.Executor()
        want = {b: exe.run(prog, feed={"input_ids": _static_ids(model, b)},
                           fetch_list=[fetch])[0] for b in (2, 5)}
        static.save_inference_model(str(tmp_path / "m"),
                                    [prog.feed_vars["input_ids"]], [fetch],
                                    exe, program=prog)
    pred = inference.create_predictor(inference.Config(str(tmp_path / "m")))
    tol = fa.FLASH_PARITY_TOL[torch.float32]
    for _ in range(3):  # eager, capture, replay per signature
        for b in (2, 5):
            got = pred.run([_static_ids(model, b)])[0]
            torch.testing.assert_close(
                torch.from_numpy(got), torch.from_numpy(want[b]),
                atol=tol[0], rtol=tol[1])


def test_static_training_step_equals_train_step(cuda):
    """Three Executor runs of a recorded AdamW step against TrainStep's
    three calls from the same weights: equal losses; K1, K2 and K3 once a
    layer a run."""
    import numpy as np

    from paddle_tpu_torch import static
    from paddle_tpu_torch.framework import disable_static, enable_static
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW

    over = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    ids = _static_ids(_static_ernie(cuda, **over), 4)
    labels = np.arange(4, dtype=np.int64) % 3
    model, twin = _static_ernie(cuda, **over), _static_ernie(cuda, **over)
    prog = static.Program()
    enable_static()
    try:
        with static.program_guard(prog):
            x = static.data("ids", [None, 128], "int64")
            y = static.data("labels", [None], "int64")
            loss = F.cross_entropy(model(x), y)
            AdamW(learning_rate=1e-4).minimize(loss)
    finally:
        disable_static()
    got = []
    with static.scope_guard(static.Scope()):
        exe = static.Executor()
        for _ in range(3):
            fa.reset_device_launches()
            got.append(float(exe.run(prog, feed={"ids": ids, "labels":
                                                 labels},
                                     fetch_list=[loss])[0]))
            counts = fa.device_launches()
            assert [counts[k] for k in ("flash_fwd", "flash_bwd_dq",
                                        "flash_bwd_dkv")] == [2, 2, 2]
    opt = AdamW(learning_rate=1e-4, parameters=twin.parameters())

    def step_fn(a, b):
        out = F.cross_entropy(twin(a), b)
        out.backward()
        opt.step()
        opt.clear_grad()
        return out

    train = TrainStep(step_fn, twin, opt)
    want = [float(train(torch.from_numpy(ids).to(cuda),
                        torch.from_numpy(labels).to(cuda)).detach())
            for _ in range(3)]
    assert got == want


# ------------------------------------------- recurrent, detection, functional
def test_rnnt_wavefront_on_the_card_matches_the_cpu(cuda):
    from paddle_tpu_torch.nn import functional as F

    g = torch.Generator().manual_seed(3)
    B, T, U, V = 3, 40, 12, 30
    x = torch.randn(B, T, U + 1, V, generator=g)
    lab = torch.randint(1, V, (B, U), generator=g)
    il, ll = torch.tensor([40, 31, 17]), torch.tensor([12, 9, 0])
    outs = []
    for dev in ("cpu", cuda):
        xi = x.detach().to(dev).requires_grad_()
        loss = F.rnnt_loss(xi, lab.to(dev), il.to(dev), ll.to(dev),
                           reduction="sum")
        loss.backward()
        outs.append((loss.detach().cpu(), xi.grad.cpu()))
    (lc, gc), (lg, gg) = outs
    torch.testing.assert_close(lg, lc, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(gg, gc, atol=1e-5, rtol=1e-4)


def test_nms_on_the_card_equals_the_cpu(cuda):
    from paddle_tpu_torch.vision import ops

    g = torch.Generator().manual_seed(5)
    xy = torch.rand(3000, 2, generator=g) * 600
    boxes = torch.cat([xy, xy + 8 + torch.rand(3000, 2, generator=g) * 90],
                      1)
    scores = torch.rand(3000, generator=g).mul(50).round()  # ties
    cats = torch.randint(0, 5, (3000,), generator=g)
    for kw in (dict(), dict(category_idxs=cats, top_k=100)):
        cpu = ops.nms(boxes, 0.5, scores, **kw)
        card = ops.nms(boxes.to(cuda), 0.5, scores.to(cuda),
                       **{k: v.to(cuda) if torch.is_tensor(v) else v
                          for k, v in kw.items()})
        assert torch.equal(card.cpu(), cpu)


def test_roi_ops_on_the_card_match_the_cpu(cuda):
    from paddle_tpu_torch.vision import ops

    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 18, 24, 30, generator=g)
    xy = torch.rand(40, 2, generator=g) * 400 - 20
    rois = torch.cat([xy, xy + 16 + torch.rand(40, 2, generator=g) * 200],
                     1)
    num = torch.tensor([25, 15], dtype=torch.int32)
    cases = [(ops.roi_align, dict(output_size=7, spatial_scale=1 / 16,
                                  sampling_ratio=0)),
             (ops.roi_align, dict(output_size=(5, 4), spatial_scale=1 / 16,
                                  sampling_ratio=2, aligned=False)),
             (ops.roi_pool, dict(output_size=3, spatial_scale=1 / 16)),
             (ops.psroi_pool, dict(output_size=3, spatial_scale=1 / 16))]
    for fn, kw in cases:
        cpu = fn(x, rois, num, **kw)
        card = fn(x.to(cuda), rois.to(cuda), num.to(cuda), **kw)
        torch.testing.assert_close(card.cpu(), cpu, atol=1e-5, rtol=1e-5)


def test_functional_attention_routes_launch_their_kernels(cuda):
    from paddle_tpu_torch.nn import functional as F

    g = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn(2, 128, 4, 64, generator=g).to(cuda)
               for _ in range(3))
    fa.reset_device_launches()
    out = F.scaled_dot_product_attention(q, k, v)
    assert fa.device_launches()["flash_fwd"] == 1
    assert torch.equal(out, fa.flash_attention(q, k, v))
    args = _case(cuda, torch.float32, 1, 64, 16, [20, 9, 16, 30], 4)
    pa.reset_device_launches()
    got = F.paged_attention(*args, kernel="pallas")
    assert sum(pa.device_launches().values()) == 1
    assert torch.equal(got, pa.paged_attention(*args))
    pa.reset_device_launches()
    F.paged_attention(*args, kernel="xla")
    assert pa.device_launches() == {}
    # probability dropout is not in the kernels: refused, not run plain
    with pytest.raises(NotImplementedError, match="dropout_p"):
        F.scaled_dot_product_attention(q, k, v, dropout_p=0.1)
    torch.testing.assert_close(
        F.scaled_dot_product_attention(q, k, v, dropout_p=0.1,
                                       training=False), out)


def test_supervised_replica_kill_replays_on_the_card(cuda):
    """A ReplicaSupervisor on the card (gpt2-tiny, two replicas sharing
    one model): replica_kill mid-flight, the respawn's tokens equal the
    undisturbed run's, and K4 runs on the card."""
    from paddle_tpu_torch.models import gpt as tgpt
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import GenerationEngine, ReplicaSupervisor
    from paddle_tpu_torch.testing import faults

    cfg = tgpt.GPTConfig.preset("gpt2-tiny", vocab_size=96, n_head=2)
    model = tgpt.GPTForPretraining(tgpt.GPTModel(
        cfg, device=cuda,
        generator=torch.Generator(device=cuda).manual_seed(0)))
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(1, 96, (int(n),), generator=g).tolist()
               for n in torch.randint(5, 40, (8,), generator=g)]

    def run(fault=None):
        sup = ReplicaSupervisor(
            lambda: GenerationEngine(model, max_batch_size=4, rng_seed=7,
                                     device=cuda),
            replicas=2, restart_backoff=0.05, monitor_interval=0.02)
        pa.reset_device_launches()
        if fault:
            faults.configure(fault)
        try:
            reqs = [sup.submit(p, max_new_tokens=8,
                               temperature=0.8 if i % 4 == 3 else 0.0)
                    for i, p in enumerate(prompts)]
            return [list(r.result(120).tokens) for r in reqs], \
                sum(pa.device_launches().values())
        finally:
            faults.reset()
            sup.shutdown()

    want, _ = run()
    c0 = registry.counters("serving")["replica_restarts"]
    got, k4 = run("replica_kill:nth=6")
    assert got == want
    assert registry.counters("serving")["replica_restarts"] == c0 + 1
    assert k4 > 0


# ------------------------------------------- pipeline over gloo (pp = 2) --
def _rank_pp_losses(device):
    import torch
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.pp_spmd import PipelineSpmdStep
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.optimizer import AdamW

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"pp_degree": 2}
    s.pipeline_configs = {"accumulate_steps": 2}
    fleet.init(is_collective=True, strategy=s)
    cfg = gpt.GPTConfig.preset("gpt2-tiny", n_layer=2, vocab_size=64,
                               seq_len=16, dropout=0.0, n_head=2, d_model=32)
    model = gpt.GPTForPretraining(gpt.GPTModel(
        cfg, device="cpu", generator=torch.Generator().manual_seed(5),
        attn_kernel="torch")).to(device)
    opt = AdamW(1e-3, parameters=model.parameters())
    step = PipelineSpmdStep(model, opt,
                            criterion=gpt.GPTPretrainingCriterion())
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, 64, (8, 16), generator=g)
    labels = torch.roll(toks, -1, 1)
    return [float(step.train_batch([toks, labels])) for _ in range(4)]


def test_pp2_step_on_the_card_equals_the_cpu_world(cuda, tmp_path):
    """A PipelineSpmdStep of gpt2-tiny (float32, plain attention) on two
    gloo ranks on cuda:0 trains as the same step on two CPU ranks."""
    from paddle_tpu_torch.testing.world import World

    got = {}
    for device in ("cpu", "cuda:0"):
        root = tmp_path / device.replace(":", "")
        root.mkdir()
        world = World(2, root, timeout=120, device=device, backend="gloo")
        try:
            got[device] = world.run(_rank_pp_losses, device)
        finally:
            world.close()
    for r in range(2):
        for a, b in zip(got["cuda:0"][r], got["cpu"][r]):
            assert abs(a - b) <= 1e-5, (got["cuda:0"], got["cpu"])


def _rank_p2p_on_the_card():
    import torch
    from paddle_tpu_torch.distributed import collective, get_rank

    dev = torch.device("cuda", 0)
    me = get_rank()
    x = torch.arange(1000, dtype=torch.float32, device=dev) + 1000 * me
    g = collective.get_group(0)
    if me == 0:
        collective.send(x, dst=1, group=g)
        got_send = None
    else:
        got_send = torch.empty_like(x)
        collective.recv(got_send, src=0, group=g)
    perm = collective.ppermute(x, g, [(0, 1), (1, 0)])
    staged = collective._counters.get("host_staged.p2p", 0)
    return (None if got_send is None else got_send.cpu().tolist(),
            perm.cpu().tolist(), str(perm.device), staged)


def test_send_and_ppermute_of_cuda_tensors_over_gloo_move_the_right_bytes(
        cuda, tmp_path):
    """Point to point of CUDA tensors over a gloo group: send / recv and
    ppermute deliver the sender's values on the card, through host
    staging (gloo's send and receive take the data pointer as it is)."""
    from paddle_tpu_torch.testing.world import World

    world = World(2, tmp_path, timeout=120, device="cuda:0", backend="gloo")
    try:
        got = world.run(_rank_p2p_on_the_card)
    finally:
        world.close()
    base = [float(i) for i in range(1000)]
    assert got[1][0] == base
    assert got[0][1] == [v + 1000 for v in base] and got[1][1] == base
    assert all(r[2] == "cuda:0" and r[3] == 2 for r in got)
