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


@pytest.mark.parametrize("B,T,N,H", [(4, 2048, 32, 64), (2, 2048, 8, 128)])
def test_flash_kernels_repeat_bitwise(cuda, B, T, N, H):
    # two launches on the same inputs give the same bits: the kernels sum
    # in a fixed order without atomics, so a difference means a tile ring
    # stage was read after its next load overwrote it
    q, k, v, do = _flash_case(cuda, torch.bfloat16, B, T, N, H, seed=11,
                              strided=True)
    fwd = [fa.flash_fwd(q, k, v, True) for _ in range(2)]
    delta = fa.flash_delta(fwd[0][0], do)
    dq = [fa.flash_bwd_dq(q, k, v, do, fwd[0][1], delta, True)
          for _ in range(2)]
    dkv = [fa.flash_bwd_dkv(q, k, v, do, fwd[0][1], delta, True)
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
               recompute=False, attn_dropout=0.0, sched=True):
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
                                use_recompute=recompute,
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
    from paddle_tpu_torch.ops import attention

    kept = []
    orig = attention.output_dropout

    def rec(out, p, training, generator=None):
        res = orig(out, p, training, generator)
        if torch.cuda.is_current_stream_capturing():
            kept.append(res)
        return res

    attention.output_dropout = rec
    try:
        losses, model, opt, step = _train_run(cuda, True, steps=2,
                                              attn_dropout=0.25,
                                              dtype="float32")
    finally:
        attention.output_dropout = orig
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
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.jit import TrainStep

    emb = torch.nn.Embedding(16, 8, sparse=True).to(cuda)
    opt = topt.Adam(0.1, parameters=emb.parameters(), lazy_mode=True)

    def step_fn(ids):
        loss = emb(ids).square().sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    with pytest.raises(ValueError, match="sparse gradients"):
        TrainStep(step_fn, emb, opt)
    ids = torch.tensor([1, 3, 3], device=cuda)
    before = emb.weight.detach().clone()
    step_fn(ids)  # the eager loop takes it: only rows 1 and 3 move
    moved = (emb.weight.detach() != before).any(1)
    assert moved.nonzero().flatten().tolist() == [1, 3]
