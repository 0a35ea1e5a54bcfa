#!/usr/bin/env python3
"""On-card smoke test of paddle_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA GPU and the CUDA
toolkit:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
 1. device   the card's name and power limit (nvidia-smi), torch and CUDA
             versions;
 2. build    every CUDA source of the port with nvcc (sm_90a), timed; the
             registers, spill stores and shared memory of every kernel
             instance;
 3. kernels  the paged kernel K4 against its plain PyTorch version on the
             card, float32 and bf16, head_dim 64 and 128, decode and verify
             spans of 4, 5 and 8 rows, over ragged live lengths, lengths on
             the edges of its split chunk and (spans of 5 and 8) lengths
             past the table's last row, as a verify span at the cache
             ceiling passes them, held elementwise to the stated tolerance
             and, per (slot, head), relative to the plain version computed
             in float32; then at two decode shapes (8 slots x 1024 live
             rows, 2 slots x 2048) and one verify shape (8 slots x 5 rows
             x 1024) launched twice for bitwise-equal outputs, and the
             kernel (with L2 cold), its plain version and one library call
             timed with CUDA events, beside the least time the card could
             take;
 4. serving  gpt3-1.3B in bf16 (full width and depth, random weights from a
             seed) behind GenerationServer answers 16 requests; the decode
             step is captured once into a CUDA graph and replayed: one
             capture, more steady steps than rebuilds, no demotion, the
             paged kernel launched once per layer per step (counted on the
             card by the kernel itself, per instance, over the timed
             window; the replay count in Python agrees; torch.profiler
             over steady replays sees the kernels inside the graph) and
             the plain version never;
 4c. swap    the same mix on a fresh server (seed-0 weights, driven step by
             step on this thread) with a swap to seed-1 weights, given as a
             reference-layout numpy state, landing mid-decode: every
             request finishes, one swap and no failure is counted, the
             decode graph is not recaptured, the card counts n_layer K4
             launches per decode step of the window, and afterwards 8
             greedy requests equal a fresh server's on the new weights
             token for token; then a swap of a truncated state is refused
             and the tokens do not change. The swap's staging and copy,
             and the decode step before and after it, are reported;
 4d. retry   a fault injected after a step's graph replay (the device
             cursors advanced, the host's view not) is retried once on a
             recaptured graph: one retry, one re-prime, one capture, and
             the greedy tokens of an unfaulted run; two faults in a row
             fail the batch through the server's worker loop;
 4e. handoff disaggregated serving (gpt3-1.3B bf16, full width and
             depth, seed-0 weights): engine A (rng_seed 7) prefills phase
             4's 16 requests and exports each; engine B's scheduler
             (rng_seed 99: the exported key must rule) adopts the
             payloads and decodes; B's tokens equal a monolithic engine
             M's (rng_seed 7) bitwise, greedy and sampled; B runs no
             prefill, counts 16 imports and n_layer K4 launches per decode
             step (on the card), both pools audit clean and B's prefix
             cache holds the adopted prompts' full blocks. Export and
             import time per request against the payload's bytes, B's p50
             TTFT and decode step are reported. Then a spec engine
             (float32, 2 layers, twin drafter) adopts a handoff with plain
             decode's tokens, and the staleness cases: a re-prime on the
             decode side alone is adopted; a swap between export and
             import is refused and prefilled again, with a fresh engine's
             tokens on the new weights; a re-prime on the prefill side
             then a swap on the decode side is refused;
 4f. prefill graphs  one prompt per bucket (16..2048) on a fresh engine:
             one graph captured per bucket, the replay's first token and
             K/V rows bitwise equal to the same body called directly on
             the same buffers, both timed (host and device), the graphs'
             shared pool measured; phase 4 has checked that its prefills
             captured one graph per bucket they used, all at warm-up;
 4g. observability  4e's mix again with tracing on: every request's
             trace holds queue_wait, prefill, kv_export, kv_import,
             kv_adopt and decode; a chrome trace loads back; the ttft and
             inter_token histogram p50s lie within one bucket of the
             measured p50s; the decode step with tracing on and off. Then
             the fault points (testing.faults): page_pool_exhausted keeps
             requests queued and changes no token; decode_error is retried
             once; kill_during_swap leaves the old weights serving;
             replica_kill fails the batch through the server's loop, which
             dumps the flight recorder; draft_garbage (float32, 2 layers)
             changes no spec token; an engine captured with
             kernel_mismatch armed gives K4 output phase 3's parity check
             rejects (and passes with it off). Every fault is disarmed in
             a finally;
 5. parity   the same request through a kernel engine and a plain engine
             on the card (gpt3-1.3B width, 2 layers, float32), both
             replaying their graphs: decode logits within tolerance,
             greedy tokens equal; then speculative engines (K=4) with a
             twin drafter (every draft accepted) and an independent
             1-layer drafter: tokens equal to plain decode's, greedy and
             sampled;
 5b. spec    speculative serving at full width: gpt3-1.3B bf16 verified,
             gpt2-small bf16 drafting (seed 2), K=4, the same 16 requests;
             every request finishes, both pools audit clean, and each
             round launches the paged kernel n_layer times at a span of 5
             rows (verify) and (K+1) x 12 times at 1 row (draft round), by
             the card's count per instance and by torch.profiler; the
             share of greedy requests and tokens equal to phase 4's plain
             decode is reported (bf16: not asserted); the drafter's
             prompt ingestion replays one graph per bucket, each captured
             once at warm-up, and each replay's drafter K/V rows equal
             its body's called directly, bitwise;
 5c. spec swap  a speculative engine's target and drafter swapped together
             mid-stream: in float32 at 2 layers the tokens equal plain
             decode's under the same swap, with two weight generations of
             acceptance; at full width in bf16 (gpt2-small drafting) the
             match is reported;
 6. kernels (training)  the flash-attention kernels K1-K3 against their
             plain versions over float32 and bf16, causal and not, head_dim
             64/96/128/256 and seq_len 128/256/2048, on strided unbind views
             as the model hands them over, and at the training step's shape
             (batch 4 x 32 heads, seq_len 2048, head_dim 64, bf16, causal);
             every output held elementwise and, block by block, relative to
             the plain version's norm; each launched twice on the same
             inputs at the step's shape and at bf16 H=128, T=2048, the
             outputs bitwise equal (K1, K2 and K3); then each timed at the
             step's shape beside its plain version, one library call and
             its bound;
 7. training gpt3-1.3B in bf16 (full width and depth, random weights from
             a seed) trains through TrainStep + AdamW with master weights,
             batch 4 x 2048, on one batch: 3 steps of the same step_fn in
             a plain eager loop, then TrainStep's one CUDA graph (eager
             call, capture and replay, replay) and 5 timed replays; the
             loss must be finite and falling, one capture, every replay
             must launch K1, K2 and K3 once per layer on the card's count
             and the plain attention never, and a steady step no kernel
             from the host (torch.profiler); graph and eager step time,
             MFU and peak memory are reported;
 7b. train -> serve  the trained model saved as a checkpoint (model state,
             float32 on disk, into a temporary directory that is removed
             after); a running server on the seed-0 weights, answering a
             stream of requests, follows the directory and swaps it in
             with no failed request and no recapture; its greedy tokens
             then equal a fresh server's on the trained model. The save,
             its bytes, the follower's load and swap and the swap's stall
             are reported. Then the whole training state (2 layers, full
             width: model, AdamW moments and master weights, step count,
             cosine LR) through a checkpoint into a fresh model and
             optimizer: 2 more steps equal the uninterrupted run's,
             bitwise;
 8. training parity  one model through the kernel route and the plain
             route on the card (gpt3-1.3B width, 2 layers): in float32 at
             seq_len 256, loss and every gradient of one step, and the
             parameters after 3 AdamW steps, within tolerance; in bf16 (the
             kernels' tensor-core branch) at seq_len 2048, loss and every
             gradient of one step within a bound relative to the plain
             route's.
 9. moe serving  gpt3-1.3B bf16 at full width and depth as a Mixture of
             Experts (MOE: 8 experts, top-2, capacity factor 1.25, in
             every other block; 4.14 B parameters, seed 0) through phase
             4's server, mix and checks: one decode capture, K4 launched
             decode steps x 24 times on the card's count, no kernel
             launched from the host in a steady step, one prefill capture
             per bucket used, all at warm-up; phase 4f's check of every
             bucket (replay equal to its direct body, bitwise); the decode
             graph's tokens equal to the eager body's (8 slots); the drop
             fraction by moe.metrics.publish after one eager forward of 8
             prompts of 512 tokens; peak memory;
 9b. moe spec  phase 5b on the MoE target (gpt2-small drafting, K=4),
             drafter buckets included; then phase 5 on the MoE layout in
             float32 at 2 layers and full width, with random and with
             zeroed gate weights: K4 against its plain route (decode
             logits, greedy tokens), and spec tokens equal plain decode's
             with a twin and an independent drafter, greedy and sampled
             (a zeroed gate crowds every row onto two experts; the verify
             routes each row alone, as decode does);
 9c. moe training  the MoE layout at full width and 4 layers (2 MoE),
             bf16, TrainStep + AdamW with master weights, batch 4 x 2048,
             loss + moe_aux_loss(), 3 steps on one batch: both finite,
             the loss falling, K1-K3 launched once per layer per step;
 9d. older cache forms  gpt3-1.3B width, 2 layers, float32: greedy tokens
             through the slot cache and through one-row concat decoding
             equal the paged engine's.
10. recompute  phase 7's step (full width and depth, bf16, batch 4 x 2048)
             under each policy of bench.py's ladder (none, full, dots,
             attn, dots_attn) through TrainStep's graph: the loss finite
             and falling, one capture, per step on the card's count K1
             48 times under full and dots and 24 under the rest, K2 and K3
             24; full recompute's peak memory below none's; step time, MFU
             and peak memory per policy. Then at 2 layers in float32 each
             policy's loss and gradients against none's, within 1e-5 and
             reported bitwise or not;
10b. recipe  the GPT-3 recipe (AdamW with master weights and decay off
             biases and LayerNorms, linear warm-up into cosine stepped
             between calls, global-norm clip 1.0) at full width, 2 layers,
             bf16: 4 graph steps equal the eager loop's bitwise (losses,
             parameters, slots); with attention dropout 0.1 each replay
             keeps 90% within 0.01, scales exactly and draws new masks;
             every other optimizer, regularizer and clip on a small MLP:
             captured steps equal eager ones bitwise;
10c. recapture  mutate_signature (mode=aval) armed: one capture more and
             the same losses; a restore that rebinds the parameters'
             storage: the next call captures again and the run continues
             bitwise as it did from the snapshot.

A kernel's time ("ms") is device time: calls captured in a CUDA graph
and replayed (``device_ms``), so the host's cost per call does not count;
"eager_ms" beside it is the same kernel called from Python in a loop. K4's
calls take copies of its pools in turn (``cold_copies``), so it reads them
from device memory and not from L2; "warm_ms" is K4 on one copy.

Every K4 row's "launches" is what the card counted for the row's instance
over the main path's timed window: phase 4's decode steps (bf16, Dh 64,
one row) for the decode rows, phase 5b's verifies (the 8-row instance) for
the verify row, phase 7's graph replays for K1-K3, each counted on the
card by the kernel itself; "launches_by_path" adds the MoE paths' windows
(9, 9b, 9c) and, for K1-K3, phase 10's launches per step by policy.

Prints a {"kernels": [...]} line and the nvidia-smi line before the last
line, {"ok": true, "device": {...}}. Without CUDA, or without the rest of
the repository beside it, it prints no result and exits 2.
"""
from __future__ import annotations

import ctypes
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
# H100 SXM data sheet at its 700 W limit: HBM3 bandwidth and dense peaks by
# operand type (a card set to a lower power limit runs slower under load)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# the MoE layout of phases 9-9c: GShard's top-2 in every other FFN
# (Lepikhin et al. 2020, arXiv:2006.16668 section 2), with the reference's
# defaults for k and the capacity factor
MOE = dict(moe_num_experts=8, moe_top_k=2, moe_capacity_factor=1.25,
           moe_every=2)
PAGED_REPLACES = "paddle_tpu/ops/pallas_ops.py:475"  # _paged_attn_kernel
PAGED_SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
FLASH_SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
# kernel -> (the TPU kernel it replaces, tensor-core products per score)
FLASH_KERNELS = {
    "flash_fwd": ("paddle_tpu/ops/pallas_ops.py:93", 2),      # K1
    "flash_bwd_dq": ("paddle_tpu/ops/pallas_ops.py:137", 3),  # K2
    "flash_bwd_dkv": ("paddle_tpu/ops/pallas_ops.py:172", 4),  # K3
}
_WMMA = ("WMMA m16n16k16 through shared memory, accumulators in shared "
         "memory, 128 threads, 64-row tiles")
DESIGNS = {
    "paged_attention": "split-KV (flash-decoding): grid (head, slot, split "
                       "of 256 keys), 16-byte loads double-buffered in "
                       "registers, online softmax in registers, float32 "
                       "partials per split in a workspace sized from shapes; "
                       "a combine kernel merges the splits in index order",
    "flash_fwd": "bf16 at H=64/128: warp-specialised, TMA producer "
                 "(setmaxnreg 40/232) into a 3-stage (H=64) or 2-stage "
                 "(H=128) mbarrier ring of 128-key K/V tiles, two consumer "
                 "warpgroups of 64 query rows on wgmma with register "
                 "accumulators; float32 and bf16 at H=96/256: " + _WMMA,
    "flash_bwd_dq": "bf16 at H=64/128: warp-specialised, TMA producer "
                    "(setmaxnreg 40/232) into a 4-stage (H=64) or 3-stage "
                    "(H=128) mbarrier ring of 64-key K/V tiles, Q/dO/lse/"
                    "delta resident, two consumer warpgroups of 64 query "
                    "rows: S and dP on wgmma, dS as the register A operand "
                    "of dQ += dS K, dQ in registers; float32 and bf16 at "
                    "H=96/256: " + _WMMA,
    "flash_bwd_dkv": "bf16 at H=64/128: warp-specialised, TMA producer "
                     "(setmaxnreg 24/232) into a 3-stage mbarrier ring of "
                     "Q/dO/lse/delta tiles, 64 keys resident per block, one "
                     "consumer warpgroup on wgmma with register "
                     "accumulators, 2 blocks per SM; float32 and bf16 at "
                     "H=96/256: " + _WMMA,
}


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=50):
    """Mean milliseconds per call over ``iters`` calls, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls=20, replays=5):
    """Mean milliseconds of device time per call: ``calls`` calls captured
    in one CUDA graph and replayed ``replays`` times between CUDA events,
    so the host's cost of each call (the wrapper's checks, the ctypes call,
    the launches) does not count, as ``cuda_ms`` counts it when the host is
    slower than the card. ``fn`` is one callable, or a list of callables
    the calls take in turn (``cold_copies``). Warmed up on a side stream
    first, as capture requires."""
    fns = fn if isinstance(fn, (list, tuple)) else [fn]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns * 2:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


# H100 SXM: 50 MB of L2
L2_BYTES = 50 * 2 ** 20


def cold_copies(args, live_bytes, pools=(1, 2)):
    """Copies of ``args`` with the tensors at ``pools`` cloned, enough that
    between two uses of one copy the others touch at least twice L2's size
    of live data: calls that take them in turn read those tensors from
    device memory, as a decode step whose 24 layers each read their own
    pools does, and not from what the call before left in L2."""
    n = 1 + -(-2 * L2_BYTES // live_bytes)
    return [tuple(a.clone() if i in pools else a for i, a in enumerate(args))
            for _ in range(n)]


# --------------------------------------------------------------- kernels --
def paged_case(dev, dtype, T, seq_lens, H=32, Dh=64, bs=16, M=128, Nb=1025,
               inactive=(), share=None, seed=0):
    """Random q and pools, distinct random blocks per lane; ``inactive``
    lanes get a zeroed table row, seq_len 1 and cursor 0; ``share=(a, b,
    n)`` makes lane b's first n table entries lane a's."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    B = len(seq_lens)
    q = torch.randn(B, T, H, Dh, generator=g).to(dev, dtype)
    kp = torch.randn(Nb, bs, H, Dh, generator=g).to(dev, dtype)
    vp = torch.randn(Nb, bs, H, Dh, generator=g).to(dev, dtype)
    bt = (torch.randperm(Nb - 1, generator=g)[:B * M] + 1).view(B, M)
    sl = torch.tensor(seq_lens)
    qo = (sl - T).clamp(min=0)
    for lane in inactive:
        bt[lane] = 0
        sl[lane] = 1
        qo[lane] = 0
    if share is not None:
        a, b, n = share
        bt[b, :n] = bt[a, :n]
    return (q, kp, vp, bt.to(dev, torch.int32).contiguous(),
            sl.to(dev, torch.int32), qo.to(dev, torch.int32))


def paged_bound(q, kp, bt, sl, qo):
    """Least time (ms) for the card: each live K/V row, q, the output and
    the table entries moved once, against the data-sheet bandwidth; the
    QK and PV products against the peak for the operand type. Returns
    (ms, "bytes" | "operations")."""
    B, T, H, Dh = q.shape
    bs, es = kp.shape[1], q.element_size()
    live = torch.minimum(qo.long() + T, sl.long()).cpu()
    rows = int(live.sum())
    nbytes = (rows * H * Dh * 2 * es + 2 * q.numel() * es
              + int(((live + bs - 1) // bs).sum()) * 4 + 2 * B * 4)
    ops = 4 * rows * T * H * Dh
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(got, want, tol, what):
    atol, rtol = tol
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements outside atol={atol} "
            f"rtol={rtol}; max |err| {float(err.max()):.3e}")
    return float(err.max())


def paged_parity_cases():
    """``(dtype, Dh, T, seq_lens, seed)`` of the K4 parity sweep: float32
    and bf16, head_dim 64 and 128, decode and verify spans of 4, 5 and 8
    rows, over ragged live lengths and over lengths on the edges of the
    kernel's split chunk C: C - 1, C and C + 1, a slot shorter than one
    chunk beside a slot of 2048, and C + 2, whose 4-row span ends in two
    splits (rows 0 and 1 find every key of split 1 masked). Spans of 5 and
    8 rows (a verify of K = 4 and of the largest K, 7) also take lengths
    past the table's 2048 rows, as a verify span at the cache ceiling
    gives them: the kernel must stop at the table's last row, as the plain
    version's view does. Lane 6 is inactive and lane 7 shares lane 4's
    first 16 blocks (``paged_case``)."""
    from paddle_tpu_torch.ops import paged_attention as pa

    C = pa.split_keys()

    ragged = [1, 15, 16, 17, 700, 2048, 1, 300]
    edges = [C - 1, C, C + 1, 100, 2048, C + 2, 1, 3 * C + 1]
    for dtype in (torch.float32, torch.bfloat16):
        for Dh in (64, 128):
            for T in (1, 4, 5, 8):
                # cursors up to the table's last row, spans past it
                ceiling = [2047 + T, 2046 + T, 2047, 64, 2048, 2044 + T, 1,
                           2049]
                cases = (ragged, edges) + ((ceiling,) if T >= 5 else ())
                for i, lens in enumerate(cases):
                    yield (dtype, Dh, T, [max(n, T) for n in lens],
                           T + Dh + 2 * i)


def paged_errors(got, args):
    """K4's output ``got`` on ``args`` against its plain version: ``(max
    |err|, elements outside PAGED_PARITY_TOL or not finite, paged_rel_err
    against the plain version computed in float32 on the same values)``."""
    from paddle_tpu_torch.ops import paged_attention as pa

    want = pa.paged_attention_ref(*args)
    exact = want if want.dtype == torch.float32 else pa.paged_attention_ref(
        *(a.float() for a in args[:3]), *args[3:])
    atol, rtol = pa.PAGED_PARITY_TOL[want.dtype]
    err = (got.float() - want.float()).abs()
    bad = ~(err <= atol + rtol * want.float().abs())  # NaN counts as bad
    return (float(err.nan_to_num(float("inf")).max()), int(bad.sum()),
            pa.paged_rel_err(got, exact))


def paged_parity_errors(dev):
    """K4 against its plain version over ``paged_parity_cases``:
    ``[(case, dtype, max |err|, elements outside PAGED_PARITY_TOL or not
    finite, relative error)]`` (``paged_errors``)."""
    from paddle_tpu_torch.ops import paged_attention as pa

    out = []
    for dtype, Dh, T, lens, seed in paged_parity_cases():
        args = paged_case(dev, dtype, T, lens, Dh=Dh, inactive=(6,),
                          share=(4, 7, 16), seed=seed)
        got = pa.paged_attention(*args)
        torch.cuda.synchronize()
        out.append((f"{str(dtype)[6:]} Dh={Dh} T={T} seq_lens={lens}",
                    dtype, *paged_errors(got, args)))
    return out


def check_paged(what, dtype, err, n_bad, rel):
    """Raise unless one K4 case is finite and inside both bounds."""
    from paddle_tpu_torch.ops import paged_attention as pa

    if n_bad or not rel <= pa.PAGED_PARITY_REL[dtype]:
        raise AssertionError(
            f"paged_attention {what}: {n_bad} elements outside "
            f"{pa.PAGED_PARITY_TOL[dtype]} or not finite, max |err| "
            f"{err:.3e}; relative error {rel:.3e} (bound "
            f"{pa.PAGED_PARITY_REL[dtype]})")


# timed K4 shapes, bf16: (what, span rows, live lengths, seed). Decode: the
# serving phase's batch (8 slots x 1024 live rows), and few long slots (2
# slots x 2048), a server at low concurrency holding long contexts, where
# the split matters most; a verify span of K + 1 = 5 rows over the serving
# batch (phase 5b's verify)
PAGED_TIMED = {
    "paged_attention": ("8 slots x 1024 live rows", 1, [1024] * 8, 7),
    "paged_attention_2x2048": ("2 slots x 2048 live rows", 1, [2048] * 2, 8),
    "paged_attention_verify": ("8 slots x 5 rows x 1024 live rows", 5,
                               [1024] * 8, 9)}


def phase_kernels(dev):
    from paddle_tpu_torch.ops import paged_attention as pa

    max_err = 0.0
    max_rel = dict.fromkeys(("float32", "bfloat16"), 0.0)
    for what, dtype, err, n_bad, rel in paged_parity_errors(dev):
        check_paged(what, dtype, err, n_bad, rel)
        max_err = max(max_err, err)
        max_rel[str(dtype)[6:]] = max(max_rel[str(dtype)[6:]], rel)
        log(f"kernels: paged_attention {what} max|err|={err:.3e} tol="
            f"{pa.PAGED_PARITY_TOL[dtype]}, relative {rel:.3e} bound "
            f"{pa.PAGED_PARITY_REL[dtype]}")

    rows = []
    lib = torch.nn.functional.scaled_dot_product_attention
    for name, (shape, T, lens, seed) in PAGED_TIMED.items():
        args = paged_case(dev, torch.bfloat16, T, lens, seed=seed)
        q, kp, vp, bt, sl, qo = args
        outs = [pa.paged_attention(*args) for _ in range(2)]
        err, n_bad, rel = paged_errors(outs[0], args)
        check_paged(shape, torch.bfloat16, err, n_bad, rel)
        max_err = max(max_err, err)
        max_rel["bfloat16"] = max(max_rel["bfloat16"], rel)
        if not torch.equal(outs[0], outs[1]):
            raise AssertionError(
                f"paged_attention {shape}: two launches on the same inputs "
                f"differ in {int((outs[0] != outs[1]).sum())} elements")
        k_view, v_view = pa.paged_view(kp, bt), pa.paged_view(vp, bt)
        # the span's keep-mask: causal inside the span, live rows only
        mask = pa.position_mask(qo, sl, T, k_view.shape[1])
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k_view, v_view))
        row_bytes = 2 * kp[0, 0].numel() * kp.element_size()  # a K and a V
        copies = cold_copies(args, int(torch.minimum(qo + T, sl).sum())
                             * row_bytes)
        cold = [lambda a=a: pa.paged_attention(*a) for a in copies]
        lib_cold = [lambda a=a: lib(*a[:3], attn_mask=a[3]) for a in
                    cold_copies((qt, kt, vt, mask),
                                2 * kt.numel() * kt.element_size())]
        kern = lambda: pa.paged_attention(*args)  # noqa: E731
        ms = device_ms(cold)
        warm_ms = device_ms(kern)
        eager_ms = cuda_ms(kern)
        plain_ms = cuda_ms(lambda: pa.paged_attention_ref(*args), iters=10)
        library_ms = device_ms(lib_cold)
        ms2 = device_ms(cold)
        n_copies = len(copies)
        del copies, cold, lib_cold
        bound_ms, bound_by = paged_bound(q, kp, bt, sl, qo)
        log(f"kernels: paged_attention bf16 {shape}: max|err|={err:.3e}, "
            f"relative {rel:.3e}, two launches bitwise equal; kernel "
            f"{ms:.5f} / {ms2:.5f} ms (device time, CUDA graph, L2 cold: "
            f"{n_copies} copies of the pools in turn), {warm_ms:.5f} ms "
            f"on one copy (L2 warm), {eager_ms:.5f} ms called eagerly; "
            f"plain {plain_ms:.4f} ms, library (sdpa on the gathered view, "
            f"L2 cold) {library_ms:.5f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by}), {bound_ms / min(ms, ms2):.1%} of it")
        rows.append({"name": name, "route": "cuda", "source": PAGED_SOURCE,
                     "replaces": PAGED_REPLACES, "shape": f"bf16 {shape}",
                     "max_abs_err": max_err,
                     "tolerance": {str(k)[6:]: v
                                   for k, v in pa.PAGED_PARITY_TOL.items()},
                     "max_rel_err": dict(max_rel),
                     "rel_bound": {str(k)[6:]: v
                                   for k, v in pa.PAGED_PARITY_REL.items()},
                     "ms": min(ms, ms2), "kernel_ms": min(ms, ms2),
                     "l2": "cold", "warm_ms": warm_ms,
                     "eager_ms": eager_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms,
                     "bound_by": bound_by,
                     "bound_share": bound_ms / min(ms, ms2),
                     "design": DESIGNS["paged_attention"],
                     "library_ms": library_ms})
    return rows


# ------------------------------------------------------- flash kernels --
# the training step's attention: batch 4 x 32 heads, T=2048, head_dim 64
STEP_SHAPE = (4, 2048, 32, 64)


def flash_case(dev, dtype, B, T, N, H, seed, strided):
    """q, k, v ``[B, T, N, H]`` (unbind views of one fused projection when
    ``strided``, as the model hands them over) and an output gradient."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    if strided:
        q, k, v = torch.randn(B, T, 3, N, H, generator=g).to(
            dev, dtype).unbind(2)
    else:
        q, k, v = (torch.randn(B, T, N, H, generator=g).to(dev, dtype)
                   for _ in range(3))
    return q, k, v, torch.randn(B, T, N, H, generator=g).to(dev, dtype)


def flash_cases():
    """``(dtype, causal, H, T, B, N, strided, seed)`` of the parity sweep:
    float32 and bf16, causal and not, every head_dim the kernels take,
    T of one and two 128-row tiles and of the training step."""
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            for H in (64, 96, 128, 256):
                for T in (128, 256, 2048):
                    B, N = (1, 2) if T == 2048 else (2, 3)
                    yield (dtype, causal, H, T, B, N, T != 128,
                           T + H + causal)


def flash_case_errors(q, k, v, do, causal):
    """Each kernel's outputs against its plain version's on one case:
    ``{output: (max |err|, elements outside FLASH_PARITY_TOL or not finite,
    flash_rel_err or None)}``. K2 and K3 take the plain forward's lse and
    delta; lse is held to (1e-4, 1e-4) elementwise."""
    from paddle_tpu_torch.ops import flash_attention as fa

    out, lse = fa.flash_fwd(q, k, v, causal)
    ref, ref_lse = fa.flash_fwd_ref(q, k, v, causal)
    delta = fa.flash_delta(ref, do)
    dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal)
    rdq = fa.flash_bwd_dq_ref(q, k, v, do, ref_lse, delta, causal)
    rdk, rdv = fa.flash_bwd_dkv_ref(q, k, v, do, ref_lse, delta, causal)
    torch.cuda.synchronize()
    tol = fa.FLASH_PARITY_TOL[q.dtype]

    def elementwise(got, want, tol):
        atol, rtol = tol
        got, want = got.float(), want.float()
        err = (got - want).abs()
        bad = ~(err <= atol + rtol * want.abs())  # NaN counts as bad
        return float(err.nan_to_num(float("inf")).max()), int(bad.sum())

    res = {"flash_fwd lse": (*elementwise(lse, ref_lse, (1e-4, 1e-4)),
                             None)}
    for name, got, want in (("flash_fwd out", out, ref),
                            ("flash_bwd_dq dq", dq, rdq),
                            ("flash_bwd_dkv dk", dk, rdk),
                            ("flash_bwd_dkv dv", dv, rdv)):
        res[name] = (*elementwise(got, want, tol),
                     fa.flash_rel_err(got, want))
    return res


def check_flash_case(res, dtype, what):
    """Raise unless every output of ``flash_case_errors`` is finite, within
    FLASH_PARITY_TOL elementwise and within FLASH_PARITY_REL."""
    from paddle_tpu_torch.ops import flash_attention as fa

    rel_tol = fa.FLASH_PARITY_REL[dtype]
    for name, (err, n_bad, rel) in res.items():
        if n_bad or (rel is not None and not rel <= rel_tol):
            raise AssertionError(
                f"{name} {what}: {n_bad} elements outside "
                f"{fa.FLASH_PARITY_TOL[dtype]} or not finite, max |err| "
                f"{err:.3e}; relative error {rel} (bound {rel_tol})")


def flash_bound(name, q, causal):
    """Least time (ms) for the card to run kernel ``name`` on ``q``'s shape:
    its tensor-core products over the score pairs the mask keeps, against
    the peak for the operand type, or its inputs read once and outputs
    written once, against the data-sheet bandwidth. Returns (ms, "bytes" |
    "operations")."""
    B, T, N, H = q.shape
    es = q.element_size()
    pairs = T * (T + 1) // 2 if causal else T * T
    ops = 2 * H * pairs * FLASH_KERNELS[name][1] * B * N
    tile, rows = q.numel() * es, B * N * T * 4
    nbytes = {"flash_fwd": 4 * tile + rows,            # q k v -> out, lse
              "flash_bwd_dq": 5 * tile + 2 * rows,     # q k v do lse delta
              "flash_bwd_dkv": 6 * tile + 2 * rows}[name]
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# shapes of the run-to-run check: the training step's, and bf16 at H=128
REPEAT_SHAPES = (STEP_SHAPE, (2, 2048, 8, 128))


def flash_repeat_check(dev, B, T, N, H, seed=11):
    """Launch K1, K2 and K3 twice each on the same bf16 causal inputs (unbind
    views) and raise unless both launches give bitwise-equal outputs: a
    ring stage read after the producer overwrote it shows up as a
    run-to-run difference that a tolerance could hide. The kernels sum in
    a fixed order and use no atomics, so equal inputs give equal bits."""
    from paddle_tpu_torch.ops import flash_attention as fa

    q, k, v, do = flash_case(dev, torch.bfloat16, B, T, N, H, seed,
                             strided=True)
    fwd = [fa.flash_fwd(q, k, v, True) for _ in range(2)]
    lse = fwd[0][1]
    delta = fa.flash_delta(fwd[0][0], do)
    dq = [fa.flash_bwd_dq(q, k, v, do, lse, delta, True) for _ in range(2)]
    dkv = [fa.flash_bwd_dkv(q, k, v, do, lse, delta, True)
           for _ in range(2)]
    torch.cuda.synchronize()
    pairs = {"flash_fwd out": (fwd[0][0], fwd[1][0]),
             "flash_fwd lse": (fwd[0][1], fwd[1][1]),
             "flash_bwd_dq dq": tuple(dq),
             "flash_bwd_dkv dk": (dkv[0][0], dkv[1][0]),
             "flash_bwd_dkv dv": (dkv[0][1], dkv[1][1])}
    for name, (a, b) in pairs.items():
        if not torch.equal(a, b):
            raise AssertionError(
                f"{name} bf16 B*N={B * N} T={T} H={H}: two launches on the "
                f"same inputs differ in {int((a != b).sum())} elements")


def phase_flash_kernels(dev):
    from paddle_tpu_torch.ops import flash_attention as fa

    max_err = dict.fromkeys(FLASH_KERNELS, 0.0)
    max_rel = {str(d)[6:]: dict.fromkeys(FLASH_KERNELS, 0.0)
               for d in (torch.float32, torch.bfloat16)}

    def record(res, dtype):
        for name, (err, _, rel) in res.items():
            kern = name.split()[0]
            max_err[kern] = max(max_err[kern], err)
            if rel is not None:
                row = max_rel[str(dtype)[6:]]
                row[kern] = max(row[kern], rel)

    n_cases = 0
    for dtype, causal, H, T, B, N, strided, seed in flash_cases():
        q, k, v, do = flash_case(dev, dtype, B, T, N, H, seed, strided)
        res = flash_case_errors(q, k, v, do, causal)
        check_flash_case(res, dtype, f"{str(dtype)[6:]} causal={causal} "
                         f"H={H} T={T}")
        record(res, dtype)
        n_cases += 1

    # the training step's shape, on the unbind views of a fused projection:
    # held to the plain versions, then timed
    B, T, N, H = STEP_SHAPE
    F = torch.nn.functional
    q, k, v, do = flash_case(dev, torch.bfloat16, B, T, N, H, seed=9,
                             strided=True)
    res = flash_case_errors(q, k, v, do, True)
    check_flash_case(res, torch.bfloat16,
                     f"bf16 causal B*N={B * N} T={T} H={H} (training step)")
    record(res, torch.bfloat16)
    log(f"kernels (training): K1-K3 held to their plain versions over "
        f"{n_cases} cases (float32 and bf16, causal and not, H in "
        f"{fa.HEAD_DIMS}, T in (128, 256, 2048)) and the training step's "
        f"shape; max |err| "
        + ", ".join(f"{k} {v:.3e}" for k, v in max_err.items())
        + f" (tol {fa.FLASH_PARITY_TOL}); max relative error {max_rel} "
        f"(bound {fa.FLASH_PARITY_REL}); at the step's shape "
        + ", ".join(f"{k} {e:.3e} / {r:.3e}" for k, (e, _, r)
                    in res.items() if r is not None))

    for shape in REPEAT_SHAPES:
        flash_repeat_check(dev, *shape)
    log(f"kernels (training): K1-K3 repeat bitwise on the same inputs, bf16 "
        f"causal, [B, T, N, H] in {REPEAT_SHAPES}")

    out, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.flash_delta(out, do)
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, True),
                      lambda: fa.flash_fwd_ref(q, k, v, True)),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True),
            lambda: fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, True)),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True),
            lambda: fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, True)),
    }
    # the library yardstick: SDPA in its own [B, N, T, H] layout, forward
    # for K1, its whole backward for K2 + K3 together
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous().requires_grad_()
                       for x in (q, k, v, do))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    # (the backward through autograd, eagerly: at 0.6 ms the host's share
    # of one call is small)
    library = {
        "flash_fwd": device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), calls=10, replays=2),
        "bwd": cuda_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dot.detach(), retain_graph=True),
            iters=20)}
    rows = {}
    for name, (kern, plain) in calls.items():
        ms = device_ms(kern, calls=10, replays=2)
        eager_ms = cuda_ms(kern, iters=20)
        plain_ms = cuda_ms(plain, iters=3)
        ms2 = device_ms(kern, calls=10, replays=2)
        bound_ms, bound_by = flash_bound(name, q, causal=True)
        lib_ms = library.get(name, library["bwd"])
        log(f"kernels (training): {name} bf16 B*N={B * N} T={T} H={H} "
            f"causal: kernel {ms:.4f} / {ms2:.4f} ms (device time, CUDA "
            f"graph), {eager_ms:.4f} ms called eagerly; plain "
            f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        rows[name] = {
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": FLASH_KERNELS[name][0], "max_abs_err": max_err[name],
            "tolerance": {str(d)[6:]: t
                          for d, t in fa.FLASH_PARITY_TOL.items()},
            "max_rel_err": {d: r[name] for d, r in max_rel.items()},
            "rel_bound": {str(d)[6:]: t
                          for d, t in fa.FLASH_PARITY_REL.items()},
            "ms": min(ms, ms2), "kernel_ms": min(ms, ms2),
            "eager_ms": eager_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / min(ms, ms2), "design": DESIGNS[name],
            "library_ms": lib_ms,
            "library_call": "scaled_dot_product_attention(is_causal=True) "
            + ("forward" if name == "flash_fwd"
               else "backward (dq, dk and dv together)")}
    return rows


# -------------------------------------------------------------- training --
def training_setup(dev, preset="gpt3-1.3B", batch=4, seq_len=2048, seed=0,
                   learning_rate=1e-4, **cfg_over):
    """The pretraining step of ``bench.py``: ``preset`` in bf16 (dropout 0,
    random weights from ``seed``), ``GPTPretrainingCriterion`` (plus the
    model's ``moe_aux_loss()`` for an MoE config),
    ``AdamW(learning_rate, multi_precision=True)`` under ``TrainStep``, and
    one fixed batch of tokens from seed 0 with its next-token labels.
    Returns ``(cfg, model, opt, train, tokens, labels)``; ``train(tokens,
    labels)`` is one step and returns the loss (aux loss included): the
    first call eager, the second captured as a CUDA graph and replayed, and
    every later one a replay; ``train.step_fn(tokens, labels)`` is the same
    step run eagerly."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel,
                                             GPTPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig.preset(preset, seq_len=seq_len, dtype="bfloat16",
                           dropout=0.0, **cfg_over)
    model = GPTForPretraining(GPTModel(
        cfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed)))
    crit = GPTPretrainingCriterion()
    opt = AdamW(learning_rate=learning_rate, multi_precision=True,
                parameters=model.parameters())

    def step_fn(tokens, labels):
        loss = crit(model(tokens), labels)
        aux = model.moe_aux_loss()
        if aux is not None:
            loss = loss + aux
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    train = TrainStep(step_fn, model, opt)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (batch, seq_len))
    tokens = torch.from_numpy(toks).to(dev)
    labels = torch.from_numpy(np.roll(toks, -1, axis=1)).to(dev)
    return cfg, model, opt, train, tokens, labels


def flash_device_counts():
    """K1-K3 launches the card counted since the last
    ``reset_device_launches`` (both dtypes)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    counts = fa.device_launches()
    counts.pop("by_dtype")
    return counts


def phase_training(dev, preset="gpt3-1.3B", batch=4, seq_len=2048,
                   eager_steps=3, warmup=3, steps=5, **cfg_over):
    """7: the pretraining step through ``TrainStep``'s CUDA graph, beside
    the same ``step_fn`` in a plain eager loop (first, ``eager_steps``
    steps, the first untimed). The graph: ``warmup`` calls (eager, capture
    and replay, replay), then ``steps`` timed replays and 2 profiled ones.
    Checks: the loss finite and falling; one capture; K1-K3 launched
    steps x n_layer times on the card's count over the timed window, the
    plain attention never; no kernel launched from the host in a steady
    step (torch.profiler: one graph launch a step). Returns the result and
    the trained model (its optimizer dropped)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.profiler import registry

    t0 = time.perf_counter()
    cfg, model, opt, train, tokens, labels = training_setup(
        dev, preset, batch, seq_len, **cfg_over)
    log(f"training: {preset} bf16 n_layer={cfg.n_layer} attention route "
        f"{model.gpt.attn_kernel!r}, built in {time.perf_counter() - t0:.1f}"
        " s")
    registry.reset("jit")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, eager_s = [], []
    for _ in range(eager_steps):
        t1 = time.perf_counter()
        losses.append(float(train.step_fn(tokens, labels).detach()))
        eager_s.append(time.perf_counter() - t1)
    eager_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    free_memory()
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(warmup):
        losses.append(float(train(tokens, labels)))
    torch.cuda.synchronize()
    registry.reset("kernels")
    fa.reset_device_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = train(tokens, labels)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    losses.append(float(loss))
    counts = flash_device_counts()
    py_counts = fa.launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    prof = profile_steps(lambda: train(tokens, labels), 2)
    jit = dict(registry.counters("jit"))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training: losses {losses} are not finite and "
                             "falling")
    if model.gpt.attn_kernel != "cuda":
        raise AssertionError(f"training: the model resolved "
                             f"{model.gpt.attn_kernel!r} on the card")
    if jit["train_step_captures"] != 1 or jit["train_step_eager"] != 1:
        raise AssertionError(f"training: TrainStep counters {jit}, want one "
                             "eager call and one capture")
    for name in FLASH_KERNELS:
        if counts[name] != steps * cfg.n_layer:
            raise AssertionError(
                f"training: the card counted {counts[name]} {name} launches "
                f"over {steps} replays, want {steps} x {cfg.n_layer} layers")
    if any(py_counts.values()):
        raise AssertionError(f"training: replays moved the Python counters "
                             f"or took the plain attention: {py_counts}")
    if prof["kernel_launches"] or prof["graph_launches"] != 2:
        raise AssertionError(f"training: a steady step launched "
                             f"{prof['kernel_launches'] / 2} kernels from the "
                             f"host and {prof['graph_launches'] / 2} graphs")
    tokens_per_step = batch * seq_len
    flops = cfg.flops_per_token() * tokens_per_step
    eager_dt = float(np.mean(eager_s[1:]))
    result = {"preset": preset, "batch": batch, "seq_len": seq_len,
              "steps": steps,
              "trained_steps": eager_steps + warmup + steps + 2,
              "step_ms": dt * 1e3,
              "tokens_per_s": tokens_per_step / dt,
              "mfu": flops / dt / PEAK_FLOPS[torch.bfloat16],
              "eager_step_ms": eager_dt * 1e3,
              "eager_tokens_per_s": tokens_per_step / eager_dt,
              "eager_mfu": flops / eager_dt / PEAK_FLOPS[torch.bfloat16],
              "losses": losses, "peak_memory_gb": peak_gb,
              "eager_peak_memory_gb": eager_peak_gb,
              "kernels_per_step": prof["kernels"] / 2,
              "host_kernel_launches_per_step": prof["kernel_launches"] / 2,
              "train_step": jit, "launches": counts}
    log("training: " + json.dumps(result))
    del opt, train
    free_memory()
    return result, model


def phase_training_parity(dev, preset="gpt3-1.3B", n_layer=2, seq_len=256,
                          batch=2, steps=3, loss_tol=(1e-5, 1e-5),
                          grad_tol=(1e-5, 1e-3), param_tol=(1e-4, 1e-4)):
    """One float32 model through the kernel route and the plain route.
    Tolerances: the routes differ only in the attention's summation order
    (kernel tiles against one einsum), carried through two layers and the
    50304-wide LM head into the grads. AdamW divides each moment by the
    root of the second: where an element's gradients cancel across steps,
    that ratio magnifies a gradient difference of a few ulps, so a handful
    of elements may move by a fraction of one update (lr 1e-4) after three
    steps; the bound is that one update, and the log counts the elements
    that differ by more than 1e-6."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import registry

    cfg, models, tokens, labels, crit = _parity_models(
        dev, preset, n_layer, seq_len, batch, "float32")
    opts = [AdamW(learning_rate=1e-4, parameters=m.parameters())
            for m in models]
    registry.reset("kernels")
    max_err = {"loss": 0.0, "grad": 0.0, "param": 0.0}
    for step in range(steps):
        losses = []
        for m in models:
            loss = crit(m(tokens), labels)
            loss.backward()
            losses.append(loss.detach())
        max_err["loss"] = max(max_err["loss"], check_close(
            losses[0], losses[1], loss_tol, f"parity loss step {step}"))
        if step == 0:
            grads = [dict(m.named_parameters()) for m in models]
            for name, p in grads[0].items():
                max_err["grad"] = max(max_err["grad"], check_close(
                    p.grad, grads[1][name].grad, grad_tol,
                    f"parity grad {name}"))
        for o in opts:
            o.step()
            o.clear_grad()
    n_off = 0
    for (name, a), b in zip(models[0].named_parameters(),
                            models[1].parameters()):
        max_err["param"] = max(max_err["param"], check_close(
            a.detach(), b.detach(), param_tol,
            f"parity param {name} after {steps} steps"))
        n_off += int(((a - b).abs() > 1e-6).sum())
    n_params = sum(p.numel() for p in models[0].parameters())
    counts = fa.launches()
    if counts["flash_fwd"] != steps * n_layer or \
            counts["flash_attention_ref"] != steps * n_layer:
        raise AssertionError(f"training parity: routes not taken: {counts}")
    log(f"training parity: kernel vs plain route, {n_layer} layers d_model "
        f"{cfg.d_model} float32 T={seq_len}: max |err| loss "
        f"{max_err['loss']:.3e} (tol {loss_tol}), grads {max_err['grad']:.3e}"
        f" (tol {grad_tol}), params after {steps} AdamW steps "
        f"{max_err['param']:.3e} (tol {param_tol}; {n_off} of {n_params} "
        "elements differ by more than 1e-6)")
    return max_err


def phase_training_parity_bf16(dev, preset="gpt3-1.3B", n_layer=2,
                               seq_len=2048, batch=2, loss_rel=1e-3,
                               grad_rel=5e-2):
    """One bf16 model through the kernel route (K1-K3 on the tensor cores)
    and the plain route: the loss within ``loss_rel`` of the plain route's,
    and every gradient within ``grad_rel`` of the plain route's in norm
    (``||g - g_plain|| / ||g_plain||``, per parameter). The losses compared
    are the float32 cross-entropy of each route's bf16 logits: the
    criterion's own bf16 loss moves in steps of 2**-4 near 11, a relative
    5.6e-3, so it is either equal or a whole step apart. Tolerances: the
    plain route rounds the scores and the probabilities to bf16 where the
    kernels round P and dS, each a relative step of 2**-9, carried through
    two layers of bf16 GEMMs into the grads (about 1e-2 in norm); a fault
    that spoils one tile of the attention's gradients moves some
    parameter's gradient by tens of percent."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.profiler import registry

    cfg, models, tokens, labels, crit = _parity_models(
        dev, preset, n_layer, seq_len, batch, "bfloat16")
    registry.reset("kernels")
    losses = []
    for m in models:
        logits = m(tokens)
        crit(logits, labels).backward()
        losses.append(float(torch.nn.functional.cross_entropy(
            logits.detach().float().flatten(0, 1), labels.flatten())))
    loss_err = abs(losses[0] - losses[1]) / abs(losses[1])
    grads = [dict(m.named_parameters()) for m in models]
    rel = {}
    for name, p in grads[0].items():
        g, want = p.grad.float(), grads[1][name].grad.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"bf16 parity: non-finite grad {name}")
        rel[name] = float((g - want).norm() / want.norm())
    worst = max(rel, key=rel.get)
    counts = fa.launches()
    if counts["flash_fwd"] != n_layer or counts["flash_bwd_dkv"] != n_layer \
            or counts["flash_attention_ref"] != n_layer:
        raise AssertionError(f"bf16 parity: routes not taken: {counts}")
    log(f"training parity: kernel vs plain route, {n_layer} layers d_model "
        f"{cfg.d_model} bf16 T={seq_len}: float32 loss of the logits "
        f"{losses[0]:.6f} vs {losses[1]:.6f}, relative {loss_err:.3e} "
        f"(bound {loss_rel}); "
        f"grads relative in norm: max {rel[worst]:.3e} ({worst}), median "
        f"{sorted(rel.values())[len(rel) // 2]:.3e} (bound {grad_rel})")
    if not loss_err <= loss_rel or not rel[worst] <= grad_rel:
        raise AssertionError(f"bf16 parity: loss {loss_err:.3e} or grad "
                             f"{worst} {rel[worst]:.3e} out of bounds")
    return {"loss": loss_err, "grad": rel[worst]}


# ------------------------------------------- recompute and the step graph --
# bench.py's recompute ladder: name -> GPTConfig overrides
RECOMPUTE = {"none": {},
             "full": dict(use_recompute=True),
             "dots": dict(use_recompute=True, recompute_policy="dots"),
             "attn": dict(use_recompute=True, recompute_policy="attn"),
             "dots_attn": dict(use_recompute=True,
                               recompute_policy="dots_attn")}
# K1 launches per layer per step: the policies that keep the attention's
# output run it once, full recompute and "dots" twice
K1_PER_LAYER = {"none": 1, "full": 2, "dots": 2, "attn": 1, "dots_attn": 1}


def phase_recompute(dev, preset="gpt3-1.3B", batch=4, seq_len=2048,
                    warmup=2, steps=3):
    """10: each recompute policy at full width and depth (bf16, batch 4 x
    2048, seed-0 weights, AdamW with master weights) through
    ``TrainStep``: ``warmup`` calls (eager; capture and replay), then
    ``steps`` timed replays. Checks: the loss finite and falling, one
    capture, and per step on the card's count K1 n_layer times
    ``K1_PER_LAYER`` and K2, K3 n_layer times; full recompute's peak memory
    below ``none``'s. Reports step time, MFU and peak memory per policy."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.profiler import registry

    out = {}
    for name, over in RECOMPUTE.items():
        free_memory()
        torch.cuda.reset_peak_memory_stats(dev)
        cfg, model, opt, train, tokens, labels = training_setup(
            dev, preset, batch, seq_len, **over)
        registry.reset("jit")
        losses = [float(train(tokens, labels)) for _ in range(warmup)]
        torch.cuda.synchronize()
        fa.reset_device_launches()
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = train(tokens, labels)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / steps
        losses.append(float(loss))
        counts = flash_device_counts()
        per_step = {k: v / steps for k, v in counts.items()}
        want = {"flash_fwd": K1_PER_LAYER[name] * cfg.n_layer,
                "flash_bwd_dq": cfg.n_layer, "flash_bwd_dkv": cfg.n_layer}
        jit = dict(registry.counters("jit"))
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"recompute {name}: losses {losses}")
        if per_step != want or jit["train_step_captures"] != 1:
            raise AssertionError(f"recompute {name}: launches per step "
                                 f"{per_step}, want {want}; {jit}")
        out[name] = {"step_ms": dt * 1e3,
                     "mfu": cfg.flops_per_token() * batch * seq_len / dt
                     / PEAK_FLOPS[torch.bfloat16],
                     "peak_memory_gb":
                         torch.cuda.max_memory_allocated(dev) / 1e9,
                     "losses": losses, "launches_per_step": per_step}
        log(f"recompute {name}: " + json.dumps(out[name]))
        del model, opt, train
    free_memory()
    if not out["full"]["peak_memory_gb"] < out["none"]["peak_memory_gb"]:
        raise AssertionError(
            f"recompute: full recompute's peak "
            f"{out['full']['peak_memory_gb']:.2f} GB is not below none's "
            f"{out['none']['peak_memory_gb']:.2f}")
    return out


def phase_recompute_parity(dev, preset="gpt3-1.3B", n_layer=2, batch=2,
                           seq_len=2048, tol=(1e-5, 1e-5)):
    """10: each policy at full width and 2 layers in float32 (seed-0
    weights), one forward and backward: the loss and every gradient
    within ``tol`` of the ``none`` run's (the recomputation repeats the
    same kernels), and whether they are bitwise equal."""
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion

    runs, report = {}, {}
    for name, over in RECOMPUTE.items():
        model = build_gpt(dev, 0, preset, n_layer=n_layer, seq_len=seq_len,
                          **over)
        tokens, labels = token_batch(dev, model, batch, seq_len, seed=1)
        loss = GPTPretrainingCriterion()(model(tokens), labels)
        loss.backward()
        runs[name] = (loss.detach(), [p.grad for p in model.parameters()])
        del model
        if name == "none":
            continue
        (l0, g0), (l1, g1) = runs["none"], runs[name]
        err = max([check_close(l1, l0, tol, f"recompute {name} loss")]
                  + [check_close(b, a, tol, f"recompute {name} grad")
                     for a, b in zip(g0, g1)])
        report[name] = {"max_abs_err": err, "bitwise": bool(
            torch.equal(l0, l1) and all(torch.equal(a, b)
                                        for a, b in zip(g0, g1)))}
        runs.pop(name)
    log(f"recompute parity (float32, {n_layer} layers, batch {batch} x "
        f"{seq_len}, against none, tol {tol}): {json.dumps(report)}")
    free_memory()
    return report


def token_batch(dev, model, batch, seq_len, seed):
    """Random tokens from ``seed`` over ``model``'s vocabulary and their
    next-token labels, on the card."""
    toks = np.random.default_rng(seed).integers(
        0, model.gpt.cfg.vocab_size, (batch, seq_len))
    return (torch.from_numpy(toks).to(dev),
            torch.from_numpy(np.roll(toks, -1, axis=1)).to(dev))


def recipe_setup(dev, seed, preset="gpt3-1.3B", n_layer=2, seq_len=2048,
                 attn_dropout=0.0):
    """The GPT-3 pretraining recipe at ``preset``'s width: AdamW with master
    weights and decoupled decay on every weight but biases and LayerNorms,
    a linear warm-up into a cosine decay (stepped by the caller between
    steps), a global-norm clip of 1.0. Returns ``(model, opt, sched,
    step_fn)``."""
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)

    model = build_gpt(dev, seed, preset, n_layer=n_layer, seq_len=seq_len,
                      dtype="bfloat16", dropout=0.0,
                      attn_dropout=attn_dropout)
    sched = LinearWarmup(CosineAnnealingDecay(3e-4, T_max=8, eta_min=3e-5),
                         warmup_steps=2, start_lr=1e-4, end_lr=3e-4)
    opt = AdamW(learning_rate=sched, weight_decay=0.1, multi_precision=True,
                parameters=list(model.named_parameters()),
                grad_clip=ClipGradByGlobalNorm(1.0),
                apply_decay_param_fun=lambda n: not (
                    n.endswith(".bias") or ".ln" in n))
    crit = GPTPretrainingCriterion()

    def step_fn(tokens, labels):
        loss = crit(model(tokens), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return model, opt, sched, step_fn


class DropoutRecorder:
    """Test instrumentation: ``ops.attention.output_dropout`` wrapped to
    keep the input and output of each call made while a CUDA graph
    captures; replays rewrite those tensors in place."""

    def __init__(self):
        from paddle_tpu_torch.ops import attention

        self.mod, self.orig, self.calls = attention, \
            attention.output_dropout, []

    def __enter__(self):
        def rec(out, p, training, generator=None):
            res = self.orig(out, p, training, generator)
            if torch.cuda.is_current_stream_capturing():
                self.calls.append((out, res, p))
            return res

        self.mod.output_dropout = rec
        return self

    def __exit__(self, *exc):
        self.mod.output_dropout = self.orig


def optimizer_cases():
    """(label, optimizer class name, keyword arguments) for phase 10b's
    captured-step check: every optimizer, regularizer and clip of the
    port beside AdamW's recipe, on dense gradients (sparse rows and
    ``lazy_mode`` are eager-only on the card: ``refusals`` checks that
    ``TrainStep`` refuses them)."""
    from paddle_tpu_torch import nn as N
    from paddle_tpu_torch import regularizer as R

    return [("SGD", "SGD", dict(learning_rate=0.1)),
            ("Momentum", "Momentum", dict(learning_rate=0.1)),
            ("Momentum nesterov", "Momentum",
             dict(learning_rate=0.1, use_nesterov=True)),
            ("Lars", "Lars", dict(learning_rate=0.5, lars_coeff=0.01)),
            ("Adamax", "Adamax", dict(learning_rate=0.01)),
            ("Adagrad", "Adagrad", dict(learning_rate=0.05)),
            ("Adadelta", "Adadelta", dict(learning_rate=1.0)),
            ("RMSProp centered", "RMSProp",
             dict(learning_rate=0.01, momentum=0.5, centered=True)),
            ("Lamb", "Lamb", dict(learning_rate=0.01)),
            ("SGD + L1Decay", "SGD", dict(learning_rate=0.1,
                                          weight_decay=R.L1Decay(0.01))),
            ("Momentum + L2Decay", "Momentum",
             dict(learning_rate=0.1, weight_decay=R.L2Decay(0.01))),
            ("Adagrad + ClipGradByValue", "Adagrad",
             dict(learning_rate=0.05, grad_clip=N.ClipGradByValue(0.01))),
            ("RMSProp + ClipGradByNorm", "RMSProp",
             dict(learning_rate=0.01, grad_clip=N.ClipGradByNorm(0.1)))]


def captured_equals_eager(dev, label, cls, kw, steps=3):
    """A small MLP under ``cls(**kw)`` (its first weight at half the rate),
    ``steps`` calls of ``TrainStep`` (eager, capture and replay, replay)
    against the same ``step_fn`` run eagerly: parameters and slots bitwise
    equal."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.jit import TrainStep

    x = torch.randn(64, 256, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))

    def build():
        torch.manual_seed(0)
        net = torch.nn.Sequential(torch.nn.Linear(256, 512),
                                  torch.nn.GELU(),
                                  torch.nn.Linear(512, 256)).to(dev)
        net[0].weight.optimize_attr = {"learning_rate": 0.5}
        opt = getattr(O, cls)(parameters=net.parameters(), **kw)

        def step_fn(inp):
            loss = (net(inp) - inp).square().mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        return net, opt, step_fn

    ng, og, fg = build()
    ne, oe, fe = build()
    train = TrainStep(fg, ng, og)
    for _ in range(steps):
        train(x)
        fe(x)
    torch.cuda.synchronize()
    sg, se = og.state_dict(), oe.state_dict()
    same = all(torch.equal(a, b) for a, b in
               zip(ng.parameters(), ne.parameters())) and \
        sorted(sg) == sorted(se) and all(
            torch.equal(sg[k], se[k]) if isinstance(sg[k], torch.Tensor)
            else sg[k] == se[k] for k in sg)
    if not same:
        raise AssertionError(f"recipe: {label}: {steps} TrainStep calls "
                             "differ from the eager step")
    return len(sg) - 1


def refusals(dev):
    """A ``step_fn`` that reads the host is refused from its first call,
    twice, with nothing captured; a sparse embedding is refused when the
    step is built; then a good step still captures and replays in this
    process (no capture was left invalidated). Returns the messages."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.profiler import registry

    lin = torch.nn.Linear(64, 64).to(dev)
    opt = O.SGD(0.1, parameters=lin.parameters())

    def reads_host(x):
        loss = lin(x).square().mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        if float(loss) > 1e9:
            print("large")
        return loss

    registry.reset("jit")
    x = torch.ones(8, 64, device=dev)
    step, said = TrainStep(reads_host, lin, opt), {}
    for _ in range(2):
        try:
            step(x)
        except RuntimeError as e:
            if "could not be captured" not in str(e):
                raise
            said["host_read"] = str(e)[:120]
        else:
            raise AssertionError("refusals: a step that reads the host ran")
    emb = torch.nn.Embedding(64, 64, sparse=True).to(dev)
    try:
        TrainStep(reads_host, emb, O.Adam(0.1, parameters=emb.parameters(),
                                          lazy_mode=True))
    except ValueError as e:
        said["sparse"] = str(e)[:120]
    else:
        raise AssertionError("refusals: TrainStep took a sparse embedding")
    if registry.counters("jit")["train_step_captures"]:
        raise AssertionError("refusals: a refused step was captured")
    captured_equals_eager(dev, "SGD after the refusals", "SGD",
                          dict(learning_rate=0.1))
    return said


def phase_recipe_graph(dev, preset="gpt3-1.3B", n_layer=2, batch=4,
                       seq_len=2048, steps=4, p=0.1):
    """10b: the GPT-3 recipe (``recipe_setup``) at full width, 2 layers,
    bf16. Without dropout, ``steps`` ``TrainStep`` calls give losses,
    parameters and optimizer slots bitwise equal to the same ``step_fn``
    in an eager loop, the scheduler stepped between calls on both sides
    (a rate baked in at capture would break it from the third step). With
    attention dropout ``p``, each replay's masks (read from the graph's
    own tensors, layer 0) keep ``1 - p`` of the outputs within 0.01,
    scale the kept ones by ``1 / (1 - p)`` exactly, and differ from the
    replay before. Then every optimizer, regularizer and clip of the
    port: a captured step equals its eager step (``optimizer_cases``),
    and the steps ``TrainStep`` cannot capture are refused (``refusals``)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.profiler import registry

    runs = []
    for graph in (True, False):
        model, opt, sched, step_fn = recipe_setup(dev, 0, preset, n_layer,
                                                  seq_len)
        tokens, labels = token_batch(dev, model, batch, seq_len, seed=2)
        train = TrainStep(step_fn, model, opt) if graph else step_fn
        registry.reset("jit")
        losses, rates = [], []
        for _ in range(steps):
            rates.append(sched())
            losses.append(train(tokens, labels).detach().float())
            sched.step()
        torch.cuda.synchronize()
        runs.append((losses, rates, list(model.parameters()),
                     opt.state_dict(), dict(registry.counters("jit"))))
        del train, step_fn
    (lg, rg, pg, sg, jit), (le, re_, pe, se, _) = runs
    same = (all(torch.equal(a, b) for a, b in zip(lg, le))
            and all(torch.equal(a, b) for a, b in zip(pg, pe))
            and all(torch.equal(sg[k], se[k]) for k in sg
                    if isinstance(sg[k], torch.Tensor)))
    if not same or rg != re_ or len(set(rg)) != steps or \
            jit["train_step_captures"] != 1:
        raise AssertionError(f"recipe: graph losses {lg} vs eager {le} "
                             f"(bitwise equal: {same}), rates {rg}, {jit}")
    del runs, pg, pe, sg, se
    free_memory()
    result = {"losses": [float(x) for x in lg], "rates": rg,
              "bitwise": True}

    model, opt, sched, step_fn = recipe_setup(dev, 0, preset, n_layer,
                                              seq_len, attn_dropout=p)
    train = TrainStep(step_fn, model, opt)
    with DropoutRecorder() as rec:
        train(tokens, labels)
        train(tokens, labels)  # captured here
    if len(rec.calls) != n_layer:
        raise AssertionError(f"recipe: {len(rec.calls)} dropout calls "
                             f"captured, want {n_layer}")
    inp, out, _ = rec.calls[0]
    masks, rates = [], []
    for i in range(3):
        if i:
            train(tokens, labels)
        torch.cuda.synchronize()
        keep = out != 0
        rates.append(float(keep.float().mean()))
        want = torch.where(keep, inp / (1.0 - p), torch.zeros_like(inp))
        if abs(rates[-1] - (1 - p)) > 0.01 or not torch.equal(out, want):
            raise AssertionError(f"recipe: replay {i}: keep rate "
                                 f"{rates[-1]:.4f} or the scale is off")
        masks.append(keep.clone())
    changed = [float((a != b).float().mean())
               for a, b in zip(masks, masks[1:])]
    if min(changed) < p:
        raise AssertionError(f"recipe: replays share their dropout masks "
                             f"(changed fractions {changed})")
    result["dropout"] = {"keep_rates": rates, "mask_changed": changed}
    del model, opt, train, rec, inp, out, masks
    free_memory()

    result["optimizers"] = {label: captured_equals_eager(dev, label, cls, kw)
                            for label, cls, kw in optimizer_cases()}
    result["refusals"] = refusals(dev)
    log(f"recipe (graph, {preset} width, {n_layer} layers, bf16): "
        + json.dumps(result))
    return result


def phase_recapture(dev, preset="gpt3-1.3B", n_layer=2, batch=2,
                    seq_len=1024, steps=5):
    """10c: ``mutate_signature:nth=2,mode=aval`` armed over ``steps`` calls
    of the recipe (no dropout) captures once more than an unarmed run,
    with bitwise the same losses. Then a restore taken after 3 steps that
    rebinds every parameter's storage (``p.data = ...``; the optimizer's
    slots and the schedule restored in place) makes the next call capture
    again, and the 2 steps after it equal the 2 the run took from there,
    losses and parameters bitwise."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.testing import faults

    def setup():
        model, opt, sched, step_fn = recipe_setup(dev, 0, preset, n_layer,
                                                  seq_len)
        registry.reset("jit")
        return model, opt, sched, TrainStep(step_fn, model, opt)

    def steps_of(run, n):
        model, _, sched, train = run
        tokens, labels = token_batch(dev, model, batch, seq_len, seed=3)
        losses = []
        for _ in range(n):
            losses.append(train(tokens, labels).float())
            sched.step()
        return losses

    def captures():
        return registry.counters("jit")["train_step_captures"]

    runs = {}
    for spec in (None, "mutate_signature:nth=2,mode=aval"):
        run = setup()
        try:
            if spec:
                faults.configure(spec)
            losses = steps_of(run, steps)
        finally:
            faults.reset()
        runs[spec] = (losses, captures())
        del run
        free_memory()
    (plain, plain_caps), (armed, armed_caps) = runs.values()
    if armed_caps != plain_caps + 1 or not all(
            torch.equal(a, b) for a, b in zip(plain, armed)):
        raise AssertionError(f"recapture: armed {armed_caps} captures, "
                             f"losses {armed}; unarmed {plain_caps}, "
                             f"{plain}")

    run = setup()
    model, opt, sched, _ = run
    steps_of(run, 3)
    snap = ([p.detach().clone() for p in model.parameters()],
            {k: v.clone() if isinstance(v, torch.Tensor) else v
             for k, v in opt.state_dict().items()},
            sched.state_dict(), sched.lr_sched.state_dict())
    want = steps_of(run, 2)
    want_params = [p.detach().clone() for p in model.parameters()]
    before = captures()
    with torch.no_grad():
        for p, v in zip(model.parameters(), snap[0]):
            p.data = v.clone()
    opt.set_state_dict(snap[1])
    sched.set_state_dict(snap[2])
    sched.lr_sched.set_state_dict(snap[3])
    got = steps_of(run, 2)
    recaptured = captures() - before
    same = all(torch.equal(a, b) for a, b in zip(got, want)) and all(
        torch.equal(a, b) for a, b in zip(model.parameters(), want_params))
    if recaptured != 1 or not same:
        raise AssertionError(f"recapture: after a rebinding restore "
                             f"{recaptured} captures, losses {got} vs "
                             f"{want} (parameters equal: {same})")
    result = {"mutate_signature_captures": [plain_caps, armed_caps],
              "losses": [float(x) for x in plain],
              "restore_recaptures": recaptured,
              "resumed_losses": [float(x) for x in got]}
    log("recapture: " + json.dumps(result))
    del run, model, opt, snap
    free_memory()
    return result


# --------------------------------------------------------- train -> serve --
def phase_train_to_serve(dev, trained, step, preset="gpt3-1.3B",
                         dtype="bfloat16", max_batch_size=8, block_size=16,
                         prompt_len=64, new_tokens=64, interval=0.2):
    """7b: phase 7's trained model saved with ``save_checkpoint`` (model
    state only, float32 on disk) into a temporary directory; a server on
    the seed-0 weights, answering a stream of requests, follows the
    directory (``watch_checkpoints``) and swaps the checkpoint in mid-flight
    with no failed request; its greedy tokens then equal a fresh server's
    built on the trained model itself."""
    from paddle_tpu_torch.incubate import checkpoint as ckpt
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel)
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import GenerationServer

    cfg = GPTConfig.preset(preset, dtype=dtype)
    base = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        log(f"train->serve: {shutil.disk_usage(base).free / 1e9:.1f} GB "
            f"free under {os.path.dirname(base)}")
        t_ck = registry.timings("checkpoint")
        t0 = time.perf_counter()
        ckpt.save_checkpoint(base, ckpt.capture_training_state(trained),
                             step)
        save_s = time.perf_counter() - t0
        t_ck1 = registry.timings("checkpoint")
        payload = Path(base, f"ckpt-{step:08d}", "data-rank00000.pkl")
        result = {
            "step": step, "bytes": payload.stat().st_size, "save_s": save_s,
            "snapshot_s": t_ck1["checkpoint.save.snapshot"]["total_s"]
            - t_ck.get("checkpoint.save.snapshot", {"total_s": 0})["total_s"],
            "pickle_crc_write_fsync_s":
            t_ck1["checkpoint.save.write"]["total_s"]
            - t_ck.get("checkpoint.save.write", {"total_s": 0})["total_s"]}

        srv = GenerationServer(GPTForPretraining(GPTModel(
            cfg, device=dev,
            generator=torch.Generator(device=dev).manual_seed(0))),
            max_batch_size=max_batch_size, block_size=block_size,
            max_queue_size=64, device=dev).start()
        try:
            srv.generate(list(range(1, 40)), max_new_tokens=4)
            c0, sw0 = registry.counters("serving"), swap_timings()
            rng = np.random.default_rng(7)
            handles = []

            def feed():
                while srv.scheduler.queued() < max_batch_size:
                    handles.append(srv.submit(
                        rng.integers(0, cfg.vocab_size, prompt_len).tolist(),
                        max_new_tokens=new_tokens, seed=len(handles)))

            t0 = time.perf_counter()
            srv.watch_checkpoints(base, interval=interval)
            while srv.last_swap_step != step:
                err = srv.scheduler.last_swap_error
                if err is not None or time.perf_counter() - t0 > 600:
                    raise AssertionError(f"train->serve: the follower did "
                                         f"not swap in 600 s ({err!r})")
                feed()
                time.sleep(0.005)
            follow_s = time.perf_counter() - t0
            in_flight = srv.scheduler.active()
            feed()
            for h in handles:
                h.result(timeout=600)
            c1, sw1 = registry.counters("serving"), swap_timings()
            bad = [h for h in handles if h.status != "done"
                   or len(h.tokens) != new_tokens]
            if bad or c1["requests_failed"] != c0["requests_failed"] or \
                    c1["weight_swaps"] != c0["weight_swaps"] + 1 or \
                    c1["decode_compiles"] != c0["decode_compiles"]:
                raise AssertionError(
                    f"train->serve: {len(bad)} requests unfinished, "
                    f"counters {c0} -> {c1}")
            reqs = greedy_requests(cfg.vocab_size, 5)
            got = [h.result(timeout=600).tokens
                   for h in [srv.submit(p, **o) for p, o in reqs]]
        finally:
            srv.shutdown(timeout=600)
        del srv
        free_memory()
        fresh = GenerationServer(trained, max_batch_size=max_batch_size,
                                 block_size=block_size, max_queue_size=64,
                                 device=dev).start()
        try:
            want = [h.result(timeout=600).tokens
                    for h in [fresh.submit(p, **o) for p, o in reqs]]
        finally:
            fresh.shutdown(timeout=600)
        if got != want:
            raise AssertionError("train->serve: the follower's tokens differ "
                                 "from a fresh server's on the trained model")
        result.update({
            "follow_load_and_swap_s": follow_s,
            "swap_stage_s": sw1["stage"] - sw0["stage"],
            "swap_commit_s": sw1["commit"] - sw0["commit"],
            "requests_served_across": len(handles),
            "requests_in_flight_at_swap": in_flight,
            "greedy_tokens_equal_fresh_server": True})
        log("train->serve: " + json.dumps(result))
        return result
    finally:
        shutil.rmtree(base, ignore_errors=True)
        free_memory()


def phase_train_state_round_trip(dev, preset="gpt3-1.3B", n_layer=2,
                                 seq_len=2048, batch=4, before=3, after=2):
    """7b: the whole training state (model, AdamW moments and master
    weights, step count, LR schedule) through a checkpoint at full width
    and 2 layers: saved after ``before`` steps, restored into a fresh
    model and optimizer, then ``after`` steps whose losses, parameters and
    optimizer slots must equal the uninterrupted run's, bitwise."""
    from paddle_tpu_torch.incubate import checkpoint as ckpt
    from paddle_tpu_torch.optimizer.lr import CosineAnnealingDecay

    def setup(seed):
        sched = CosineAnnealingDecay(1e-4, T_max=10)
        out = training_setup(dev, preset, batch, seq_len, seed=seed,
                             learning_rate=sched, n_layer=n_layer)
        return (sched,) + out

    def steps(run, n):
        sched, _, _, _, train, tokens, labels = run
        losses = []
        for _ in range(n):
            losses.append(float(train(tokens, labels).detach()))
            sched.step()
        return losses

    base = tempfile.mkdtemp(prefix="chip_smoke_state_")
    try:
        run = setup(0)
        steps(run, before)
        ckpt.save_checkpoint(base, ckpt.capture_training_state(run[2],
                                                               run[3]),
                             before - 1)
        want = steps(run, after)
        state, man = ckpt.load_latest(base)
        resumed = setup(5)
        ckpt.restore_training_state(resumed[2], resumed[3], state)
        got = steps(resumed, after)
        opt_step = resumed[3]._opt_step
        pairs = list(zip(run[2].parameters(), resumed[2].parameters()))
        a, b = run[3].state_dict(), resumed[3].state_dict()
        pairs += [(a[k], b[k]) for k in a if isinstance(a[k], torch.Tensor)]
        same = all(torch.equal(x, y) for x, y in pairs)
        lr = (run[0](), resumed[0]())
    finally:
        shutil.rmtree(base, ignore_errors=True)
    if got != want or not same or opt_step != before + after or \
            lr[0] != lr[1]:
        raise AssertionError(
            f"training state round trip: losses {got} vs {want}, "
            f"parameters and slots equal: {same}, step count {opt_step}, "
            f"learning rates {lr}")
    log(f"train->serve: training state of {preset} (n_layer={n_layer}, "
        f"bf16, AdamW with master weights, cosine LR) through checkpoint "
        f"step {man['step']}: {after} resumed steps equal the uninterrupted "
        f"run's bitwise (losses {got}, {len(pairs)} parameters and slots)")
    free_memory()
    return got


def _parity_models(dev, preset, n_layer, seq_len, batch, dtype):
    """Two copies of one seeded model, on the kernel route and on the plain
    route, a batch from seed 1 and the criterion."""
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel,
                                             GPTPretrainingCriterion)

    cfg = GPTConfig.preset(preset, n_layer=n_layer, seq_len=seq_len,
                           dtype=dtype)
    models = [GPTForPretraining(GPTModel(
        cfg, device=dev, attn_kernel=kind,
        generator=torch.Generator(device=dev).manual_seed(1)))
        for kind in ("cuda", "torch")]
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (batch, seq_len))
    tokens = torch.from_numpy(toks).to(dev)
    labels = torch.from_numpy(np.roll(toks, -1, axis=1)).to(dev)
    return cfg, models, tokens, labels, GPTPretrainingCriterion()


# --------------------------------------------------------------- serving --
def serving_requests(vocab, n=16, seed=0):
    """16 prompts of 16..1000 tokens; four share a 256-token prefix; half
    greedy, half temperature 0.8 / top_p 0.9; 32 new tokens each."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 256).tolist()
    out = []
    for i in range(n):
        if i % 4 == 1:
            prompt = shared + rng.integers(0, vocab, int(
                rng.integers(16, 500))).tolist()
        else:
            prompt = rng.integers(0, vocab, int(
                rng.integers(16, 1001))).tolist()
        opts = dict(max_new_tokens=32, seed=i)
        if i % 2:
            opts.update(temperature=0.8, top_p=0.9)
        out.append((prompt, opts))
    return out


_SPLIT = re.compile(r"paged_attention_split_kernel<[^,>]+, ?(\d+), ?(\d+)>")


def profile_steps(step, n):
    """Run ``step()`` ``n`` times under torch.profiler and count what the
    card ran: ``{"split": {(Dh, rows of the instance): launches of K4's
    split pass}, "combine": launches of its combine, "kernels": every
    kernel, "graph_launches": cudaGraphLaunch calls, "kernel_launches":
    kernel launch calls made from the host}``. CUPTI reports each kernel
    of a replayed CUDA graph as its own activity, so the kernels inside
    the graph are counted one by one."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    out = {"split": {}, "combine": 0, "kernels": 0, "graph_launches": 0,
           "kernel_launches": 0}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out["kernels"] += 1
            m = _SPLIT.search(e.name)
            if m:
                key = (int(m.group(1)), int(m.group(2)))
                out["split"][key] = out["split"].get(key, 0) + 1
            elif "paged_attention_combine_kernel" in e.name:
                out["combine"] += 1
        elif e.name == "cudaGraphLaunch":
            out["graph_launches"] += 1
        elif e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                        "cuLaunchKernel", "cuLaunchKernelEx"):
            out["kernel_launches"] += 1
    return out


def fill_slots(engine, vocab, n_slots, prompt_len=512, seed=5):
    """Admit ``n_slots`` prompts of random tokens into an idle engine."""
    rng = np.random.default_rng(seed)
    for slot in range(n_slots):
        engine.prefill(slot, rng.integers(0, vocab, prompt_len).tolist(),
                       seed=slot, max_new_tokens=64)


def free_memory():
    """Drop what a phase left: an engine and its captured graphs refer to
    each other, so they go with a collection."""
    gc.collect()
    torch.cuda.empty_cache()


class BucketLog:
    """Test instrumentation: the prompt buckets an engine's prefills use,
    recorded where its prefill looks its bucket up
    (``GenerationEngine._prefill_bucket``, the target's prefill only)."""

    def __init__(self, engine):
        self.used = set()
        self._orig = engine._prefill_bucket
        engine._prefill_bucket = self

    def __call__(self, L):
        self.used.add(L)
        return self._orig(L)


def serve(srv, reqs, vocab):
    """Serve ``reqs`` after a warm-up: one request whose decode step
    captures the engine's decode graphs, then one single-token request per
    prompt bucket up to the mix's longest prompt, whose prefills capture
    the buckets' graphs, so the timed window captures nothing. Returns the
    handles, the wall time and the counters, graph replays and K4's
    launches as the card counted them (``counts["device"]``, per instance)
    of the timed window, with the prefill buckets used
    (``counts["prefill_buckets"]``, warm-up and window) and the captures at
    warm-up of the target's and a spec drafter's prefill buckets."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving.engine import StepGraph

    eng = srv.engine
    graphs = {a: g for a, g in vars(eng).items()
              if isinstance(g, StepGraph)}
    buckets = BucketLog(eng)

    c0 = registry.counters("serving")
    srv.generate(list(range(1, 40)), max_new_tokens=4)
    top = eng.bucket_for(max(len(p) for p, _ in reqs))
    rng = np.random.default_rng(99)
    for b in eng.buckets:
        if b <= top:
            srv.generate(rng.integers(0, vocab, b - 1).tolist(),
                         max_new_tokens=1)
    c1 = registry.counters("serving")
    compiles = c1["decode_compiles"] - c0["decode_compiles"]
    prefill_captures = c1["prefill_compiles"] - c0["prefill_compiles"]
    draft_captures = c1["draft_prefill_compiles"] \
        - c0["draft_prefill_compiles"]
    for scope in ("kernels", "serving", "fastpath"):
        registry.reset(scope)
    pa.reset_device_launches()
    replays = {a: g.replays for a, g in graphs.items()}
    t0 = time.perf_counter()
    handles = [srv.submit(p, **o) for p, o in reqs]
    for h in handles:
        h.result(timeout=600)
    wall = time.perf_counter() - t0
    bad = [h for h in handles if h.status != "done"
           or len(h.tokens) != h.max_new_tokens]
    if bad:
        raise AssertionError(f"unfinished requests {bad}")
    toks = [t for h in handles for t in h.tokens]
    if not all(0 <= t < vocab for t in toks):
        raise AssertionError("token id out of range")
    counts = {scope: registry.counters(scope)
              for scope in ("kernels", "serving", "fastpath")}
    counts["device"] = pa.device_launches()
    counts["captures_at_warmup"] = compiles
    counts["prefill_captures_at_warmup"] = prefill_captures
    counts["draft_prefill_captures_at_warmup"] = draft_captures
    counts["prefill_buckets"] = sorted(buckets.used)
    del eng._prefill_bucket  # the instrumentation goes
    counts["replays"] = {a: g.replays - replays[a] for a, g in graphs.items()}
    ttft = sorted(h.ttft_s for h in handles)
    step_t = registry.timings("serving")["serving.decode_step"]
    return handles, wall, counts, {
        "requests": len(handles), "tokens": len(toks), "wall_s": wall,
        "tokens_per_s": len(toks) / wall,
        "ttft_p50_ms": ttft[len(ttft) // 2] * 1e3,
        "decode_step_p50_ms": step_t["p50_ms"]}


def instance_name(key):
    """``"bfloat16 Dh=64 rows=1"`` for a K4 instance ``(dtype, Dh, rows)``
    of ``paged_attention.device_launches``."""
    return f"{key[0]} Dh={key[1]} rows={key[2]}"


def check_device_launches(what, counts, want):
    """K4's launches as the card counted them over the timed window, per
    instance, against ``want``; the Python counter (replays x the launches
    a capture recorded) must sum to the same."""
    got = counts["device"]
    derived = counts["kernels"]["paged_attention"]
    named = {instance_name(k): v for k, v in got.items()}
    if got != want or sum(got.values()) != derived:
        raise AssertionError(
            f"{what}: the card counted K4 launches {named}; want "
            f"{dict((instance_name(k), v) for k, v in want.items())}, and "
            f"{derived} by the replay count")
    return named


def weights_sum(model):
    """The sum of every parameter in float64: two phases that build the
    same model from one seed must agree on it."""
    return float(sum(p.sum(dtype=torch.float64) for p in model.parameters()))


def check_fast_path(what, counts, captures):
    """One capture per graph at warm-up and none after; steady steps
    outnumber rebuilds; no demotion. One prefill graph captured per
    distinct bucket its prompts used, all at warm-up."""
    fp = counts["fastpath"]
    if counts["prefill_captures_at_warmup"] != \
            len(counts["prefill_buckets"]) or \
            counts["serving"]["prefill_compiles"]:
        raise AssertionError(
            f"{what}: {counts['prefill_captures_at_warmup']} prefill "
            f"graphs captured at warm-up and "
            f"{counts['serving']['prefill_compiles']} after it, for the "
            f"buckets {counts['prefill_buckets']}")
    if counts["captures_at_warmup"] != captures or \
            counts["serving"]["decode_compiles"]:
        raise AssertionError(
            f"{what}: {counts['captures_at_warmup']} graph captures at "
            f"warm-up (want {captures}) and "
            f"{counts['serving']['decode_compiles']} after it (want 0)")
    if not fp["decode_fast_steps"] > fp["decode_rebuilds"] or \
            fp["decode_demotions"]:
        raise AssertionError(f"{what}: fast path {fp}")


def phase_serving(dev, preset="gpt3-1.3B", dtype="bfloat16",
                  max_batch_size=8, block_size=16, n_requests=16,
                  profiled_steps=4, model=None, **cfg_over):
    """Phase 4 (and 9's serving): ``model`` (built here from seed 0 when
    None, and dropped after) behind a ``GenerationServer``."""
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel)
    from paddle_tpu_torch.serving import GenerationServer

    cfg = GPTConfig.preset(preset, dtype=dtype, **cfg_over)
    t0 = time.perf_counter()
    if model is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        model = GPTForPretraining(GPTModel(cfg, device=dev, generator=gen))
    srv = GenerationServer(model, max_batch_size=max_batch_size,
                           block_size=block_size, max_queue_size=64,
                           device=dev)
    eng = srv.engine
    what = "moe serving" if cfg.moe_num_experts else "serving"
    log(f"{what}: {preset} {dtype} n_layer={cfg.n_layer} built in "
        f"{time.perf_counter() - t0:.1f} s; paged kernel "
        f"{eng.paged_kernel!r}")
    try:
        handles, wall, counts, result = serve(
            srv, serving_requests(cfg.vocab_size, n=n_requests),
            cfg.vocab_size)
    finally:
        srv.shutdown()
    launches = counts["kernels"]
    steps = counts["serving"]["decode_steps"]
    want = steps * cfg.n_layer
    head_dim = cfg.d_model // cfg.n_head
    if eng.paged_kernel != "cuda":
        raise AssertionError(f"serving: the engine resolved "
                             f"{eng.paged_kernel!r} on the card")
    check_fast_path("serving", counts, captures=1)
    if launches["paged_attention"] != want or steps == 0:
        raise AssertionError(
            f"serving: {launches['paged_attention']} kernel launches for "
            f"{steps} decode steps x {cfg.n_layer} layers = {want}")
    if launches["paged_attention_ref"]:
        raise AssertionError(f"serving: the plain version ran "
                             f"{launches['paged_attention_ref']} times")
    device = check_device_launches("serving", counts,
                                   {(dtype, head_dim, 1): want})
    if counts["serving"]["prefix_hits"] < 3:
        raise AssertionError(
            f"serving: {counts['serving']['prefix_hits']} prefix hits for "
            "four requests sharing a 256-token prefix")
    eng.pool.audit()

    # the launches inside the graph, seen by the profiler: steady replays
    # of a full batch, after the rebuild that admitting it asks for
    fill_slots(eng, cfg.vocab_size, max_batch_size)
    eng.decode_step()
    prof = profile_steps(eng.decode_step, profiled_steps)
    split = prof["split"].get((head_dim, 1), 0)
    if split != cfg.n_layer * profiled_steps or \
            prof["combine"] != split or prof["graph_launches"] != \
            profiled_steps or prof["kernel_launches"]:
        raise AssertionError(
            f"serving: over {profiled_steps} steady steps the profiler saw "
            f"{prof}; want {cfg.n_layer * profiled_steps} split passes and "
            f"combines, {profiled_steps} graph launches and no kernel "
            "launched from the host")
    result.update({
        "decode_steps": steps, "prefix_hits":
        counts["serving"]["prefix_hits"], "launches": launches,
        "prefill_buckets": counts["prefill_buckets"],
        "prefill_graphs": counts["prefill_captures_at_warmup"],
        "device_launches": device,
        "decode_launches": counts["device"][(dtype, head_dim, 1)],
        "fastpath": counts["fastpath"], "graph_captures": 1,
        "profiled_steps": profiled_steps,
        "profiled": {"split_passes": split, "combines": prof["combine"],
                     "kernels_per_step": prof["kernels"] / profiled_steps,
                     "graph_launches": prof["graph_launches"],
                     "host_kernel_launches": prof["kernel_launches"]}})
    log(f"{what}: " + json.dumps(result))
    plain = {"tokens": [h.tokens for h in handles],
             "greedy": [not o.get("temperature") for _, o in
                        serving_requests(cfg.vocab_size, n=n_requests)],
             "weights_sum": weights_sum(model)}
    del srv, eng, model
    free_memory()
    return result, plain


def _spec_run(engine, prompt, n, **opts):
    out = [engine.prefill(0, prompt, **opts)]
    step = getattr(engine, "decode_step_spec", None)
    while len(out) < n:
        out.extend(step()[0] if step else [int(engine.decode_step()[0])])
    engine.release(0)
    return out[:n]


def phase_parity(dev, preset="gpt3-1.3B", n_layer=2, steps=8,
                 tol=(1e-3, 1e-3), draft_k=4, spec_tokens=24,
                 zero_gate=False, **cfg_over):
    """One request through a kernel engine and a plain engine sharing one
    float32 model, both replaying their captured steps. Tolerance: float32
    reduction order (kernel vs gather) carried through two layers and the
    50304-wide LM head. Then speculative engines against plain decode on
    the same model: a twin drafter (the same weights) must have every
    draft accepted, and an independent 1-layer drafter must leave the
    tokens as they are; greedy and sampled. ``cfg_over`` may make the
    models MoE (``MOE``), with every gate weight zeroed under
    ``zero_gate``."""
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import DraftVerifyEngine, GenerationEngine

    cfg = GPTConfig.preset(preset, n_layer=n_layer, dtype="float32",
                           **cfg_over)

    def build(seed, layers=n_layer):
        model = build_gpt(dev, seed, preset, n_layer=layers,
                          dtype="float32", **cfg_over)
        return zero_gates(model) if zero_gate else model

    model = build(1)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               333).tolist()
    kinds = ("cuda", "torch")
    engines = [GenerationEngine(model, max_batch_size=2, rng_seed=0,
                                paged_kernel=k, device=dev) for k in kinds]
    toks = [[e.prefill(0, prompt, seed=0)] for e in engines]
    max_err = 0.0
    for _ in range(steps):
        for e, tk in zip(engines, toks):
            tk.append(int(e.decode_step()[0]))
        a, b = (e.last_logits[0] for e in engines)
        max_err = max(max_err, check_close(a, b, tol, "decode logits"))
    if toks[0] != toks[1]:
        raise AssertionError(f"parity: greedy tokens differ {toks}")
    if not all(e._decode_graph.captured for e in engines):
        raise AssertionError("parity: an engine did not capture its step")
    for e in engines:
        e.release(0)
    what = (f"{'zeroed-gate ' if zero_gate else ''}MoE "
            if cfg.moe_num_experts else "")
    log(f"parity: {what}{kinds[0]} vs {kinds[1]} engine (CUDA graphs), "
        f"{cfg.n_layer} layers d_model {cfg.d_model} float32, {steps} "
        f"decode steps: max |logit err| {max_err:.3e} (tol {tol}), greedy "
        "tokens equal")

    plain = engines[0]
    drafters = {"twin": build(1), "independent 1-layer": build(2, 1)}
    spec = {}
    for name, drafter in drafters.items():
        eng = DraftVerifyEngine(model, drafter, draft_k=draft_k,
                                max_batch_size=2, rng_seed=0, device=dev)
        for opts in (dict(seed=0), dict(seed=3, temperature=0.8,
                                        top_p=0.9)):
            c0 = registry.counters("serving")
            got = _spec_run(eng, prompt, spec_tokens, **opts)
            c1 = registry.counters("serving")
            want = _spec_run(plain, prompt, spec_tokens, **opts)
            if got != want:
                raise AssertionError(f"parity: spec ({name} drafter, "
                                     f"{opts}) tokens {got} != plain {want}")
            acc = (c1["spec_accepted"] - c0["spec_accepted"]) / (
                c1["spec_proposed"] - c0["spec_proposed"])
            spec[f"{name} {'greedy' if len(opts) == 1 else 'sampled'}"] = acc
            if name == "twin" and acc != 1.0:
                raise AssertionError(f"parity: twin drafter acceptance "
                                     f"{acc}, want 1.0 ({opts})")
        eng.pool.audit()
        eng.draft_pool.audit()
    log(f"parity: spec engines (K={draft_k}, CUDA graphs) against plain "
        f"decode, {spec_tokens} tokens each: tokens equal; acceptance "
        + ", ".join(f"{k} {v:.3f}" for k, v in spec.items()))
    del engines, plain, eng, drafters, model
    free_memory()
    return max_err


def spec_plain_match(spec_tokens, plain):
    """How far the spec phase's greedy requests follow phase 4's plain
    decode on the same prompts and weights: requests equal, and tokens
    before each request's first difference. (Sampled requests are left
    out: each server draws its own base key.) In bf16 the verify's logits
    (M = B (K+1) rows, K4's 8-row instance) may differ in the last bits
    from decode's (M = B, the 1-row instance), so this is reported, not
    asserted; float32 equality is phase 5's."""
    pairs = [(a, b) for a, b, g in zip(spec_tokens, plain["tokens"],
                                       plain["greedy"]) if g]
    same = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 len(a)) for a, b in pairs]
    return {"greedy_requests": len(pairs),
            "requests_equal": sum(a == b for a, b in pairs),
            "tokens": sum(len(a) for a, _ in pairs),
            "tokens_before_first_difference": sum(same)}


def phase_spec_serving(dev, plain, preset="gpt3-1.3B",
                       draft_preset="gpt2-small", dtype="bfloat16",
                       draft_k=4, max_batch_size=8, block_size=16,
                       n_requests=16, profiled_rounds=3, **cfg_over):
    """Speculative serving at full width: the target verifies through K4 at
    a span of K + 1 rows, the drafter proposes through K4 at one row.
    ``plain``: phase 4's tokens on the same requests and target. The
    drafter's prompt ingestion replays one graph per bucket: each bucket
    the mix used is captured once, at warm-up, and its replay equals its
    body called directly (``check_draft_buckets``)."""
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel)
    from paddle_tpu_torch.serving import GenerationServer

    cfg = GPTConfig.preset(preset, dtype=dtype, **cfg_over)
    dcfg = GPTConfig.preset(draft_preset, seq_len=cfg.seq_len, dtype=dtype)
    t0 = time.perf_counter()
    model = GPTForPretraining(GPTModel(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0)))
    drafter = GPTForPretraining(GPTModel(
        dcfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(2)))
    srv = GenerationServer(model, draft_model=drafter, draft_k=draft_k,
                           max_batch_size=max_batch_size,
                           block_size=block_size, max_queue_size=64,
                           device=dev)
    eng = srv.engine
    what = "moe spec" if cfg.moe_num_experts else "spec"
    log(f"{what}: {preset} {dtype} verifying, {draft_preset} drafting "
        f"(n_layer={dcfg.n_layer}, seed 2), K={draft_k}, built in "
        f"{time.perf_counter() - t0:.1f} s; paged kernels "
        f"{eng.paged_kernel!r} / {eng._draft_kernel!r}")
    try:
        handles, wall, counts, result = serve(
            srv, serving_requests(cfg.vocab_size, n=n_requests),
            cfg.vocab_size)
    finally:
        srv.shutdown()
    check_fast_path(what, counts, captures=2)
    # (the CPU, where the script is rehearsed, runs the bodies directly)
    on_card = dev.type == "cuda"
    if counts["draft_prefill_captures_at_warmup"] != \
            len(eng._draft_buckets) * on_card or \
            counts["serving"]["draft_prefill_compiles"] or \
            not all(pb.graph.captured == on_card
                    for pb in eng._draft_buckets.values()):
        raise AssertionError(
            f"{what}: {counts['draft_prefill_captures_at_warmup']} drafter "
            f"prefill graphs captured at warm-up and "
            f"{counts['serving']['draft_prefill_compiles']} after it, for "
            f"the drafter's buckets {sorted(eng._draft_buckets)}")
    draft_buckets = check_draft_buckets(eng, cfg.vocab_size)
    sc = counts["serving"]
    rounds = sc["spec_rounds"]
    verifies = counts["replays"]["_verify_graph"]
    per_round = cfg.n_layer + (draft_k + 1) * dcfg.n_layer
    launches = counts["kernels"]
    if rounds == 0 or rounds != verifies or \
            launches["paged_attention"] != rounds * per_round or \
            launches["paged_attention_ref"]:
        raise AssertionError(
            f"spec: {launches} kernel launches for {rounds} rounds "
            f"({verifies} verify replays) x ({cfg.n_layer} + "
            f"{draft_k + 1} x {dcfg.n_layer})")
    head_dim = cfg.d_model // cfg.n_head
    verify_key = (dtype, head_dim, 8)
    draft_key = (dtype, dcfg.d_model // dcfg.n_head, 1)
    device = check_device_launches("spec", counts, {
        verify_key: rounds * cfg.n_layer,
        draft_key: rounds * (draft_k + 1) * dcfg.n_layer})
    eng.pool.audit()
    eng.draft_pool.audit()
    if weights_sum(model) != plain["weights_sum"]:
        raise AssertionError("spec: the target's weights differ from phase "
                             "4's, so its tokens cannot be compared")
    match = spec_plain_match([h.tokens for h in handles], plain)

    fill_slots(eng, cfg.vocab_size, max_batch_size)
    eng.decode_step_spec()
    prof = profile_steps(eng.decode_step_spec, profiled_rounds)
    want = {(head_dim, 8): cfg.n_layer * profiled_rounds,
            (dcfg.d_model // dcfg.n_head, 1):
            (draft_k + 1) * dcfg.n_layer * profiled_rounds}
    if prof["split"] != want or prof["graph_launches"] != \
            2 * profiled_rounds or prof["kernel_launches"]:
        raise AssertionError(
            f"spec: over {profiled_rounds} rounds the profiler saw {prof}; "
            f"want split passes {want} ((Dh, rows of the instance): the "
            f"verify's span of {draft_k + 1} rows takes the 8-row "
            "instance), two graph launches a round and no kernel launched "
            "from the host")
    for slot in range(max_batch_size):
        eng.release(slot)
    eng.pool.audit()
    eng.draft_pool.audit()
    result.update({
        "draft_k": draft_k, "rounds": rounds,
        "acceptance": sc["spec_accepted"] / sc["spec_proposed"],
        "emitted_per_round": sc["spec_emitted"] / rounds,
        "emitted_per_slot_round": sc["spec_emitted"] / sc["spec_slot_rounds"],
        "round_p50_ms": result.pop("decode_step_p50_ms"),
        "launches": launches, "device_launches": device,
        "verify_launches": counts["device"][verify_key],
        "plain_match": match, "draft_prefill_buckets": draft_buckets,
        "fastpath": counts["fastpath"], "graph_captures": 2,
        "profiled_rounds": profiled_rounds,
        "profiled": {"split_passes": {f"Dh={k[0]} rows={k[1]}": v
                                      for k, v in prof["split"].items()},
                     "kernels_per_round": prof["kernels"] / profiled_rounds,
                     "graph_launches": prof["graph_launches"],
                     "host_kernel_launches": prof["kernel_launches"]}})
    log(f"{what}: " + json.dumps(result))
    del srv, eng, model, drafter
    free_memory()
    return result


def check_draft_buckets(eng, vocab):
    """Each captured drafter prefill bucket of a spec engine, replayed on a
    prompt of its own length: the drafter's K/V rows after the replay
    must equal those of the same body called directly on the same
    buffers, bitwise, with no capture. Returns the buckets and their
    replays."""
    from paddle_tpu_torch.profiler import registry

    c0 = registry.counters("serving")["draft_prefill_compiles"]
    rng = np.random.default_rng(6)
    for L in sorted(eng._draft_buckets):
        pb = eng._draft_buckets[L]
        eng.prefill(0, rng.integers(0, vocab, L - 1).tolist(), seed=L,
                    max_new_tokens=1)
        idx = torch.tensor(eng._draft_blocks[0], device=eng.device)
        graph_kv = [(k[idx].clone(), v[idx].clone()) for k, v in eng._dkv]
        with torch.no_grad():
            pb.body()
        if not all(torch.equal(k[idx], gk) and torch.equal(v[idx], gv)
                   for (k, v), (gk, gv) in zip(eng._dkv, graph_kv)):
            raise AssertionError(
                f"drafter prefill bucket {L}: the graph's K/V rows differ "
                "from the direct body's")
        eng.release(0)
        del graph_kv
    if registry.counters("serving")["draft_prefill_compiles"] != c0:
        raise AssertionError("drafter prefill buckets: a replay captured")
    return {L: pb.graph.replays for L, pb in
            sorted(eng._draft_buckets.items())}


# ------------------------------------------------ weight swap and retry --
def reference_state(model):
    """``model``'s trunk state as the reference's checkpoints hold it:
    float32 numpy in the reference's names, Linear weights ``[in, out]``."""
    from paddle_tpu_torch import convert

    return {k: v.to(torch.float32, memory_format=torch.contiguous_format)
            .cpu().numpy()
            for k, v in convert.state_to_paddle_tpu(model.gpt).items()}


def greedy_requests(vocab, seed):
    """The 8 greedy requests of ``serving_requests(vocab, seed=seed)``."""
    return [(p, dict(max_new_tokens=o["max_new_tokens"], seed=o["seed"]))
            for p, o in serving_requests(vocab, seed=seed)
            if not o.get("temperature")]


def run_sync(sched, reqs, step_s=None):
    """Submit ``reqs`` and step ``sched`` on this thread until it is idle;
    every request must finish with all its tokens. Returns the tokens;
    ``step_s`` collects each step's wall time."""
    from paddle_tpu_torch.serving import GenerationRequest

    handles = [sched.submit(GenerationRequest(p, **o)) for p, o in reqs]
    while sched.has_work():
        t = time.perf_counter()
        sched.step()
        if step_s is not None:
            step_s.append(time.perf_counter() - t)
    bad = [h for h in handles if h.status != "done"
           or len(h.tokens) != h.max_new_tokens]
    if bad:
        raise AssertionError(f"unfinished requests {bad}")
    return [h.tokens for h in handles]


class DecodeFaults:
    """Test code: raise from ``engine._finish_decode`` on chosen calls, that
    is after the step's graph replay has advanced the device cursors and
    before the host mirrors advance."""

    def __init__(self, engine):
        self.calls = 0
        self.at = set()
        self._orig = engine._finish_decode
        engine._finish_decode = self

    def arm(self, *offsets):
        self.at = {self.calls + k for k in offsets}

    def __call__(self, *args):
        self.calls += 1
        if self.calls in self.at:
            raise RuntimeError(f"injected decode fault (call {self.calls})")
        return self._orig(*args)


def swap_timings():
    from paddle_tpu_torch.profiler import registry

    t = registry.timings("serving")
    return {k: t.get(f"serving.swap_{k}", {"total_s": 0.0})["total_s"]
            for k in ("stage", "commit")}


def _p50(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] * 1e3 if xs else None


def phase_swap(dev, preset="gpt3-1.3B", dtype="bfloat16", max_batch_size=8,
               block_size=16, n_requests=16, swap_after=40):
    """4c: phase 4's mix on weights A (seed 0) with a swap to B (seed 1),
    given as a reference-layout numpy state, staged after ``swap_after``
    decode steps (every request admitted, the second wave mid-decode);
    then a refused swap. 4d: a fault after the graph replay, retried, and
    two in a row. The scheduler is driven on this thread, step by step."""
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel)
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import GenerationRequest, GenerationServer

    cfg = GPTConfig.preset(preset, dtype=dtype)

    def build(seed):
        return GPTForPretraining(GPTModel(
            cfg, device=dev,
            generator=torch.Generator(device=dev).manual_seed(seed)))

    def server(model):
        return GenerationServer(model, max_batch_size=max_batch_size,
                                block_size=block_size, max_queue_size=64,
                                device=dev)

    model_b = build(1)
    state_b = reference_state(model_b)
    srv = server(build(0))
    sched, eng = srv.scheduler, srv.engine
    run_sync(sched, [(list(range(1, 40)), dict(max_new_tokens=4))])

    # 4c: the swap lands between two decode steps of the served mix
    c0, t0 = registry.counters("serving"), swap_timings()
    k0 = registry.counters("kernels")["paged_attention"]
    pa.reset_device_launches()
    handles = [sched.submit(GenerationRequest(p, **o))
               for p, o in serving_requests(cfg.vocab_size, n=n_requests)]
    steps, staged, active_at_swap = [], False, None
    while sched.has_work():
        c = registry.counters("serving")
        if not staged and c["decode_steps"] - c0["decode_steps"] \
                >= swap_after:
            sched.request_swap(state_b, source="chip_smoke phase 4c")
            staged, active_at_swap = True, sched.active()
        prefills, swaps = c["prefills"], sched.swap_count
        t = time.perf_counter()
        sched.step()
        steps.append((time.perf_counter() - t,
                      registry.counters("serving")["prefills"] != prefills,
                      sched.swap_count != swaps))
    c1, t1 = registry.counters("serving"), swap_timings()
    device = pa.device_launches()
    k1 = registry.counters("kernels")["paged_attention"]
    n_steps = c1["decode_steps"] - c0["decode_steps"]
    bad = [h for h in handles if h.status != "done"
           or len(h.tokens) != h.max_new_tokens]
    if bad or c1["requests_failed"] != c0["requests_failed"]:
        raise AssertionError(f"swap: failed requests {bad}")
    if c1["weight_swaps"] != c0["weight_swaps"] + 1 or \
            c1["swap_failures"] != c0["swap_failures"] or not active_at_swap:
        raise AssertionError(
            f"swap: weight_swaps {c0['weight_swaps']} -> "
            f"{c1['weight_swaps']}, swap_failures {c0['swap_failures']} -> "
            f"{c1['swap_failures']}, {active_at_swap} requests in flight")
    if c1["decode_compiles"] != c0["decode_compiles"]:
        raise AssertionError("swap: the decode graph was recaptured")
    check_device_launches(
        "swap", {"device": device, "kernels": {"paged_attention": k1 - k0}},
        {(dtype, cfg.d_model // cfg.n_head, 1): n_steps * cfg.n_layer})
    at = next(i for i, (_, _, sw) in enumerate(steps) if sw)
    steady = [(i, dt) for i, (dt, pf, sw) in enumerate(steps)
              if not pf and not sw]
    result = {
        "decode_steps": n_steps, "decode_steps_before_swap": sum(
            1 for i, _ in steady if i < at),
        "requests_in_flight_at_swap": active_at_swap,
        "swap_stage_s": t1["stage"] - t0["stage"],
        "swap_commit_s": t1["commit"] - t0["commit"],
        "step_with_swap_ms": steps[at][0] * 1e3,
        "steady_step_p50_ms_before": _p50([dt for i, dt in steady
                                           if i < at]),
        "steady_step_p50_ms_after": _p50([dt for i, dt in steady
                                          if i > at]),
        "k4_launches": {instance_name(k): v for k, v in device.items()}}

    # the swapped server against a fresh one built on B; new prompts each
    # time, so neither server finds them in its prefix cache
    fresh = server(model_b)
    want = {s: run_sync(fresh.scheduler, greedy_requests(cfg.vocab_size, s))
            for s in (1, 2, 3)}
    del fresh
    if run_sync(sched, greedy_requests(cfg.vocab_size, 1)) != want[1]:
        raise AssertionError("swap: greedy tokens after the swap differ "
                             "from a fresh server's on the new weights")
    bad_state = dict(state_b)
    name = "blocks.0.attn.qkv_proj.weight"
    bad_state[name] = bad_state[name][:-1]
    c2 = registry.counters("serving")
    sched.request_swap(bad_state, source="chip_smoke phase 4c (truncated)")
    if run_sync(sched, greedy_requests(cfg.vocab_size, 2)) != want[2]:
        raise AssertionError("swap: a refused swap changed the tokens")
    c3 = registry.counters("serving")
    if c3["swap_failures"] != c2["swap_failures"] + 1 or \
            c3["weight_swaps"] != c2["weight_swaps"]:
        raise AssertionError(f"swap: a truncated weight was not refused "
                             f"({c2} -> {c3})")
    result["refused_swap"] = repr(sched.last_swap_error)[:160]
    log("swap: " + json.dumps(result))

    # 4d: one fault after the replay is retried on a recaptured graph
    faults = DecodeFaults(eng)
    faults.arm(6)
    c4 = registry.counters("serving")
    step_s = []
    got = run_sync(sched, greedy_requests(cfg.vocab_size, 3), step_s)
    c5 = registry.counters("serving")
    moved = {k: c5[k] - c4[k] for k in ("step_retries", "reprimes",
                                        "decode_compiles",
                                        "requests_failed")}
    # (the card captures graphs; the CPU, where the script is rehearsed,
    # runs the step body directly)
    if moved != {"step_retries": 1, "reprimes": 1,
                 "decode_compiles": int(dev.type == "cuda"),
                 "requests_failed": 0}:
        raise AssertionError(f"retry: counters moved {moved}")
    if got != want[3]:
        raise AssertionError("retry: tokens after the retry differ from an "
                             "unfaulted run's")
    # two in a row fail the batch, through the server's worker loop
    faults.arm(3, 4)
    srv.start()
    try:
        hs = [srv.submit(p, **o)
              for p, o in greedy_requests(cfg.vocab_size, 4)]
        for h in hs:
            h.result(timeout=600)
    finally:
        srv.shutdown(timeout=600)
    if any(h.status != "error" for h in hs) or \
            "injected decode fault" not in str(srv.last_error):
        raise AssertionError(f"retry: two faults in a row left {hs}, "
                             f"last error {srv.last_error!r}")
    retry = {"counters_moved": moved, "tokens_equal_unfaulted": True,
             "retried_step_ms": max(step_s[1:]) * 1e3,
             "other_steps_p50_ms": _p50(sorted(step_s[1:])[:-1]),
             "second_fault": repr(srv.last_error)[:120],
             "failed_requests": len(hs)}
    log("retry: " + json.dumps(retry))
    del srv, sched, eng, model_b, state_b, faults
    free_memory()
    return result, retry


def phase_spec_swap(dev, preset="gpt3-1.3B", draft_preset="gpt2-small",
                    n_layer=2, draft_k=4, n_tokens=24, n_bf16=4):
    """5c: a ``DraftVerifyEngine`` whose target and drafter swap together
    in the middle of a stream, against plain decode under the same swap.
    float32 at 2 layers (twin drafters, from the target's seed): the
    tokens must be equal. Then bf16 at full width (gpt2-small drafting),
    one stream per greedy prompt, swapped A -> B mid-stream and back
    between streams: the match is reported."""
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel)
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import DraftVerifyEngine, GenerationEngine

    def build(seed, preset=preset, **over):
        return GPTForPretraining(GPTModel(
            GPTConfig.preset(preset, **over), device=dev,
            generator=torch.Generator(device=dev).manual_seed(seed)))

    def stream(engine, prompt, n, swap, swap_at, logits=None):
        """Greedy ``prompt``; ``swap(engine)`` once ``swap_at(tokens)``.
        ``logits`` collects a plain engine's logits of each decode step."""
        spec = getattr(engine, "decode_step_spec", None)
        out, at = [engine.prefill(0, prompt, seed=0)], None
        while len(out) < n:
            if at is None and swap_at(out):
                swap(engine)
                at = len(out)
            if spec:
                out.extend(spec()[0])
                continue
            out.append(int(engine.decode_step()[0]))
            if logits is not None:
                logits.append(engine.last_logits[0].clone())
        engine.release(0)
        return out, at

    def first_difference(got, want, logits):
        """Index of the first differing token, and there the plain logits'
        margin of plain decode's token over the spec engine's."""
        i = next((i for i, (x, y) in enumerate(zip(got, want)) if x != y),
                 None)
        if i is None:
            return len(got), None
        row = logits[i - 1]
        return i, float(row[want[i]] - row[got[i]])

    f32 = dict(n_layer=n_layer, dtype="float32")
    state_b = build(3, **f32).state_dict()
    eng = DraftVerifyEngine(build(1, **f32), build(1, **f32),
                            draft_k=draft_k, max_batch_size=2, rng_seed=0,
                            device=dev)
    prompt = np.random.default_rng(1).integers(
        0, eng._gpt.cfg.vocab_size, 333).tolist()
    c0 = registry.counters("serving")
    rounds = []
    got, at = stream(eng, prompt, n_tokens,
                     lambda e: e.swap_weights(state_b, draft_state=state_b),
                     lambda out: rounds.append(1) or len(rounds) > 3)
    c1 = registry.counters("serving")
    plain = GenerationEngine(build(1, **f32), max_batch_size=2, rng_seed=0,
                             device=dev)
    want, _ = stream(plain, prompt, len(got),
                     lambda e: e.swap_weights(state_b),
                     lambda out: len(out) == at)
    gens = eng.acceptance_by_generation()
    if c1["draft_swaps"] != c0["draft_swaps"] + 1 or len(gens) != 2:
        raise AssertionError(f"spec swap: draft_swaps "
                             f"{c1['draft_swaps'] - c0['draft_swaps']}, "
                             f"generations {gens}")
    if got != want:
        raise AssertionError(f"spec swap: tokens {got} != plain decode's "
                             f"{want} under the same swap")
    eng.pool.audit()
    eng.draft_pool.audit()
    result = {"float32": {"tokens": len(got), "swapped_after": at,
                          "tokens_equal": True,
                          "acceptance_by_generation": gens}}
    # the drafter catches up: an independent drafter swapped, mid-stream,
    # to the target's own weights (the target "swapped" to itself). Its KV
    # is rebuilt from the history, so it must now agree with the target
    # on every draft
    state_a = build(1, **f32).state_dict()
    eng = DraftVerifyEngine(build(1, **f32), build(2, **f32),
                            draft_k=draft_k, max_batch_size=2, rng_seed=0,
                            device=dev)
    rounds = []
    got, at = stream(eng, prompt, n_tokens,
                     lambda e: e.swap_weights(state_a, draft_state=state_a),
                     lambda out: rounds.append(1) or len(rounds) > 3)
    plain.swap_weights(state_a)  # back from B
    want, _ = stream(plain, prompt, len(got), None, lambda out: False)
    gens = eng.acceptance_by_generation()
    if got != want or list(gens.values())[-1] != 1.0:
        raise AssertionError(f"spec swap: after the drafter's swap to the "
                             f"target's weights, acceptance {gens} (want "
                             f"1.0 in the new generation) and tokens "
                             f"{'equal' if got == want else 'differ'}")
    result["float32"]["drafter_to_target_acceptance"] = gens
    del eng, plain, state_a, state_b
    free_memory()

    bf = dict(dtype="bfloat16")
    seq = GPTConfig.preset(preset).seq_len
    target, drafter = build(0, **bf), build(2, draft_preset, seq_len=seq,
                                            **bf)
    snap = ({k: v.clone() for k, v in target.state_dict().items()},
            {k: v.clone() for k, v in drafter.state_dict().items()})
    new = (build(1, **bf).state_dict(),
           build(3, draft_preset, seq_len=seq, **bf).state_dict())
    eng = DraftVerifyEngine(target, drafter, draft_k=draft_k,
                            max_batch_size=1, rng_seed=0, device=dev)
    plain = GenerationEngine(build(0, **bf), max_batch_size=1, rng_seed=0,
                             device=dev)
    match, lengths, margins, control = [], [], [], []
    for prompt, opts in greedy_requests(eng._gpt.cfg.vocab_size, 0)[:n_bf16]:
        n = opts["max_new_tokens"]
        rounds, logits = [], []
        got, at = stream(eng, prompt, n,
                         lambda e: e.swap_weights(new[0],
                                                  draft_state=new[1]),
                         lambda out: rounds.append(1) or len(rounds) > 2)
        eng.swap_weights(snap[0], draft_state=snap[1])
        want, _ = stream(plain, prompt, len(got),
                         lambda e: e.swap_weights(new[0]),
                         lambda out: len(out) == at, logits)
        plain.swap_weights(snap[0])
        lengths.append(len(got))
        i, margin = first_difference(got, want, logits)
        match.append(i)
        margins.append(margin)
        # the same stream with no swap: phase 5b's spec-against-plain
        # comparison, one stream at a time
        logits = []
        got, _ = stream(eng, prompt, n, None, lambda out: False)
        want, _ = stream(plain, prompt, len(got), None, lambda out: False,
                         logits)
        control.append(first_difference(got, want, logits))
    eng.pool.audit()
    eng.draft_pool.audit()
    result["bfloat16"] = {
        "streams": len(match), "tokens_before_first_difference": match,
        "streams_equal": sum(m == n for m, n in zip(match, lengths)),
        "logit_margin_at_first_difference": margins,
        "without_swap": control,
        "acceptance_by_generation": eng.acceptance_by_generation()}
    log("spec swap: " + json.dumps(result))
    del eng, plain, target, drafter, snap, new
    free_memory()
    return result


# ---------------------------------------------- prefill→decode handoff --
def build_gpt(dev, seed, preset="gpt3-1.3B", **over):
    """A random model of ``preset`` on the card, its weights from ``seed``."""
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel)

    return GPTForPretraining(GPTModel(
        GPTConfig.preset(preset, **over), device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed)))


class Timed:
    """Test instrumentation: ``obj.name`` replaced by a wrapper that keeps
    each call's host seconds, up to the end of the card's work."""

    def __init__(self, obj, name):
        self.obj, self.name = obj, name
        self._orig = getattr(obj, name)
        self.seconds = []
        setattr(obj, name, self)

    def __call__(self, *args, **kw):
        t = time.perf_counter()
        out = self._orig(*args, **kw)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t)
        return out

    def restore(self):
        delattr(self.obj, self.name)


def export_all(engine, reqs):
    """The prefill side of a handoff: prefill each request in slot 0 of
    ``engine``, export it and release the slot. The prefix cache is
    flushed first, so the prefills hit the prefixes a fresh monolithic
    engine hits on the same sequence: a prefix hit prefills a shorter
    window, whose bf16 rows may round otherwise. Returns the payloads and
    each export's host seconds (the copy to the host synchronises)."""
    engine.prefix_cache.flush()
    payloads, secs = [], []
    for p, o in reqs:
        engine.prefill(0, p, **o)
        t = time.perf_counter()
        payloads.append(engine.export_request_kv(0))
        secs.append(time.perf_counter() - t)
        engine.release(0)
    return payloads, secs


def payload_bytes(payload):
    return sum(t.numel() * t.element_size()
               for t in payload["kv_k"] + payload["kv_v"])


def adopt_all(sched, reqs, payloads, step_ends=None):
    """The decode side: submit ``reqs`` carrying their payloads and step
    ``sched`` on this thread until it is idle; every request must finish
    with all its tokens. ``step_ends`` collects, after each step, the
    monotonic clock and every request's token count. Returns the
    handles."""
    handles = [sched.submit(r) for r in handoff_requests(reqs, payloads)]
    while sched.has_work():
        sched.step()
        if step_ends is not None:
            step_ends.append((time.monotonic(),
                              [len(h.tokens) for h in handles]))
    bad = [h for h in handles if h.status != "done"
           or len(h.tokens) != h.max_new_tokens]
    if bad:
        raise AssertionError(f"unfinished requests {bad}")
    return handles


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def first_difference(got, want):
    """``(request, token)`` of the first difference of two token lists of
    lists, or None."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return i, next((j for j, (x, y) in enumerate(zip(a, b))
                            if x != y), min(len(a), len(b)))
    return None if len(got) == len(want) else (min(len(got), len(want)), 0)


def phase_handoff(dev, preset="gpt3-1.3B", dtype="bfloat16",
                  max_batch_size=8, block_size=16, n_requests=16):
    """4e: disaggregated serving at full width. A prefills each of phase
    4's requests, exports and releases it; B's scheduler adopts the
    payloads and decodes; M, a monolithic engine on the same weights and
    base key as A, serves the same requests. B's key differs on purpose:
    the exported request key must rule. Then a handoff into a spec engine
    and the staleness cases. Returns the result and, for 4f and 4g, the
    engines and the reference tokens."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import (ContinuousBatchScheduler,
                                          GenerationEngine)

    t0 = time.perf_counter()
    model = build_gpt(dev, 0, preset, dtype=dtype)
    cfg = model.gpt.cfg
    ekw = dict(max_batch_size=max_batch_size, block_size=block_size,
               device=dev)
    a = GenerationEngine(model, rng_seed=7, **ekw)
    m = GenerationEngine(model, rng_seed=7, **ekw)
    b = GenerationEngine(build_gpt(dev, 0, preset, dtype=dtype),
                         rng_seed=99, **ekw)
    log(f"handoff: {preset} {dtype}, engines A (prefill, rng_seed 7), B "
        f"(decode, rng_seed 99), M (monolithic, rng_seed 7) built in "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = serving_requests(cfg.vocab_size, n=n_requests)
    want = run_sync(ContinuousBatchScheduler(m, max_queue_size=64), reqs)
    sched = ContinuousBatchScheduler(b, max_queue_size=64)
    warm = [(list(range(1, 40)), dict(max_new_tokens=4, seed=99))]
    adopt_all(sched, warm, export_all(a, warm)[0])  # captures B's graph

    payloads, export_s = export_all(a, reqs)
    for scope in ("kernels", "serving", "fastpath"):
        registry.reset(scope)
    pa.reset_device_launches()
    imports = Timed(b, "import_request_kv")
    t = time.perf_counter()
    try:
        handles = adopt_all(sched, reqs, payloads)
    finally:
        imports.restore()
    wall = time.perf_counter() - t
    c = registry.counters("serving")
    got = [h.tokens for h in handles]
    diff = first_difference(got, want)
    if diff is not None:
        raise AssertionError(f"handoff: B's tokens differ from M's at "
                             f"(request, token) {diff}")
    moved = {k: c[k] for k in ("prefills", "handoff_imports",
                               "handoff_stale", "requests_completed",
                               "decode_compiles", "prefill_compiles")}
    if moved != {"prefills": 0, "handoff_imports": n_requests,
                 "handoff_stale": 0, "requests_completed": n_requests,
                 "decode_compiles": 0, "prefill_compiles": 0}:
        raise AssertionError(f"handoff: B's counters moved {moved}")
    for e in (a, b, m):
        e.pool.audit()
    short = [i for i, (p, _) in enumerate(reqs)
             if len(b.prefix_cache.match(p)) != len(p) // block_size]
    if short:
        raise AssertionError(f"handoff: B's prefix cache lacks the full "
                             f"blocks of requests {short}")
    steps = c["decode_steps"]
    device = check_device_launches(
        "handoff", {"device": pa.device_launches(),
                    "kernels": registry.counters("kernels")},
        {(dtype, cfg.d_model // cfg.n_head, 1): steps * cfg.n_layer})
    nbytes = [payload_bytes(p) for p in payloads]
    ttft = sorted(h.ttft_s for h in handles)
    result = {
        "requests": n_requests, "tokens_equal_monolithic": True,
        "greedy_and_sampled": True, "decode_steps": steps,
        "k4_launches": device, "payload_mb_p50": _median(nbytes) / 1e6,
        "payload_mb_max": max(nbytes) / 1e6,
        "export_ms_p50": _p50(export_s), "import_ms_p50": _p50(
            imports.seconds),
        "export_gb_s": sum(nbytes) / sum(export_s) / 1e9,
        "import_gb_s": sum(nbytes) / sum(imports.seconds) / 1e9,
        "ttft_p50_ms": ttft[len(ttft) // 2] * 1e3,
        "decode_step_p50_ms":
            registry.timings("serving")["serving.decode_step"]["p50_ms"],
        "tokens_per_s": sum(map(len, got)) / wall}
    log("handoff: " + json.dumps(result))
    result["spec"] = phase_spec_handoff(dev, preset)
    model_1 = build_gpt(dev, 1, preset, dtype=dtype)
    result["stale"] = phase_stale_handoff(dev, a, model, model_1, reqs,
                                          want, ekw, preset, dtype)
    return result, {"a": a, "b": b, "model": model, "model_1": model_1,
                    "reqs": reqs, "want": want,
                    "decode_step_p50_ms": result["decode_step_p50_ms"]}


def phase_spec_handoff(dev, preset, n_layer=2, draft_k=4, n_tokens=24):
    """4e, spec: a plain engine's export adopted by a ``DraftVerifyEngine``
    (float32, ``n_layer`` layers at full width, a twin drafter): its tokens
    equal plain decode's, greedy and sampled, and the drafter, which
    ingests the prompt again, has every draft accepted."""
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import DraftVerifyEngine, GenerationEngine

    target = build_gpt(dev, 1, preset, n_layer=n_layer, dtype="float32")
    plain = GenerationEngine(target, max_batch_size=2, rng_seed=7,
                             device=dev)
    spec = DraftVerifyEngine(
        target, build_gpt(dev, 1, preset, n_layer=n_layer, dtype="float32"),
        draft_k=draft_k, max_batch_size=2, rng_seed=99, device=dev)
    prompt = np.random.default_rng(1).integers(
        0, target.gpt.cfg.vocab_size, 333).tolist()
    out = {}
    for opts in (dict(seed=0), dict(seed=3, temperature=0.8, top_p=0.9)):
        want = _spec_run(plain, prompt, n_tokens, **opts)
        payload = export_all(plain, [(prompt, opts)])[0][0]
        c0 = registry.counters("serving")
        got = [spec.import_request_kv(0, payload, prompt_ids=prompt)]
        while len(got) < n_tokens:
            got.extend(spec.decode_step_spec()[0])
        spec.release(0)
        c1 = registry.counters("serving")
        if got[:n_tokens] != want:
            raise AssertionError(f"handoff: spec tokens {got} != plain "
                                 f"decode's {want} ({opts})")
        acc = (c1["spec_accepted"] - c0["spec_accepted"]) / (
            c1["spec_proposed"] - c0["spec_proposed"])
        if acc != 1.0:
            raise AssertionError(f"handoff: twin drafter acceptance {acc}")
        out["sampled" if len(opts) > 1 else "greedy"] = "equal"
    spec.pool.audit()
    spec.draft_pool.audit()
    log(f"handoff: spec engine ({n_layer} layers float32, twin drafter, "
        f"K={draft_k}) adopting a plain engine's export: {n_tokens} tokens "
        f"equal plain decode's, {out}, acceptance 1.0")
    return out


def phase_stale_handoff(dev, a, model, model_1, reqs, want, ekw, preset,
                        dtype):
    """4e, staleness, on a decode engine D of its own (seed-0 weights,
    rng_seed 99) against exports from A: a re-prime on D alone leaves
    the weight generation and the handoff is adopted; a swap on D (to
    seed-1 weights) between an export and its import gets the payload
    refused and prefilled again on D, with the tokens of a fresh engine
    on seed-1 weights; a re-prime on A followed by a swap on D (back to
    seed 0) is refused too."""
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import (ContinuousBatchScheduler,
                                          GenerationEngine, StaleHandoffError)

    two = reqs[:2]  # one greedy, one sampled
    d = GenerationEngine(build_gpt(dev, 0, preset, dtype=dtype),
                         rng_seed=99, **ekw)
    fresh = run_sync(ContinuousBatchScheduler(
        GenerationEngine(model_1, rng_seed=99, **ekw)), two)

    def adopt(payloads):
        c0 = registry.counters("serving")
        got = [h.tokens for h in adopt_all(ContinuousBatchScheduler(d),
                                           two, payloads)]
        c1 = registry.counters("serving")
        return got, {k: c1[k] - c0[k] for k in (
            "handoff_imports", "handoff_stale", "prefills")}

    out = {}
    d.reprime()
    got, moved = adopt(export_all(a, two)[0])
    if got != want[:2] or moved != {"handoff_imports": 2,
                                    "handoff_stale": 0, "prefills": 0}:
        raise AssertionError(f"stale: after a re-prime on D: {moved}, "
                             f"tokens equal M's: {got == want[:2]}")
    out["reprime_on_decode_side"] = "adopted"
    payloads = export_all(a, two)[0]
    d.swap_weights({k: v.detach() for k, v in
                    model_1.gpt.state_dict().items()})
    got, moved = adopt(payloads)
    if got != fresh or moved != {"handoff_imports": 0, "handoff_stale": 2,
                                 "prefills": 2}:
        raise AssertionError(f"stale: a swap between export and import: "
                             f"{moved}, tokens equal a fresh engine's on "
                             f"the new weights: {got == fresh}")
    out["swap_between_export_and_import"] = \
        "refused, prefilled again, tokens equal a fresh engine's"
    a.reprime()
    payload = export_all(a, two[:1])[0][0]
    d.swap_weights({k: v.detach() for k, v in model.gpt.state_dict().items()})
    try:
        d.import_request_kv(0, payload, prompt_ids=two[0][0])
    except StaleHandoffError:
        out["reprime_on_prefill_side_then_swap"] = "refused"
    else:
        raise AssertionError("stale: a payload exported after a re-prime "
                             "on A was adopted by D after a swap")
    d.pool.audit()
    log("handoff (staleness): " + json.dumps(out))
    return out


# ------------------------------------------------------- prefill graphs --
def host_and_device_ms(fn, n=5):
    """Median host milliseconds (to the end of the card's work) and device
    milliseconds (CUDA events) of ``n`` calls of ``fn``."""
    host, device = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
        device.append(e0.elapsed_time(e1))
    return sorted(host)[n // 2], sorted(device)[n // 2]


def phase_prefill_graphs(dev, model, max_batch_size=8, block_size=16):
    """4f: one prompt per bucket (16..2048) on a fresh engine: one graph
    captured per bucket; the replay's first token and K/V rows equal
    those of the same body called directly on the same input buffers,
    bitwise; each timed both ways; the graphs' shared pool measured."""
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import GenerationEngine

    eng = GenerationEngine(model, max_batch_size=max_batch_size,
                           block_size=block_size, rng_seed=7, device=dev)
    vocab = model.gpt.cfg.vocab_size
    rng = np.random.default_rng(4)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_stats(dev)
    c0 = registry.counters("serving")["prefill_compiles"]
    rows = {}
    for L in eng.buckets:
        prompt = rng.integers(0, vocab, L - 1).tolist()
        tok = eng.prefill(0, prompt, seed=L, temperature=0.8, top_p=0.9,
                          max_new_tokens=1)
        pb = eng._prefill_buckets[L]
        idx = torch.tensor(eng._slot_blocks[0], device=dev)

        def kv_rows():
            return [(k[idx].clone(), v[idx].clone()) for k, v in eng._kv]

        graph_kv = kv_rows()
        with torch.no_grad():
            pb.body()  # the same body, called directly on the buffers
        direct_tok, direct_kv = int(pb.token.item()), kv_rows()
        if direct_tok != tok or not all(
                torch.equal(x, y) for g, d in zip(graph_kv, direct_kv)
                for x, y in zip(g, d)):
            raise AssertionError(
                f"prefill graphs: bucket {L}: the graph's token {tok} and "
                f"K/V rows against the direct call's {direct_tok}: not "
                "bitwise equal")
        graph_ms = host_and_device_ms(pb.graph)
        direct_ms = host_and_device_ms(pb.body)
        rows[L] = {"graph_host_ms": graph_ms[0],
                   "graph_device_ms": graph_ms[1],
                   "direct_host_ms": direct_ms[0],
                   "direct_device_ms": direct_ms[1]}
        eng.release(0)
        del graph_kv, direct_kv
    captures = registry.counters("serving")["prefill_compiles"] - c0
    # (the CPU, where the script is rehearsed, runs the bodies directly)
    if captures != len(eng.buckets) * (dev.type == "cuda") or \
            sorted(eng._prefill_buckets) != list(eng.buckets):
        raise AssertionError(f"prefill graphs: {captures} captures for "
                             f"the buckets {eng.buckets}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    m1 = torch.cuda.memory_stats(dev)
    key = "reserved_bytes.all.current"
    result = {"buckets": list(eng.buckets), "captures": captures,
              "bitwise_equal_direct": True, "per_bucket": rows,
              "graph_pool_reserved_mb": (m1[key] - m0[key]) / 1e6,
              "reserved_before_mb": m0[key] / 1e6,
              "reserved_after_mb": m1[key] / 1e6}
    log("prefill graphs: " + json.dumps(result))
    del eng
    free_memory()
    return result


# ------------------------------------ traces, histograms, fault points --
class RouteRecorder:
    """Test instrumentation: the model's K4 route calls made while a CUDA
    graph captures, as (arguments, output). The tensors stay referenced,
    so the graph's replays rewrite them in place."""

    def __init__(self):
        from paddle_tpu_torch.models import gpt

        self._mod, self._orig = gpt, gpt.paged_attention_route
        self.calls = []
        gpt.paged_attention_route = self

    def __call__(self, kernel, *args, **kw):
        out = self._orig(kernel, *args, **kw)
        if torch.cuda.is_current_stream_capturing():
            self.calls.append((args, out))
        return out

    def restore(self):
        self._mod.paged_attention_route = self._orig


def hist_index(ms):
    """The histogram bucket a duration of ``ms`` falls in."""
    from paddle_tpu_torch.profiler import registry

    return math.frexp(ms / 1e3)[1] - registry.HIST_EMIN


def token_gaps(step_ends):
    """Each request's gaps between consecutive tokens, from the clock read
    after each step (the scheduler stamps a step's tokens with one clock
    read). A step that gave a request two tokens (its admission and its
    first decode) hides the gap between them, which is left out."""
    gaps = []
    for r in range(len(step_ends[0][1])):
        last = None
        for t, counts in step_ends:
            n = counts[r] - (last[1] if last else 0)
            if n and last is not None and last[1]:
                gaps.append(t - last[0])
            if n:
                last = (t, counts[r])
    return gaps


def phase_observability(dev, ctx, n_layer=2):
    """4g: traces, histograms and the serving fault points at full width
    on 4e's engines A and B (``ctx``), every fault disarmed in a
    ``finally``."""
    from paddle_tpu_torch.profiler import registry, tracing
    from paddle_tpu_torch.serving import (ContinuousBatchScheduler,
                                          DraftVerifyEngine, GenerationEngine,
                                          GenerationServer)
    from paddle_tpu_torch.testing import faults

    a, b, reqs, want = ctx["a"], ctx["b"], ctx["reqs"], ctx["want"]
    greedy = [i for i, (_, o) in enumerate(reqs) if not o.get("temperature")]
    out = {}
    flight_dir = tempfile.mkdtemp(prefix="chip_smoke_flight_")
    old_dir = os.environ.get("PADDLE_TPU_FLIGHT_DIR")
    os.environ["PADDLE_TPU_FLIGHT_DIR"] = flight_dir
    try:
        # traces and histograms: 4e's mix again with tracing on
        off_p50 = ctx["decode_step_p50_ms"]
        registry.reset("serving")
        tracing.drain_spans()
        tracing.enable()
        step_ends = []
        handles = adopt_all(ContinuousBatchScheduler(b, max_queue_size=64),
                            reqs, export_all(a, reqs)[0], step_ends)
        tracing.disable()
        spans = tracing.drain_spans()
        if [h.tokens for h in handles] != want:
            raise AssertionError("traces: tokens with tracing on differ")
        names = {"queue_wait", "prefill", "kv_export", "kv_import",
                 "kv_adopt", "decode"}
        for (_, o), h in zip(reqs, handles):
            tid = tracing.trace_id_for_seed(o["seed"])
            mine = {s[1] for s in spans if s[0] == tid}
            if h.trace_id != tid or not names <= mine:
                raise AssertionError(f"traces: request seed {o['seed']}: "
                                     f"trace {h.trace_id} spans {mine}")
        col = tracing.FleetTraceCollector()
        col.add_spans("chip_smoke", spans, pid=os.getpid())
        with tempfile.TemporaryDirectory() as d:
            with open(col.write(os.path.join(d, "trace.json"))) as f:
                doc = json.load(f)
        events = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        if len(events) != len(spans) or len(col.traces()) != len(reqs) + 1:
            raise AssertionError(f"traces: the chrome trace holds "
                                 f"{len(events)} of {len(spans)} spans")
        hists, times = registry.histograms("serving"), \
            registry.timings("serving")
        # the measured p50 at the histogram's rank: the smallest value
        # that half the observations do not exceed
        measured = {"ttft": [h.ttft_s for h in handles],
                    "inter_token": token_gaps(step_ends)}
        pairs = {}
        for k, xs in measured.items():
            exact_ms = sorted(xs)[math.ceil(len(xs) / 2) - 1] * 1e3
            pairs[k] = (hists[f"serving.{k}"]["p50_ms"], exact_ms)
            if abs(hist_index(pairs[k][0]) - 1 - hist_index(exact_ms)) > 1:
                raise AssertionError(f"histograms: {k} p50 {pairs[k][0]} "
                                     f"ms against {exact_ms} ms measured")
        pairs["ttft_reservoir_p50_ms"] = times["serving.ttft"]["p50_ms"]
        out["traces"] = {
            "spans": len(spans), "requests_traced": len(reqs),
            "chrome_trace_events": len(events),
            "hist_vs_measured_p50_ms": pairs,
            "decode_step_p50_ms_tracing_on": times["serving.decode_step"][
                "p50_ms"],
            "decode_step_p50_ms_tracing_off": off_p50}

        # page_pool_exhausted: requests stay queued, then all finish
        payloads = export_all(a, reqs)[0]
        c0 = registry.counters("serving")
        faults.configure("page_pool_exhausted:times=3")
        sched = ContinuousBatchScheduler(b, max_queue_size=64)
        handles = [sched.submit(h) for h in handoff_requests(reqs, payloads)]
        queued = []
        while sched.has_work():
            sched.step()
            queued.append(sched.queued())
        faults.reset()
        c1 = registry.counters("serving")
        if queued[:3] != [len(reqs)] * 3 or [h.tokens for h in handles] \
                != want or c1["pool_exhausted"] - c0["pool_exhausted"] != 3:
            raise AssertionError(f"page_pool_exhausted: queued {queued[:4]}"
                                 f", tokens equal "
                                 f"{[h.tokens for h in handles] == want}")
        out["page_pool_exhausted"] = {"queued_after_steps": queued[:4],
                                      "tokens_equal": True}

        # decode_error beside phase 4d's own injection
        sub = [reqs[i] for i in greedy]
        payloads = export_all(a, sub)[0]
        c0 = registry.counters("serving")
        faults.configure("decode_error:fails=1")
        got = [h.tokens for h in adopt_all(
            ContinuousBatchScheduler(b, max_queue_size=64), sub, payloads)]
        faults.reset()
        c1 = registry.counters("serving")
        moved = {k: c1[k] - c0[k] for k in ("step_retries", "reprimes",
                                            "decode_compiles",
                                            "requests_failed")}
        if moved != {"step_retries": 1, "reprimes": 1,
                     "decode_compiles": int(dev.type == "cuda"),
                     "requests_failed": 0} or \
                got != [want[i] for i in greedy]:
            raise AssertionError(f"decode_error: {moved}, tokens equal "
                                 f"{got == [want[i] for i in greedy]}")
        out["decode_error"] = moved

        # kill_during_swap: the old weights serve the same tokens
        payloads = export_all(a, sub)[0]
        gen0 = b._weight_gen
        c0 = registry.counters("serving")
        faults.configure("kill_during_swap")
        sched = ContinuousBatchScheduler(b, max_queue_size=64)
        sched.request_swap({k: v.detach() for k, v in
                            ctx["model_1"].gpt.state_dict().items()})
        got = [h.tokens for h in adopt_all(sched, sub, payloads)]
        faults.reset()
        c1 = registry.counters("serving")
        if c1["swap_failures"] - c0["swap_failures"] != 1 or \
                c1["weight_swaps"] != c0["weight_swaps"] or \
                b._weight_gen != gen0 or got != [want[i] for i in greedy]:
            raise AssertionError(f"kill_during_swap: {sched.last_swap_error}"
                                 f", tokens equal "
                                 f"{got == [want[i] for i in greedy]}")
        out["kill_during_swap"] = repr(sched.last_swap_error)[:100]

        # replica_kill: the worker loop fails the batch and dumps
        payloads = export_all(a, sub)[0]
        srv = GenerationServer(engine=b, max_queue_size=64)
        faults.configure("replica_kill:nth=5")
        try:
            hs = [srv.submit_request(r)
                  for r in handoff_requests(sub, payloads)]
            for h in hs:
                h.result(timeout=600)
        finally:
            faults.reset()
            srv.shutdown(timeout=600)
        path = tracing.flight_dump_path()
        dump = tracing.load_flight_dump(path)
        fatal = [e for e in dump["events"] if e["event"] == "fatal"]
        if any(h.status != "error" for h in hs) or \
                "replica_kill" not in str(srv.fatal_error) or not fatal or \
                not dump["reason"].startswith("fatal_engine_error"):
            raise AssertionError(f"replica_kill: {hs}, fatal "
                                 f"{srv.fatal_error!r}, dump {dump['reason']}")
        out["replica_kill"] = {"failed_requests": len(hs),
                               "flight_events": len(dump["events"]),
                               "fatal": fatal[-1]["detail"]["error"][:80]}

        # draft_garbage and kernel_mismatch, float32 at n_layer layers
        target = build_gpt(dev, 1, n_layer=n_layer, dtype="float32")
        prompt = np.random.default_rng(1).integers(
            0, target.gpt.cfg.vocab_size, 333).tolist()
        plain = GenerationEngine(target, max_batch_size=2, rng_seed=0,
                                 device=dev)
        spec = DraftVerifyEngine(
            target, build_gpt(dev, 1, n_layer=n_layer, dtype="float32"),
            draft_k=4, max_batch_size=2, rng_seed=0, device=dev)
        c0 = registry.counters("serving")
        faults.configure("draft_garbage:rounds=3")
        got = _spec_run(spec, prompt, 24, seed=3, temperature=0.8)
        faults.reset()
        c1 = registry.counters("serving")
        if got != _spec_run(plain, prompt, 24, seed=3, temperature=0.8) \
                or c1["spec_accepted"] - c0["spec_accepted"] >= \
                c1["spec_proposed"] - c0["spec_proposed"]:
            raise AssertionError("draft_garbage: spec tokens differ from "
                                 "plain decode's, or every draft was "
                                 "accepted")
        out["draft_garbage"] = {
            "tokens_equal_plain": True,
            "accepted": c1["spec_accepted"] - c0["spec_accepted"],
            "proposed": c1["spec_proposed"] - c0["spec_proposed"]}
        del spec, plain

        rejected = {}
        for armed in (True, False):
            rec = RouteRecorder()
            try:
                if armed:
                    faults.configure("kernel_mismatch")
                eng = GenerationEngine(target, max_batch_size=2, rng_seed=0,
                                       device=dev)
                eng.prefill(0, prompt, seed=0)
                eng.decode_step()  # captures the graph, then replays it
                torch.cuda.synchronize()
            finally:
                faults.reset()
                rec.restore()
            args, got = rec.calls[0]  # layer 0
            try:
                check_paged("decode in a graph captured with "
                            f"kernel_mismatch {'armed' if armed else 'off'}",
                            torch.float32, *paged_errors(got, args))
            except AssertionError as e:
                rejected[armed] = str(e)[:160]
            else:
                rejected[armed] = None
            del eng, rec
        if rejected[True] is None or rejected[False] is not None:
            raise AssertionError(f"kernel_mismatch: the parity check "
                                 f"{rejected}")
        out["kernel_mismatch"] = {"rejected_when_armed": rejected[True],
                                  "passed_when_off": True}
    finally:
        faults.reset()
        tracing.disable()
        if old_dir is None:
            os.environ.pop("PADDLE_TPU_FLIGHT_DIR", None)
        else:
            os.environ["PADDLE_TPU_FLIGHT_DIR"] = old_dir
        shutil.rmtree(flight_dir, ignore_errors=True)
    a.pool.audit()
    b.pool.audit()
    log("observability: " + json.dumps(out))
    return out


def handoff_requests(reqs, payloads):
    """``GenerationRequest`` handles carrying the payloads."""
    from paddle_tpu_torch.serving import GenerationRequest

    out = []
    for (p, o), payload in zip(reqs, payloads):
        r = GenerationRequest(p, **o)
        r.kv_payload = payload
        out.append(r)
    return out


# ------------------------------------------------------------------- MoE --
def zero_gates(model):
    """``model`` with every MoE gate weight zeroed: every row then picks
    experts 0 and 1 (uniform probabilities, first index on ties), which
    crowds them and forces drops."""
    from paddle_tpu_torch.nn.moe import MoEMLP

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MoEMLP):
                m.gate.weight.zero_()
    return model


def graph_against_eager(dev, model, steps=8, max_batch_size=8):
    """Two engines (rng_seed 3) on ``model``, 8 slots of 512-token prompts
    each: one replays its decode graph, the other calls the same step
    body from Python on its buffers. Their tokens must be equal."""
    from paddle_tpu_torch.serving import GenerationEngine

    vocab = model.gpt.cfg.vocab_size
    outs = []
    for replay in (True, False):
        eng = GenerationEngine(model, max_batch_size=max_batch_size,
                               block_size=16, rng_seed=3, device=dev)
        fill_slots(eng, vocab, max_batch_size)
        if not replay:
            for buf, host in eng._mirrors():
                buf.copy_(torch.from_numpy(np.ascontiguousarray(host)))
        toks = []
        for _ in range(steps):
            if replay:
                toks.append(eng.decode_step().tolist())
            else:
                eng._decode_body()
                t = eng._d_toks.cpu().numpy()
                eng._finish_decode(eng._active, max_batch_size, t)
                toks.append(t.tolist())
        outs.append(toks)
        if replay and dev.type == "cuda" and not eng._decode_graph.captured:
            raise AssertionError("moe serving: the decode graph was not "
                                 "captured")
        del eng
    if outs[0] != outs[1]:
        raise AssertionError(f"moe serving: the decode graph's tokens "
                             f"{outs[0]} differ from the eager body's "
                             f"{outs[1]}")
    return steps * max_batch_size


def phase_moe_serving(dev, preset="gpt3-1.3B", dtype="bfloat16"):
    """9: the MoE model (``MOE``, full width and depth, bf16, seed 0)
    through phase 4's server and checks (one decode capture, K4 launched
    decode steps x n_layer times on the card's count, 0 kernels launched
    from the host in a steady step, one prefill capture per bucket, all
    at warm-up), then phase 4f's check of every prefill bucket (replay
    equal to its direct body, bitwise), the decode graph's tokens against
    the eager body's, and ``moe.metrics.publish`` on one eager forward of
    8 prompts of 512 tokens. Returns the result and phase 4's view of the
    tokens (for 9b)."""
    from paddle_tpu_torch.nn.moe import metrics

    t0 = time.perf_counter()
    model = build_gpt(dev, 0, preset, dtype=dtype, **MOE)
    cfg = model.gpt.cfg
    n_params = sum(p.numel() for p in model.parameters())
    log(f"moe serving: {preset} {dtype} {json.dumps(MOE)}: "
        f"{n_params / 1e9:.3f} B parameters, "
        f"{n_params * 2 / 1e9:.2f} GB, built in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    result, plain = phase_serving(dev, preset, dtype, model=model, **MOE)
    result["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    result["parameters"] = n_params
    graphs = phase_prefill_graphs(dev, model)
    result["prefill_graphs"] = {
        "captures": graphs["captures"],
        "device_ms": {L: r["graph_device_ms"]
                      for L, r in graphs["per_bucket"].items()}}
    result["graph_equals_eager_tokens"] = graph_against_eager(dev, model)
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 512)))
    with torch.no_grad():
        model.gpt(tokens.to(dev))
    pub = metrics.publish(model)
    if pub is None or not 0.0 <= pub["drop_fraction"] < 1.0:
        raise AssertionError(f"moe serving: metrics.publish gave {pub}")
    result["eager_forward_8x512"] = {
        "drop_fraction": pub["drop_fraction"],
        "expert_tokens": pub["expert_tokens"].tolist(),
        "capacity_per_expert": moe_capacity_of(cfg, 512)}
    log("moe serving: " + json.dumps({k: v for k, v in result.items()
                                      if k not in ("launches", "fastpath")}))
    del model
    free_memory()
    return result, plain


def moe_capacity_of(cfg, rows):
    from paddle_tpu_torch.nn.moe import moe_capacity

    return moe_capacity(rows, cfg.moe_num_experts, cfg.moe_top_k,
                        cfg.moe_capacity_factor)


def phase_moe_spec(dev, plain, preset="gpt3-1.3B"):
    """9b: phase 5b's speculative serving on the MoE target (bf16, full
    width and depth, gpt2-small drafting), then phase 5 on the MoE layout
    in float32 at 2 layers, with random and with zeroed gate weights: K4
    against its plain route, and spec tokens against plain decode's with
    a twin drafter (every draft accepted, so every verify runs a full
    span) and an independent 1-layer one, greedy and sampled. The verify
    routes each row as its own group, as decode does, so no row loses
    its expert slot to its neighbours."""
    result = phase_spec_serving(dev, plain, preset, **MOE)
    result["float32_parity_max_logit_err"] = {
        gate: phase_parity(dev, preset, zero_gate=gate == "zero", **MOE)
        for gate in ("random", "zero")}
    return result


def phase_moe_training(dev, preset="gpt3-1.3B", n_layer=4, batch=4,
                       seq_len=2048, steps=4):
    """9c: the MoE model (``MOE``, full width, 4 layers, 2 of them MoE)
    trained through ``TrainStep`` + AdamW with master weights on one
    batch of 4 x 2048, loss + ``moe_aux_loss()`` (the first step eager,
    the second captured and replayed, the rest replays): the loss and
    the aux loss finite, the loss falling, K1-K3 launched once per layer
    per step on the card's count and the plain attention never."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.profiler import registry

    t0 = time.perf_counter()
    cfg, model, opt, train, tokens, labels = training_setup(
        dev, preset, batch, seq_len, n_layer=n_layer, **MOE)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"moe training: {preset} bf16 n_layer={n_layer} {json.dumps(MOE)}"
        f": {n_params / 1e9:.3f} B parameters, built in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    registry.reset("kernels")
    fa.reset_device_launches()
    losses, auxes, times = [], [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        loss = train(tokens, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        losses.append(float(loss.detach()))
        auxes.append(float(model.moe_aux_loss().detach()))
    counts = dict(flash_device_counts(), flash_attention_ref=fa.launches()[
        "flash_attention_ref"])
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if not (all(np.isfinite(losses)) and all(np.isfinite(auxes))) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"moe training: losses {losses}, aux "
                             f"{auxes}: not finite and falling")
    for name in FLASH_KERNELS:
        if counts[name] != steps * n_layer:
            raise AssertionError(f"moe training: {counts[name]} {name} "
                                 f"launches, want {steps} x {n_layer}")
    if counts["flash_attention_ref"]:
        raise AssertionError("moe training: the plain attention ran")
    result = {"preset": preset, "n_layer": n_layer, "moe": MOE,
              "parameters": n_params, "batch": batch, "seq_len": seq_len,
              "losses": losses, "aux_losses": auxes,
              "step_ms": [t * 1e3 for t in times],
              "replay_step_ms": sorted(times[2:])[len(times[2:]) // 2]
              * 1e3,
              "tokens_per_s": batch * seq_len / min(times[2:]),
              "peak_memory_gb": peak_gb, "launches": counts}
    log("moe training: " + json.dumps(result))
    del model, opt, train
    free_memory()
    return result


# -------------------------------------------------- older cache forms --
def greedy_slot_cache(model, prompt, n, S):
    """Greedy tokens through the reference's slot-cache form: one prefill
    span into ``[1, S, H, Dh]`` buffers, then one row a step; the float32
    LM head, as the engine's."""
    gpt = model.gpt
    dev = gpt.device
    caches = [tuple(torch.zeros(1, S, b.attn.n_head, b.attn.head_dim,
                                device=dev, dtype=gpt.ln_f.weight.dtype)
                    for _ in range(2)) for b in gpt.blocks]
    head = gpt.embeddings.word_embeddings.weight.float()
    ids, off, out = list(prompt), 0, []
    with torch.no_grad():
        while len(out) < n:
            T = len(ids)
            x = torch.tensor([ids], device=dev)
            pos = torch.arange(off, off + T, device=dev)[None]
            h, caches = gpt(x, pos, caches=caches,
                            cache_offsets=torch.tensor([off], device=dev,
                                                       dtype=torch.int32),
                            seq_lens=torch.tensor([off + T], device=dev,
                                                  dtype=torch.int32))
            tok = int((h[0, -1].float() @ head.t()).argmax())
            out.append(tok)
            off += T
            ids = [tok]
    return out


def greedy_concat(model, prompt, n):
    """Greedy tokens through the growing-concat form, one row a step, the
    prompt included."""
    gpt = model.gpt
    dev = gpt.device
    caches = [tuple(torch.zeros(1, 0, b.attn.n_head, b.attn.head_dim,
                                device=dev, dtype=gpt.ln_f.weight.dtype)
                    for _ in range(2)) for b in gpt.blocks]
    head = gpt.embeddings.word_embeddings.weight.float()
    seq, out = list(prompt), []
    with torch.no_grad(), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the one-time legacy warning
        for t in range(len(prompt) + n - 1):
            h, caches = gpt(torch.tensor([[seq[t]]], device=dev),
                            torch.tensor([[t]], device=dev), caches=caches)
            if t >= len(prompt) - 1:
                tok = int((h[0, -1].float() @ head.t()).argmax())
                out.append(tok)
                seq.append(tok)
    return out


def phase_legacy_cache(dev, preset="gpt3-1.3B", n_layer=2, n_tokens=16):
    """9d: the reference's older cache forms at gpt3-1.3B width (2 layers,
    float32): greedy tokens through the slot cache and through one-row
    concat decoding equal the paged engine's (graphs, K4)."""
    from paddle_tpu_torch.serving import GenerationEngine

    model = build_gpt(dev, 3, preset, n_layer=n_layer, dtype="float32")
    prompt = np.random.default_rng(3).integers(
        0, model.gpt.cfg.vocab_size, 40).tolist()
    eng = GenerationEngine(model, max_batch_size=2, rng_seed=0, device=dev)
    paged = _spec_run(eng, prompt, n_tokens, seed=0)
    slot = greedy_slot_cache(model, prompt, n_tokens, S=64)
    concat = greedy_concat(model, prompt, n_tokens)
    if not paged == slot == concat:
        raise AssertionError(f"legacy caches: paged {paged}, slot cache "
                             f"{slot}, concat {concat}")
    log(f"legacy caches: {preset} width, {n_layer} layers float32, "
        f"{n_tokens} greedy tokens: slot cache and one-row concat equal the "
        "paged engine's")
    del eng, model
    free_memory()
    return {"tokens": n_tokens, "equal": True}


# ------------------------------------------------------------------ main --
_ENTRY = re.compile(r"Compiling entry function '\S*?\d((?:flash|paged)_\w*?"
                    r"_kernel(?:_sm90)?)I(\w*?)E+v")
_TYPES = {"13__nv_bfloat16": "bf16", "f": "float32"}


def ptxas_instances(lib_path):
    """Every kernel instance in the library's ``-Xptxas -v`` log:
    ``[{"kernel", "args", "registers", "spill_stores", "lines"}]``, with
    ``args`` its template arguments (``["bf16", "64", "1"]``) and ``lines``
    its register, spill and shared-memory lines."""
    out = []
    for line in Path(f"{lib_path}.log").read_text().splitlines():
        m = _ENTRY.search(line)
        if m:
            out.append({"kernel": m.group(1), "args": [
                _TYPES.get(a, a[2:]) for a in re.findall(
                    r"13__nv_bfloat16|f|Li\d+", m.group(2))],
                "registers": None, "spill_stores": None, "lines": []})
            continue
        if not out or ("registers" not in line and "spill" not in line):
            continue
        out[-1]["lines"].append(line.strip())
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out[-1]["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["registers"] = int(m.group(1))
    return out


def flash_instances(lib_path):
    """Every flash kernel instance of ``ptxas_instances``: ``[{"kernel",
    "dtype", "H", "registers", "spill_stores", "smem_bytes"}]``.
    ``registers`` is the count at launch (the Hopper design's warpgroups
    then move to their setmaxnreg budgets); ``smem_bytes`` is the dynamic
    shared memory its launch requests, which ptxas does not see. The
    Hopper design's kernels take H alone: they are bf16 only."""
    lib = ctypes.CDLL(str(lib_path))
    lib.flash_attention_smem.restype = ctypes.c_int
    kinds = {"flash_fwd": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 2}
    out = []
    for r in ptxas_instances(lib_path):
        if r["kernel"].split("_kernel")[0] not in kinds:
            continue
        dtype, H = ("bf16", *r["args"])[-2:]
        out.append({"kernel": r["kernel"], "dtype": dtype, "H": int(H),
                    "registers": r["registers"],
                    "spill_stores": r["spill_stores"],
                    "smem_bytes": lib.flash_attention_smem(
                        kinds[r["kernel"].split("_kernel")[0]],
                        int(dtype == "bf16"), int(H))})
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on a "
              "GPU", file=sys.stderr)
        return 2
    if not (REPO / "paddle_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: paddle_tpu_torch not found beside {__file__}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import paddle_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from paddle_tpu_torch.ops import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    log(f"device: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = _build.build()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for r in ptxas_instances(libs["paged_attention"]):
        for line in r["lines"]:
            log(f"build: {r['kernel']}<{','.join(r['args'])}>: {line}")
    for r in flash_instances(libs["flash_attention"]):
        log(f"build: {r['kernel']} {r['dtype']} H={r['H']}: "
            f"{r['registers']} registers, {r['spill_stores']} bytes spill "
            f"stores, {r['smem_bytes']} bytes shared memory")

    paged = phase_kernels(dev)
    served, plain = phase_serving(dev)
    swapped, retried = phase_swap(dev)
    handoff, ctx = phase_handoff(dev)
    graphs = phase_prefill_graphs(dev, ctx["model"])
    observed = phase_observability(dev, ctx)
    del ctx
    free_memory()
    phase_parity(dev)
    spec = phase_spec_serving(dev, plain)
    phase_spec_swap(dev)
    moe_served, moe_plain = phase_moe_serving(dev)
    moe_spec = phase_moe_spec(dev, moe_plain)
    phase_legacy_cache(dev)
    for row in paged:  # launches the card counted on the main paths
        verify = row["name"] == "paged_attention_verify"
        row["launches"] = (spec["verify_launches"] if verify
                           else served["decode_launches"])
        row["launches_by_path"] = (
            {"spec": spec["verify_launches"],
             "moe spec": moe_spec["verify_launches"]} if verify else
            {"serving": served["decode_launches"],
             "moe serving": moe_served["decode_launches"]})
    flash = phase_flash_kernels(dev)
    trained, model = phase_training(dev)
    for name, row in flash.items():
        row["launches"] = trained["launches"][name]
    followed = phase_train_to_serve(dev, model,
                                    step=trained["trained_steps"])
    del model
    free_memory()
    phase_train_state_round_trip(dev)
    phase_training_parity(dev)
    phase_training_parity_bf16(dev)
    moe_trained = phase_moe_training(dev)
    policies = phase_recompute(dev)
    policy_parity = phase_recompute_parity(dev)
    recipe = phase_recipe_graph(dev)
    recaptured = phase_recapture(dev)
    for name, row in flash.items():
        row["launches_by_path"] = {
            "training": trained["launches"][name],
            "moe training": moe_trained["launches"][name],
            **{f"recompute {pol} (per step)": r["launches_per_step"][name]
               for pol, r in policies.items()}}
    log(f"serving on {smi}: {served['tokens_per_s']:.1f} tokens/s, p50 TTFT "
        f"{served['ttft_p50_ms']:.1f} ms, p50 decode step "
        f"{served['decode_step_p50_ms']:.2f} ms (CUDA graph)")
    log(f"spec serving on {smi}: {spec['tokens_per_s']:.1f} tokens/s, p50 "
        f"TTFT {spec['ttft_p50_ms']:.1f} ms, p50 round "
        f"{spec['round_p50_ms']:.2f} ms, acceptance {spec['acceptance']:.4f}"
        f", {spec['emitted_per_round']:.2f} tokens per round; against plain "
        f"decode {json.dumps(spec['plain_match'])}")
    log(f"swap on {smi}: stage {swapped['swap_stage_s']:.3f} s, copy "
        f"{swapped['swap_commit_s'] * 1e3:.2f} ms, step with the swap "
        f"{swapped['step_with_swap_ms']:.1f} ms, steady step p50 "
        f"{swapped['steady_step_p50_ms_before']:.2f} ms before / "
        f"{swapped['steady_step_p50_ms_after']:.2f} ms after; retry "
        f"{json.dumps(retried['counters_moved'])}")
    log(f"handoff on {smi}: B's tokens equal M's for "
        f"{handoff['requests']} requests; export "
        f"{handoff['export_ms_p50']:.2f} ms, import "
        f"{handoff['import_ms_p50']:.2f} ms per request (p50, payload "
        f"{handoff['payload_mb_p50']:.1f} MB); B's p50 TTFT "
        f"{handoff['ttft_p50_ms']:.1f} ms, p50 decode step "
        f"{handoff['decode_step_p50_ms']:.2f} ms")
    log(f"prefill graphs on {smi}: " + ", ".join(
        f"{L}: {r['graph_device_ms']:.2f}/{r['direct_device_ms']:.2f} ms"
        for L, r in graphs["per_bucket"].items())
        + f" (graph/direct, device); shared pool "
        f"{graphs['graph_pool_reserved_mb']:.0f} MB; phase 4 p50 TTFT "
        f"{served['ttft_p50_ms']:.1f} ms with prefill graphs")
    log(f"observability on {smi}: decode step p50 "
        f"{observed['traces']['decode_step_p50_ms_tracing_on']:.2f} ms "
        f"with tracing on, "
        f"{observed['traces']['decode_step_p50_ms_tracing_off']:.2f} off; "
        f"fault points {sorted(k for k in observed if k != 'traces')}")
    log(f"train->serve on {smi}: {followed['bytes'] / 1e9:.2f} GB saved in "
        f"{followed['save_s']:.1f} s, followed (load and swap) in "
        f"{followed['follow_load_and_swap_s']:.1f} s, swap stage "
        f"{followed['swap_stage_s']:.3f} s")
    log(f"training on {smi}: {trained['preset']} bf16 batch "
        f"{trained['batch']} x {trained['seq_len']}: step "
        f"{trained['step_ms']:.1f} ms, {trained['tokens_per_s']:.0f} "
        f"tokens/s, MFU {trained['mfu']:.4f}, peak memory "
        f"{trained['peak_memory_gb']:.1f} GB")
    log(f"moe serving on {smi}: {moe_served['tokens_per_s']:.1f} tokens/s, "
        f"p50 TTFT {moe_served['ttft_p50_ms']:.1f} ms, p50 decode step "
        f"{moe_served['decode_step_p50_ms']:.2f} ms (CUDA graph), peak "
        f"memory {moe_served['peak_memory_gb']:.1f} GB; K4 "
        f"{moe_served['decode_launches']} launches = "
        f"{moe_served['decode_steps']} steps x 24; drop fraction of one "
        f"eager forward "
        f"{moe_served['eager_forward_8x512']['drop_fraction']:.4f}")
    log(f"moe spec on {smi}: {moe_spec['tokens_per_s']:.1f} tokens/s, p50 "
        f"TTFT {moe_spec['ttft_p50_ms']:.1f} ms, p50 round "
        f"{moe_spec['round_p50_ms']:.2f} ms; dense spec p50 TTFT "
        f"{spec['ttft_p50_ms']:.1f} ms with drafter prefill graphs "
        f"{json.dumps(spec['draft_prefill_buckets'])}")
    log(f"training graph on {smi}: step {trained['step_ms']:.1f} ms "
        f"(graph) / {trained['eager_step_ms']:.1f} ms (eager loop), MFU "
        f"{trained['mfu']:.4f} / {trained['eager_mfu']:.4f}, peak memory "
        f"{trained['peak_memory_gb']:.1f} / "
        f"{trained['eager_peak_memory_gb']:.1f} GB, "
        f"{trained['host_kernel_launches_per_step']:.0f} kernels launched "
        f"from the host per step")
    log(f"recompute on {smi}: " + ", ".join(
        f"{pol} {r['step_ms']:.1f} ms MFU {r['mfu']:.4f} peak "
        f"{r['peak_memory_gb']:.1f} GB K1 "
        f"{r['launches_per_step']['flash_fwd']:.0f}/step"
        for pol, r in policies.items())
        + f"; float32 parity against none {json.dumps(policy_parity)}")
    log(f"recipe on {smi}: graph == eager bitwise over "
        f"{len(recipe['losses'])} steps, rates {recipe['rates']}; dropout "
        f"{json.dumps(recipe['dropout'])}; {len(recipe['optimizers'])} "
        f"optimizer cases captured == eager; recapture "
        f"{json.dumps(recaptured)}")
    log(f"moe training on {smi}: {moe_trained['n_layer']} layers, batch "
        f"{moe_trained['batch']} x {moe_trained['seq_len']}: step "
        f"{moe_trained['replay_step_ms']:.1f} ms (graph replay), "
        f"losses {moe_trained['losses']}, peak memory "
        f"{moe_trained['peak_memory_gb']:.1f} GB")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [*paged, *flash.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
