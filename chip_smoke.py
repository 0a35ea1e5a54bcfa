#!/usr/bin/env python3
"""On-card smoke test of paddle_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA GPU and the CUDA
toolkit:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
 1. device   the card's name and power limit (nvidia-smi), torch and CUDA
             versions;
 2. build    every CUDA source of the port with nvcc (sm_90a), timed; the
             registers, spill stores and shared memory of every flash
             kernel instance;
 3. kernels  each kernel's wrapper against its plain PyTorch version on the
             card at the serving path's shapes, held to the stated
             tolerance; kernel, plain version and one library call timed
             with CUDA events, beside the least time the card could take;
 4. serving  gpt3-1.3B in bf16 (full width and depth, random weights from a
             seed) behind GenerationServer answers 16 requests; the decode
             path must launch the paged kernel once per layer per decode
             step and the plain version never;
 5. parity   the same request through a kernel engine and a plain engine
             on the card (gpt3-1.3B width, 2 layers, float32): decode
             logits within tolerance, greedy tokens equal;
 6. kernels (training)  the flash-attention kernels K1-K3 against their
             plain versions over float32 and bf16, causal and not, head_dim
             64/96/128/256 and seq_len 128/256/2048, on strided unbind views
             as the model hands them over, and at the training step's shape
             (batch 4 x 32 heads, seq_len 2048, head_dim 64, bf16, causal);
             every output held elementwise and, block by block, relative to
             the plain version's norm; each launched twice on the same
             inputs at the step's shape and at bf16 H=128, T=2048, the
             outputs bitwise equal; then each timed at the step's shape
             beside its plain version, one library call and its bound;
 7. training gpt3-1.3B in bf16 (full width and depth, random weights from
             a seed) trains through TrainStep + AdamW with master weights,
             batch 4 x 2048: 3 warm-up and 5 timed steps on one batch; the
             loss must be finite and falling, and every step must launch
             K1, K2 and K3 once per layer and the plain attention never;
 8. training parity  one model through the kernel route and the plain
             route on the card (gpt3-1.3B width, 2 layers): in float32 at
             seq_len 256, loss and every gradient of one step, and the
             parameters after 3 AdamW steps, within tolerance; in bf16 (the
             kernels' tensor-core branch) at seq_len 2048, loss and every
             gradient of one step within a bound relative to the plain
             route's.

Prints a {"kernels": [...]} line and the nvidia-smi line before the last
line, {"ok": true, "device": {...}}. Without CUDA, or without the rest of
the repository beside it, it prints no result and exits 2.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
# H100 SXM data sheet at its 700 W limit: HBM3 bandwidth and dense peaks by
# operand type (a card set to a lower power limit runs slower under load)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
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
    "paged_attention": "one block per (head, slot) over its live keys, "
                       "16-byte loads, online softmax in registers",
    "flash_fwd": "bf16 at H=64/128: warp-specialised, TMA producer "
                 "(setmaxnreg 40/232) into a 3-stage (H=64) or 2-stage "
                 "(H=128) mbarrier ring of 128-key K/V tiles, two consumer "
                 "warpgroups of 64 query rows on wgmma with register "
                 "accumulators; float32 and bf16 at H=96/256: " + _WMMA,
    "flash_bwd_dq": "every dtype and H: " + _WMMA,
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


def phase_kernels(dev):
    from paddle_tpu_torch.ops import paged_attention as pa

    max_err = 0.0
    ragged = [1, 15, 16, 17, 700, 2048, 1, 300]
    for dtype in (torch.float32, torch.bfloat16):
        for T in (1, 4):
            lens = [max(n, T) for n in ragged]
            args = paged_case(dev, dtype, T, lens, inactive=(6,),
                              share=(4, 7, 16), seed=T)
            out = pa.paged_attention(*args)
            torch.cuda.synchronize()
            ref = pa.paged_attention_ref(*args)
            err = check_close(out, ref, pa.PAGED_PARITY_TOL[dtype],
                              f"paged_attention {dtype} T={T}")
            max_err = max(max_err, err)
            log(f"kernels: paged_attention {str(dtype)[6:]} T={T} "
                f"seq_lens={lens} max|err|={err:.3e} tol="
                f"{pa.PAGED_PARITY_TOL[dtype]}")

    # timed at the decode step's shapes: 8 slots x 1024 live rows, bf16
    args = paged_case(dev, torch.bfloat16, 1, [1024] * 8, seed=7)
    q, kp, vp, bt, sl, qo = args
    out = pa.paged_attention(*args)
    ref = pa.paged_attention_ref(*args)
    max_err = max(max_err, check_close(out, ref,
                                       pa.PAGED_PARITY_TOL[torch.bfloat16],
                                       "paged_attention timed case"))
    k_view, v_view = pa.paged_view(kp, bt), pa.paged_view(vp, bt)
    mask = pa.position_mask(qo, sl, 1, k_view.shape[1])
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k_view, v_view))
    lib = torch.nn.functional.scaled_dot_product_attention
    ms = cuda_ms(lambda: pa.paged_attention(*args))
    plain_ms = cuda_ms(lambda: pa.paged_attention_ref(*args), iters=10)
    library_ms = cuda_ms(lambda: lib(qt, kt, vt, attn_mask=mask))
    ms2 = cuda_ms(lambda: pa.paged_attention(*args))
    bound_ms, bound_by = paged_bound(q, kp, bt, sl, qo)
    log(f"kernels: paged_attention bf16 B=8 T=1 live=1024/slot: kernel "
        f"{ms:.4f} / {ms2:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library (sdpa on the gathered view) {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    return {"name": "paged_attention", "route": "cuda",
            "source": PAGED_SOURCE, "replaces": PAGED_REPLACES,
            "max_abs_err": max_err,
            "tolerance": {str(k)[6:]: v
                          for k, v in pa.PAGED_PARITY_TOL.items()},
            "ms": min(ms, ms2), "kernel_ms": min(ms, ms2),
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / min(ms, ms2),
            "design": DESIGNS["paged_attention"], "library_ms": library_ms}


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
    library = {
        "flash_fwd": cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), iters=20),
        "bwd": cuda_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dot.detach(), retain_graph=True),
            iters=20)}
    rows = {}
    for name, (kern, plain) in calls.items():
        ms = cuda_ms(kern, iters=20)
        plain_ms = cuda_ms(plain, iters=3)
        ms2 = cuda_ms(kern, iters=20)
        bound_ms, bound_by = flash_bound(name, q, causal=True)
        lib_ms = library.get(name, library["bwd"])
        log(f"kernels (training): {name} bf16 B*N={B * N} T={T} H={H} "
            f"causal: kernel {ms:.4f} / {ms2:.4f} ms, plain {plain_ms:.4f} "
            f"ms, library {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by})")
        rows[name] = {
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": FLASH_KERNELS[name][0], "max_abs_err": max_err[name],
            "tolerance": {str(d)[6:]: t
                          for d, t in fa.FLASH_PARITY_TOL.items()},
            "max_rel_err": {d: r[name] for d, r in max_rel.items()},
            "rel_bound": {str(d)[6:]: t
                          for d, t in fa.FLASH_PARITY_REL.items()},
            "ms": min(ms, ms2), "kernel_ms": min(ms, ms2),
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / min(ms, ms2), "design": DESIGNS[name],
            "library_ms": lib_ms,
            "library_call": "scaled_dot_product_attention(is_causal=True) "
            + ("forward" if name == "flash_fwd"
               else "backward (dq, dk and dv together)")}
    return rows


# -------------------------------------------------------------- training --
def training_setup(dev, preset="gpt3-1.3B", batch=4, seq_len=2048,
                   **cfg_over):
    """The pretraining step of ``bench.py``: ``preset`` in bf16 (dropout 0,
    random weights from seed 0), ``GPTPretrainingCriterion``, ``AdamW(1e-4,
    multi_precision=True)`` under ``TrainStep``, and one fixed batch of
    tokens from seed 0 with its next-token labels. Returns ``(cfg, model,
    opt, train, tokens, labels)``; ``train(tokens, labels)`` is one step."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel,
                                             GPTPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig.preset(preset, seq_len=seq_len, dtype="bfloat16",
                           dropout=0.0, **cfg_over)
    model = GPTForPretraining(GPTModel(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0)))
    crit = GPTPretrainingCriterion()
    opt = AdamW(learning_rate=1e-4, multi_precision=True,
                parameters=model.parameters())

    def step_fn(tokens, labels):
        loss = crit(model(tokens), labels)
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


def phase_training(dev, preset="gpt3-1.3B", batch=4, seq_len=2048,
                   warmup=3, steps=5, **cfg_over):
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.profiler import registry

    t0 = time.perf_counter()
    cfg, model, opt, train, tokens, labels = training_setup(
        dev, preset, batch, seq_len, **cfg_over)
    log(f"training: {preset} bf16 n_layer={cfg.n_layer} attention route "
        f"{model.gpt.attn_kernel!r}, built in {time.perf_counter() - t0:.1f}"
        " s")
    losses = []
    for _ in range(warmup):
        losses.append(float(train(tokens, labels).detach()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    registry.reset("kernels")
    t0 = time.perf_counter()
    per_step = []
    for i in range(steps):
        loss = train(tokens, labels)
        per_step.append(fa.launches())
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    losses.append(float(loss.detach()))
    counts = fa.launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training: losses {losses} are not finite and "
                             "falling")
    if model.gpt.attn_kernel != "cuda":
        raise AssertionError(f"training: the model resolved "
                             f"{model.gpt.attn_kernel!r} on the card")
    for i, c in enumerate(per_step, 1):
        for name in FLASH_KERNELS:
            if c[name] != i * cfg.n_layer:
                raise AssertionError(
                    f"training: {c[name]} {name} launches after {i} steps, "
                    f"want {i} x {cfg.n_layer} layers")
        if c["flash_attention_ref"]:
            raise AssertionError(f"training: the plain attention ran "
                                 f"{c['flash_attention_ref']} times")
    tokens_per_step = batch * seq_len
    result = {"preset": preset, "batch": batch, "seq_len": seq_len,
              "steps": steps, "step_ms": dt * 1e3,
              "tokens_per_s": tokens_per_step / dt,
              "mfu": cfg.flops_per_token() * tokens_per_step / dt
              / PEAK_FLOPS[torch.bfloat16],
              "losses": losses, "peak_memory_gb": peak_gb,
              "launches": counts}
    log("training: " + json.dumps(result))
    del model, opt, train
    torch.cuda.empty_cache()
    return result


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


def phase_serving(dev, preset="gpt3-1.3B", dtype="bfloat16",
                  max_batch_size=8, block_size=16, n_requests=16,
                  **cfg_over):
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel)
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import GenerationServer

    cfg = GPTConfig.preset(preset, dtype=dtype, **cfg_over)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = GPTForPretraining(GPTModel(cfg, device=dev, generator=gen))
    srv = GenerationServer(model, max_batch_size=max_batch_size,
                           block_size=block_size, max_queue_size=64,
                           device=dev)
    log(f"serving: {preset} {dtype} n_layer={cfg.n_layer} built in "
        f"{time.perf_counter() - t0:.1f} s; paged kernel "
        f"{srv.engine.paged_kernel!r}")
    try:
        # warm-up request: first cuBLAS handles and allocations
        srv.generate(list(range(1, 40)), max_new_tokens=4)
        reqs = serving_requests(cfg.vocab_size, n=n_requests)
        registry.reset("kernels")
        registry.reset("serving")
        t0 = time.perf_counter()
        handles = [srv.submit(p, **o) for p, o in reqs]
        for h in handles:
            h.result(timeout=600)
        wall = time.perf_counter() - t0
        counts = pa.launches()
        serving = registry.counters("serving")
        step_t = registry.timings("serving")["serving.decode_step"]
    finally:
        srv.shutdown()
    bad = [h for h in handles if h.status != "done"
           or len(h.tokens) != h.max_new_tokens]
    if bad:
        raise AssertionError(f"serving: unfinished requests {bad}")
    toks = [t for h in handles for t in h.tokens]
    if not all(0 <= t < cfg.vocab_size for t in toks):
        raise AssertionError("serving: token id out of range")
    steps = serving["decode_steps"]
    want = steps * cfg.n_layer
    if dev.type == "cuda":
        if srv.engine.paged_kernel != "cuda":
            raise AssertionError(f"serving: the engine resolved "
                                 f"{srv.engine.paged_kernel!r} on the card")
        if counts["paged_attention"] != want or steps == 0:
            raise AssertionError(
                f"serving: {counts['paged_attention']} kernel launches for "
                f"{steps} decode steps x {cfg.n_layer} layers = {want}")
        if counts["paged_attention_ref"]:
            raise AssertionError(f"serving: the plain version ran "
                                 f"{counts['paged_attention_ref']} times")
    if serving["prefix_hits"] < 3:
        raise AssertionError(f"serving: {serving['prefix_hits']} prefix hits"
                             " for four requests sharing a 256-token prefix")
    srv.engine.pool.audit()
    ttft = sorted(h.ttft_s for h in handles)
    result = {"requests": len(handles), "tokens": len(toks),
              "decode_steps": steps, "wall_s": wall,
              "tokens_per_s": len(toks) / wall,
              "ttft_p50_ms": ttft[len(ttft) // 2] * 1e3,
              "decode_step_p50_ms": step_t["p50_ms"],
              "prefix_hits": serving["prefix_hits"], "launches": counts}
    log("serving: " + json.dumps(result))
    return result


def phase_parity(dev, preset="gpt3-1.3B", n_layer=2, steps=8,
                 tol=(1e-3, 1e-3), **cfg_over):
    """One request through a kernel engine and a plain engine sharing one
    float32 model. Tolerance: float32 reduction order (kernel vs gather)
    carried through two layers and the 50304-wide LM head."""
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel)
    from paddle_tpu_torch.serving import GenerationEngine

    cfg = GPTConfig.preset(preset, n_layer=n_layer, dtype="float32",
                           **cfg_over)
    gen = torch.Generator(device=dev).manual_seed(1)
    model = GPTForPretraining(GPTModel(cfg, device=dev, generator=gen))
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               333).tolist()
    kinds = ("cuda", "torch") if dev.type == "cuda" else ("torch", "torch")
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
    log(f"parity: {kinds[0]} vs {kinds[1]} engine, {cfg.n_layer} layers "
        f"d_model {cfg.d_model} float32, {steps} decode steps: max "
        f"|logit err| {max_err:.3e} (tol {tol}), greedy tokens equal")
    return max_err


# ------------------------------------------------------------------ main --
_ENTRY = re.compile(r"Compiling entry function '\S*?\d"
                    r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel(?:_sm90)?)"
                    r"I(13__nv_bfloat16|f)?Li(\d+)E")


def flash_instances(lib_path):
    """Every flash kernel instance in the library's ``-Xptxas -v`` log:
    ``[{"kernel", "dtype", "H", "registers", "spill_stores",
    "smem_bytes"}]``. ``registers`` is the count at launch (the Hopper
    design's warpgroups then move to their setmaxnreg budgets);
    ``smem_bytes`` is the dynamic shared memory its launch requests, which
    ptxas does not see."""
    lib = ctypes.CDLL(str(lib_path))
    lib.flash_attention_smem.restype = ctypes.c_int
    kinds = {"flash_fwd": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 2}
    out, cur, spill = [], None, None
    for line in Path(f"{lib_path}.log").read_text().splitlines():
        m = _ENTRY.search(line)
        if m:
            dtype = "float32" if m.group(2) == "f" else "bf16"
            cur, spill = (m.group(1), dtype, int(m.group(3))), None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            name, dtype, H = cur
            out.append({"kernel": name, "dtype": dtype, "H": H,
                        "registers": int(m.group(1)), "spill_stores": spill,
                        "smem_bytes": lib.flash_attention_smem(
                            kinds[name.split("_kernel")[0]],
                            int(dtype == "bf16"), H)})
            cur = None
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
    for line in libs["paged_attention"].with_suffix(
            ".so.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"build: paged_attention: {line.strip()}")
    for r in flash_instances(libs["flash_attention"]):
        log(f"build: {r['kernel']} {r['dtype']} H={r['H']}: "
            f"{r['registers']} registers, {r['spill_stores']} bytes spill "
            f"stores, {r['smem_bytes']} bytes shared memory")

    kernel = phase_kernels(dev)
    served = phase_serving(dev)
    kernel["launches"] = served["launches"]["paged_attention"]
    phase_parity(dev)
    flash = phase_flash_kernels(dev)
    trained = phase_training(dev)
    for name, row in flash.items():
        row["launches"] = trained["launches"][name]
    phase_training_parity(dev)
    phase_training_parity_bf16(dev)
    log(f"serving on {smi}: {served['tokens_per_s']:.1f} tokens/s, p50 TTFT "
        f"{served['ttft_p50_ms']:.1f} ms, p50 decode step "
        f"{served['decode_step_p50_ms']:.2f} ms")
    log(f"training on {smi}: {trained['preset']} bf16 batch "
        f"{trained['batch']} x {trained['seq_len']}: step "
        f"{trained['step_ms']:.1f} ms, {trained['tokens_per_s']:.0f} "
        f"tokens/s, MFU {trained['mfu']:.4f}, peak memory "
        f"{trained['peak_memory_gb']:.1f} GB")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [kernel, *flash.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
