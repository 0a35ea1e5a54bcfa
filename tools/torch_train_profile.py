#!/usr/bin/env python3
"""Where a GPT pretraining step of paddle_tpu_torch spends its time.

Run on a machine with one NVIDIA GPU, from the repository root:

    python3 tools/torch_train_profile.py [--preset gpt3-1.3B] [--batch 4]
        [--seq-len 2048] [--steps 2] [--trace train_trace.json]

Builds the training step of ``chip_smoke.py`` phase 7 through its
``training_setup`` (the preset in bf16 with random weights from seed 0,
``TrainStep`` with ``AdamW(1e-4, multi_precision=True)``, one fixed
batch): 3 warm-up steps,
5 steps timed on the host clock, then ``--steps`` more traced with
``torch.profiler``. Prints the card (nvidia-smi name and power limit), the
step time, the device-busy share of the traced window (union of kernel
intervals over wall time) and the device time per step by kernel family
and by kernel; ``--trace`` also writes the chrome trace to that path.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]

# kernel family by a substring of the kernel's name, first match wins; the
# flash patterns match both designs (flash_*_kernel, flash_*_kernel_sm90)
FAMILIES = (
    ("K1 flash_fwd", ("flash_fwd_kernel",)),
    ("K2 flash_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("K3 flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
    ("GEMM", ("gemm", "sm90_xmma", "cutlass", "nvjet", "cublas")),
    ("LayerNorm", ("layer_norm",)),
    ("softmax / cross-entropy", ("softmax", "nll_loss", "log_softmax")),
    ("copies and casts", ("copy", "cast", "fill")),
    ("elementwise and reductions", ("elementwise", "reduce",
                                    "vectorized", "unrolled")),
)


def _busy_union(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _family(name):
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k.lower() in low for k in keys):
            return fam
    return "other"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="gpt3-1.3B")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--trace", default=None,
                    help="write the chrome trace of the window here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from chip_smoke import training_setup

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    _, _, _, train, tokens, labels = training_setup(
        dev, args.preset, args.batch, args.seq_len)
    for _ in range(3):
        train(tokens, labels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        train(tokens, labels)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 5 * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            train(tokens, labels)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = _busy_union((e.time_range.start, e.time_range.end)
                          for e in kernels)
    by_name, by_family = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        rec = by_name.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += us
        fam = by_family.setdefault(_family(e.name), [0, 0.0])
        fam[0] += 1
        fam[1] += us
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)

    device_ms = sum(v[1] for v in by_name.values()) / args.steps / 1e3
    print(f"card: {smi}")
    print(f"{args.preset} bf16, batch {args.batch} x {args.seq_len}: step "
          f"{step_ms:.1f} ms (host clock, 5 steps)")
    print("device time per step by family:")
    for fam, (n, us) in sorted(by_family.items(), key=lambda kv: -kv[1][1]):
        print(f"  {us / args.steps / 1e3:9.2f} ms  {n // args.steps:6d}/step"
              f"  {us / args.steps / 1e3 / device_ms:6.1%}  {fam}")
    print("top kernels per step:")
    for name, (n, us) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:15]:
        print(f"  {us / args.steps / 1e3:9.2f} ms  {n // args.steps:6d}/step"
              f"  {name[:90]}")
    print(json.dumps({
        "card": smi, "preset": args.preset, "batch": args.batch,
        "seq_len": args.seq_len, "step_ms": step_ms,
        "traced_step_ms": wall_us / args.steps / 1e3,
        "device_ms_per_step": device_ms,
        "device_busy_share": busy_us / wall_us,
        "kernels_per_step": len(kernels) / args.steps,
        "family_ms_per_step": {f: v[1] / args.steps / 1e3
                               for f, v in by_family.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
