#!/usr/bin/env python3
"""Where a decode step of paddle_tpu_torch's serving engine spends its time.

Run on a machine with one NVIDIA GPU, from the repository root:

    python3 tools/torch_decode_profile.py [--preset gpt3-1.3B] [--steps 10]
        [--trace decode_trace.json]

Builds the preset in bf16 with random weights from seed 0, fills every one
of 8 slots with a 512-token prompt, warms up, then times 30 decode steps on
the host clock and traces 10 more with ``torch.profiler``. Prints the card
(nvidia-smi name and power limit), the step-time p50, the kernels launched
per step, the device-busy share of the traced window (union of kernel
intervals over wall time) and the device time by kernel; ``--trace``
also writes the chrome trace to that path.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="gpt3-1.3B")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--trace", default=None,
                    help="write the chrome trace of the window here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel)
    from paddle_tpu_torch.serving import GenerationEngine

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = GPTConfig.preset(args.preset, dtype="bfloat16")
    model = GPTForPretraining(GPTModel(
        cfg, device=dev, generator=torch.Generator(dev).manual_seed(0)))
    eng = GenerationEngine(model, max_batch_size=8, block_size=16,
                           device=dev)
    rng = np.random.default_rng(0)
    for slot in range(8):
        eng.prefill(slot, rng.integers(0, cfg.vocab_size,
                                       args.prompt_len).tolist(), seed=slot)
    for _ in range(3):
        eng.decode_step()
    host = []
    for _ in range(30):
        t0 = time.perf_counter()
        eng.decode_step()
        host.append(time.perf_counter() - t0)
    host.sort()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.decode_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = _busy_union((e.time_range.start, e.time_range.end)
                          for e in kernels)
    by_name = {}
    for e in kernels:
        rec = by_name.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += e.time_range.end - e.time_range.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)

    print(f"card: {smi}")
    print(f"{args.preset} bf16, 8 slots x {args.prompt_len}-token prompts")
    for name, (n, us) in top[:15]:
        print(f"  {us / args.steps:9.1f} us/step  {n // args.steps:4d}/step  "
              f"{name[:90]}")
    print(json.dumps({
        "card": smi, "preset": args.preset,
        "decode_step_p50_ms": host[len(host) // 2] * 1e3,
        "traced_step_ms": wall_us / args.steps / 1e3,
        "kernels_per_step": len(kernels) / args.steps,
        "device_busy_share": busy_us / wall_us,
        "device_ms_per_step": sum(v[1] for v in by_name.values())
        / args.steps / 1e3,
        # K4 is two kernels per call, the split pass and the combine
        "paged_attention_us_per_step": sum(
            us for name, (n, us) in by_name.items()
            if "paged_attention" in name) / args.steps,
        "paged_attention_kernels": {
            re.search(r"paged_attention_\w+?_kernel", name)[0]: {
                "per_step": n / args.steps, "us_per_step": us / args.steps}
            for name, (n, us) in by_name.items()
            if "paged_attention" in name}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
