#!/usr/bin/env python3
"""Where a GPT pretraining step of paddle_tpu_torch spends its time, through
``TrainStep``'s CUDA graph and as the same step run eagerly.

Run on a machine with one NVIDIA GPU, from the repository root:

    python3 tools/torch_train_profile.py [--preset gpt3-1.3B] [--batch 4]
        [--seq-len 2048] [--steps 2] [--route both|graph|eager]
        [--trace train_trace.json]

Builds the training step of ``chip_smoke.py`` phase 7 through its
``training_setup`` (the preset in bf16 with random weights from seed 0,
``TrainStep`` with ``AdamW(1e-4, multi_precision=True)``, one fixed
batch). Per route: 3 warm-up steps (for the graph: the eager call, the
capture and a replay), 5 steps timed on the host clock, then ``--steps``
more traced with ``torch.profiler``. Prints the card (nvidia-smi name and
power limit), and per route the step time, the device-busy share of the
traced window (union of kernel intervals over wall time), the kernels
launched from the host and the graph launches per step, and the device
time per step by kernel family and by kernel; ``--trace`` also writes the
chrome trace of the last route profiled to that path.
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


def profile(step, steps):
    """Time and trace ``step()``: its host-clock step time over 5 steps after
    3 warm-up ones, then ``steps`` steps under torch.profiler. Returns the
    summary and the profiler."""
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 5 * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = list(prof.events())
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    host = [e.name for e in events
            if e.device_type != torch.autograd.DeviceType.CUDA]
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
    device_ms = sum(v[1] for v in by_name.values()) / steps / 1e3
    return {
        "step_ms": step_ms, "traced_step_ms": wall_us / steps / 1e3,
        "device_ms_per_step": device_ms,
        "device_busy_share": busy_us / wall_us,
        "kernels_per_step": len(kernels) / steps,
        "host_kernel_launches_per_step": sum(
            n in LAUNCHES for n in host) / steps,
        "graph_launches_per_step": host.count("cudaGraphLaunch") / steps,
        "family_ms_per_step": {f: v[1] / steps / 1e3
                               for f, v in by_family.items()},
        "top": sorted(((v[1] / steps / 1e3, v[0] // steps, n)
                       for n, v in by_name.items()), reverse=True)[:15],
    }, prof


LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="gpt3-1.3B")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--route", default="both",
                    choices=("both", "graph", "eager"))
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
    routes = {"eager": lambda: train.step_fn(tokens, labels),
              "graph": lambda: train(tokens, labels)}
    order = ["eager", "graph"] if args.route == "both" else [args.route]
    print(f"card: {smi}")
    out = {"card": smi, "preset": args.preset, "batch": args.batch,
           "seq_len": args.seq_len}
    prof = None
    for route in order:
        res, prof = profile(routes[route], args.steps)
        out[route] = res
        print(f"{args.preset} bf16, batch {args.batch} x {args.seq_len}, "
              f"{route}: step {res['step_ms']:.1f} ms (host clock, 5 "
              f"steps), device {res['device_ms_per_step']:.1f} ms, busy "
              f"{res['device_busy_share']:.1%}, "
              f"{res['kernels_per_step']:.0f} kernels / step, "
              f"{res['host_kernel_launches_per_step']:.0f} launched from "
              f"the host, {res['graph_launches_per_step']:.0f} graph "
              "launches")
        print("device time per step by family:")
        for fam, ms in sorted(res["family_ms_per_step"].items(),
                              key=lambda kv: -kv[1]):
            print(f"  {ms:9.2f} ms  {ms / res['device_ms_per_step']:6.1%}"
                  f"  {fam}")
        print("top kernels per step:")
        for ms, n, name in res.pop("top"):
            print(f"  {ms:9.2f} ms  {n:6d}/step  {name[:90]}")
    if args.trace and prof is not None:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
