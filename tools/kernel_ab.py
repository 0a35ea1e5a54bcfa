#!/usr/bin/env python3
"""Device time of the kernels K1-K4 from two checkouts, timed in turns.

Run on a machine with one NVIDIA GPU and nvcc, from the repository root:

    python3 tools/kernel_ab.py PARENT_DIR CHANGE_DIR [--rounds N]

Each directory holds a checkout of the repository (a commit unpacked with
``git archive``) with its ``paddle_tpu_torch/``. Each round runs parent,
change, change, parent, every run in a child process that imports that
checkout's package alone (it builds its kernels under the checkout's
``build/``); the inputs and the timers are this repository's
``chip_smoke.py`` for both sides. A child times, at the shapes of
``chip_smoke.py``, K4 at 8 slots x 1024 and 2 slots x 2048 live rows (bf16
decode) and K1, K2 and K3 at the training step's shape, each as device
time (``chip_smoke.device_ms``: calls captured in a CUDA graph and
replayed, so the host's cost per call does not count; K4's calls take
copies of its pools in turn, so L2 is cold, and "warm_ms" is K4 on one
copy) and as called eagerly from Python. Prints the card, one JSON line per
child and a summary line of every reading by side.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def child(root):
    """Runs in the child: times the kernels of the checkout at ``root``."""
    sys.path.insert(0, str(root))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    assert Path(pa.__file__).resolve().is_relative_to(root.resolve())
    dev = torch.device("cuda", 0)
    calls, res = {}, {}
    for shape, lens in (("8x1024", [1024] * 8), ("2x2048", [2048] * 2)):
        args = cs.paged_case(dev, torch.bfloat16, 1, lens, seed=7)
        row_bytes = 2 * args[1][0, 0].numel() * args[1].element_size()
        copies = cs.cold_copies(args, sum(lens) * row_bytes)
        name = f"paged_attention {shape}"
        calls[name] = ([lambda a=a: pa.paged_attention(*a) for a in copies],
                       20)
        res[name] = {"warm_ms": cs.device_ms(
            lambda a=args: pa.paged_attention(*a), calls=20, replays=2)}
    B, T, N, H = cs.STEP_SHAPE
    q, k, v, do = cs.flash_case(dev, torch.bfloat16, B, T, N, H, seed=9,
                                strided=True)
    out, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.flash_delta(out, do)
    calls["flash_fwd"] = (lambda: fa.flash_fwd(q, k, v, True), 10)
    calls["flash_bwd_dq"] = (
        lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True), 10)
    calls["flash_bwd_dkv"] = (
        lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True), 10)
    for name, (fn, n) in calls.items():
        res.setdefault(name, {}).update(
            device_ms=cs.device_ms(fn, calls=n, replays=2),
            eager_ms=cs.cuda_ms(fn if callable(fn) else fn[0], iters=n))
    print(json.dumps(res))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    sides = {"parent": args.parent, "change": args.change}
    readings = {"parent": [], "change": []}
    for _ in range(args.rounds):
        for side in ("parent", "change", "change", "parent"):
            proc = subprocess.run(
                [sys.executable, __file__, str(args.parent),
                 str(args.change), "--child", str(sides[side].resolve())],
                capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                print(proc.stdout[-3000:], proc.stderr[-3000:], sep="\n")
                raise RuntimeError(f"{side}: the child exited "
                                   f"{proc.returncode}")
            r = json.loads(proc.stdout.splitlines()[-1])
            readings[side].append(r)
            print(json.dumps({side: r}), flush=True)
    summary = {side: {name: {key: [r[name][key] for r in rs]
                             for key in rs[0][name]}
                      for name in rs[0]}
               for side, rs in readings.items()}
    print(json.dumps({"card": smi, "readings": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
