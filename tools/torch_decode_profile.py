#!/usr/bin/env python3
"""Where a decode step of paddle_tpu_torch's serving engine spends its time:
the steady step through its CUDA graph against the same step body run
eagerly, and one speculative round, in one run.

Run on a machine with one NVIDIA GPU, from the repository root:

    python3 tools/torch_decode_profile.py [--preset gpt3-1.3B] [--steps 10]
        [--draft-preset gpt2-small] [--draft-k 4] [--moe]
        [--trace decode_trace.json]

Builds the preset in bf16 with random weights from seed 0 and fills every
one of 8 slots with a 512-token prompt. Then, on the same engine and
slots:

* graph: the steady step as the engine runs it (one replay of the
  captured body and one read of the token block), 30 steps timed on the
  host clock, 10 more traced with ``torch.profiler``;
* eager: the same body called from Python on the same buffers (the
  engine's private ``_decode_body``; the engine itself never takes this
  route on a GPU), timed and traced the same way.

Then a ``DraftVerifyEngine`` over the same target, the drafter preset in
bf16 from seed 2 drafting ``--draft-k`` tokens, with the same 8 prompts:
rounds timed and traced the same way.

``--moe`` makes the target a Mixture-of-Experts model (8 experts, top-2,
capacity factor 1.25, in every other block: ``chip_smoke.MOE``) and splits
the eager route's device time per step into the gate (``TopKGate``), the
rest of the MoE layers (dispatch, expert FFN and combine einsums), the
paged kernel K4 and everything else: the tool wraps the two MoE forwards
in ``torch.profiler.record_function`` scopes for the eager route only
and sums the device time of the kernels launched inside each.

Prints the card (nvidia-smi name and power limit) and, for each route,
the host-clock p50, the kernels per step, the kernels launched from the
host per step (cudaLaunchKernel calls), the graph launches per step, the
device time per step and its busy share of the traced window (union of
kernel intervals over wall time), and the device time by kernel;
``--trace`` writes the graph route's chrome trace to that path.
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
_HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                  "cuLaunchKernel", "cuLaunchKernelEx")


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


def measure(step, steps, trace=None):
    """Host-clock p50 over 30 calls of ``step``, then ``steps`` more under
    torch.profiler: returns (summary dict, [(name, (count, us))] by device
    time)."""
    for _ in range(3):
        step()
    host = []
    for _ in range(30):
        t0 = time.perf_counter()
        step()
        host.append(time.perf_counter() - t0)
    host.sort()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = _busy_union((e.time_range.start, e.time_range.end)
                          for e in kernels)
    by_name = {}
    for e in kernels:
        rec = by_name.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += e.time_range.end - e.time_range.start
    if trace:
        Path(trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(trace)
    cpu = [e.name for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    summary = {
        "host_p50_ms": host[len(host) // 2] * 1e3,
        "traced_step_ms": wall_us / steps / 1e3,
        "kernels_per_step": len(kernels) / steps,
        "host_kernel_launches_per_step":
            sum(n in _HOST_LAUNCHES for n in cpu) / steps,
        "graph_launches_per_step": cpu.count("cudaGraphLaunch") / steps,
        "device_ms_per_step": sum(v[1] for v in by_name.values())
        / steps / 1e3,
        "device_busy_share": busy_us / wall_us,
        # K4 is two kernels per call, the split pass and the combine
        "paged_attention_us_per_step": sum(
            us for name, (n, us) in by_name.items()
            if "paged_attention" in name) / steps,
        "paged_attention_kernels": {
            re.search(r"paged_attention_\w+?_kernel<[^(]*?>", name)[0]: {
                "per_step": n / steps, "us_per_step": us / steps}
            for name, (n, us) in by_name.items()
            if "paged_attention" in name}}
    return summary, sorted(by_name.items(), key=lambda kv: -kv[1][1])


def scope_device_us(events, name):
    """Device microseconds of the kernels launched inside every CPU range
    named ``name`` (a ``record_function`` scope)."""
    return sum(e.device_time_total for e in events
               if e.name == name
               and e.device_type == torch.autograd.DeviceType.CPU)


def moe_split(step, steps):
    """The device time per step of ``step`` split into the MoE gate, the
    rest of the MoE layers, K4 and everything else, from torch.profiler
    over ``steps`` calls with the two MoE forwards in named scopes."""
    from paddle_tpu_torch.nn.moe import MoEMLP, TopKGate

    originals = {cls: cls.forward for cls in (TopKGate, MoEMLP)}

    def scoped(cls, name):
        def forward(self, *a, **k):
            with torch.profiler.record_function(name):
                return originals[cls](self, *a, **k)
        return forward

    TopKGate.forward = scoped(TopKGate, "moe.gate")
    MoEMLP.forward = scoped(MoEMLP, "moe.layer")
    try:
        step()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
    finally:
        for cls, fwd in originals.items():
            cls.forward = fwd
    events = prof.events()
    # the scopes also show on the device track (gpu_user_annotation
    # events spanning each range): they are no kernels
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in ("moe.gate", "moe.layer")]
    total = sum(e.time_range.end - e.time_range.start for e in kernels)
    gate = scope_device_us(events, "moe.gate")
    layer = scope_device_us(events, "moe.layer")
    paged = sum(e.time_range.end - e.time_range.start for e in kernels
                if "paged_attention" in e.name)
    return {"device_us_per_step": total / steps,
            "gate_us_per_step": gate / steps,
            "moe_einsums_us_per_step": (layer - gate) / steps,
            "paged_attention_us_per_step": paged / steps,
            "rest_us_per_step": (total - layer - paged) / steps}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="gpt3-1.3B")
    ap.add_argument("--draft-preset", default="gpt2-small")
    ap.add_argument("--draft-k", type=int, default=4)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--moe", action="store_true",
                    help="profile the MoE variant of the preset (MOE)")
    ap.add_argument("--trace", default=None,
                    help="write the graph route's chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from chip_smoke import MOE
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel)
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import DraftVerifyEngine, GenerationEngine

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = GPTConfig.preset(args.preset, dtype="bfloat16",
                           **(MOE if args.moe else {}))
    model = GPTForPretraining(GPTModel(
        cfg, device=dev, generator=torch.Generator(dev).manual_seed(0)))
    prompts = [np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, args.prompt_len))[i].tolist()
        for i in range(8)]

    def fill(eng):
        for slot, prompt in enumerate(prompts):
            eng.prefill(slot, prompt, seed=slot)

    eng = GenerationEngine(model, max_batch_size=8, block_size=16,
                           device=dev)
    fill(eng)

    def eager_step():
        # the body the graph holds, called from Python on the same buffers
        active = eng._active
        eng._decode_body()
        eng._finish_decode(active, int(active.sum()),
                           eng._d_toks.cpu().numpy())

    routes = {}
    routes["graph"] = measure(eng.decode_step, args.steps, args.trace)
    routes["eager"] = measure(eager_step, args.steps)
    if args.moe:
        routes["eager"][0]["moe_split"] = moe_split(eager_step, args.steps)
    del eng

    drafter = GPTForPretraining(GPTModel(
        GPTConfig.preset(args.draft_preset, seq_len=cfg.seq_len,
                         dtype="bfloat16"),
        device=dev, generator=torch.Generator(dev).manual_seed(2)))
    spec = DraftVerifyEngine(model, drafter, draft_k=args.draft_k,
                             max_batch_size=8, block_size=16, device=dev)
    fill(spec)
    registry.reset("serving")
    routes["spec_round"] = measure(spec.decode_step_spec, args.steps)
    c = registry.counters("serving")
    routes["spec_round"][0].update({
        "draft_k": args.draft_k, "rounds": c["spec_rounds"],
        "acceptance": c["spec_accepted"] / c["spec_proposed"],
        "emitted_per_slot_round": c["spec_emitted"] / c["spec_slot_rounds"]})

    print(f"card: {smi}")
    print(f"{args.preset} bf16{' MoE ' + json.dumps(MOE) if args.moe else ''}"
          f", 8 slots x {args.prompt_len}-token prompts; "
          f"spec: {args.draft_preset} drafting K={args.draft_k}")
    for route, (summary, top) in routes.items():
        print(f"{route}: " + ", ".join(
            f"{k} {v:.4g}" for k, v in summary.items()
            if isinstance(v, float)))
        for name, (n, us) in top[:12]:
            print(f"  {us / args.steps:9.1f} us/step  "
                  f"{n / args.steps:6.1f}/step  {name[:90]}")
    print(json.dumps({"card": smi, "preset": args.preset,
                      "moe": MOE if args.moe else None,
                      "draft_preset": args.draft_preset,
                      **{route: summary
                         for route, (summary, _) in routes.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
