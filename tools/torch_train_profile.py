#!/usr/bin/env python3
"""Where a GPT, BERT, ResNet or LSTM training step of paddle_tpu_torch
spends its time, through ``TrainStep``'s CUDA graph and as the same step
run eagerly.

Run on a machine with one NVIDIA GPU, from the repository root:

    python3 tools/torch_train_profile.py [--preset gpt3-1.3B] [--batch 4]
        [--seq-len 2048] [--steps 2]
        [--route both|graph|eager|fit|all|bert|bert-bf16|resnet|
                 ernie-static|ernie-static-train|ernie-static-both|lstm]
        [--trace train_trace.json]

Builds the training step of ``chip_smoke.py`` phase 7 through its
``training_setup`` (the preset in bf16 with random weights from seed 0,
``TrainStep`` with ``AdamW(1e-4, multi_precision=True)``, one fixed
batch). The "fit" route is phase 11's step instead: ``hapi.Model
.train_batch`` on the preset with float32 parameters under O1 (built by
``chip_smoke.fit_model``), its batch handed over as CPU tensors as the
DataLoader hands it; "all" runs eager, graph and fit, one model at a
time. "bert" and "bert-bf16" are ``chip_smoke.py`` phases 14 and 14b's
step through the graph (``bert_training_setup``: bert-base float32 at
16 x 128, bf16 at 16 x 512; ``--preset``, ``--batch`` and ``--seq-len``
do not apply), run one after the other for "bert-both". "resnet" is
phase 15's step (``resnet_training_setup``: ResNet-50 float32 at 32 x 3
x 224 x 224, Momentum 0.1, through the graph), and after it the Momentum
update alone (``opt.step()`` called eagerly on the step's gradients, its
kernels' device time). "ernie-static" is phase 16's run
(``ernie_static_setup``: BASELINE config 5's ERNIE classifier, float32,
16 x 128, ``static.Executor.run`` with the numpy feed and fetch) and
"ernie-static-train" phase 16b's (``ernie_static_training_setup``: the
same model recorded with AdamW's ``minimize``), one after the other for
"ernie-static-both". "lstm" is phase 17's step (``lstm_lm_setup``: the
large PTB LSTM language model, float32, batch 20 x 35, SGD with the
global-norm clip, through the graph). Per route: 3 warm-up steps (for a graph: the eager
call, the capture and a replay), 5 steps timed on the host clock, then
``--steps`` more traced with ``torch.profiler``. Prints the card
(nvidia-smi name and power limit), and per route the step time, the
device-busy share of the traced window (union of kernel intervals over
wall time), the kernels launched from the host and the graph launches per
step, the host-side operators per step (what launched those kernels), and
the device time per step by kernel family and by kernel; ``--trace``
also writes the chrome trace of the last route profiled to that path.
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
# flash patterns match every design (flash_*_kernel, flash_*_kernel_sm90,
# flash_*_kernel_tf32)
FAMILIES = (
    ("K1 flash_fwd", ("flash_fwd_kernel",)),
    ("K2 flash_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("K3 flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
    ("convolution", ("fprop", "dgrad", "wgrad", "convolve", "conv2d",
                     "implicit_gemm", "winograd", "conv_kernel")),
    ("BatchNorm", ("bn_fw", "bn_bw", "batch_norm", "batchnorm")),
    ("pooling", ("pool",)),
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
    # device events, less the ranges a record_function (RecordEvent) span
    # draws on the device timeline: they are no kernel
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    host = [e.name for e in events
            if e.device_type != torch.autograd.DeviceType.CUDA]
    host_ops = {}
    for n in host:
        if n.startswith("aten::"):
            host_ops[n] = host_ops.get(n, 0) + 1
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
        "host_ops_per_step": {n: c / steps for n, c in sorted(
            host_ops.items(), key=lambda kv: -kv[1])[:12]},
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
                    choices=("both", "graph", "eager", "fit", "all", "bert",
                             "bert-bf16", "bert-both", "resnet",
                             "ernie-static", "ernie-static-train",
                             "ernie-static-both", "lstm"))
    ap.add_argument("--trace", default=None,
                    help="write the chrome trace of the window here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from chip_smoke import (LSTM_LM, RESNET_FULL, bert_training_setup,
                            ernie_static_setup, ernie_static_training_setup,
                            fit_model, free_memory, lstm_lm_setup,
                            resnet_training_setup, training_setup)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    order = {"both": ["eager", "graph"], "all": ["eager", "graph", "fit"],
             "bert-both": ["bert", "bert-bf16"],
             "ernie-static-both": ["ernie-static", "ernie-static-train"]}
    order = order.get(args.route, [args.route])

    def bf16_routes():
        _, _, _, train, tokens, labels = training_setup(
            dev, args.preset, args.batch, args.seq_len)
        return {"eager": lambda: train.step_fn(tokens, labels),
                "graph": lambda: train(tokens, labels)}

    routes = bf16_routes() if {"eager", "graph"} & set(order) else {}

    def fit_route():
        """Phase 11's step, built once the other routes' model is gone."""
        routes.clear()
        free_memory()
        _, model = fit_model(dev, preset=args.preset)
        toks = torch.randint(0, model.network.gpt.cfg.vocab_size,
                             (args.batch, args.seq_len + 1),
                             generator=torch.Generator().manual_seed(0))
        return lambda: model.train_batch([toks[:, :-1]], toks[:, 1:])

    def bert_route(dtype, seq_len):
        """Phase 14's (float32) or 14b's (bf16) step, one model at a time."""
        routes.clear()
        free_memory()
        _, _, _, train, ids, nsp = bert_training_setup(dev, dtype,
                                                       seq_len=seq_len)
        routes["bert_model"] = train
        return lambda: train(ids, nsp)

    def resnet_route():
        """Phase 15's step through the graph; its optimizer for the
        update's own timing."""
        routes.clear()
        free_memory()
        model, opt, train, x, y = resnet_training_setup(dev, **RESNET_FULL)
        routes["resnet"] = (model, opt, train, x, y)
        return lambda: train(x, y)

    def lstm_route():
        """Phase 17's step through the graph."""
        routes.clear()
        free_memory()
        _, _, train, x, y = lstm_lm_setup(dev)
        routes["lstm"] = train
        return lambda: train(x, y)

    def ernie_static_route(train):
        """Phase 16's Executor run (or 16b's, ``train``), one Program at a
        time, under a scope of its own."""
        from paddle_tpu_torch import static

        routes.clear()
        free_memory()
        if train:
            _, prog, fetch, feeds = ernie_static_training_setup(dev)
            feed = feeds[0]
        else:
            _, prog, fetch, ids = ernie_static_setup(dev)
            feed = {"input_ids": ids}
        scope = static.Scope()
        exe = static.Executor()
        routes["ernie"] = (prog, scope, exe)

        def step():
            with static.scope_guard(scope):
                exe.run(prog, feed=feed, fetch_list=[fetch])

        return step

    def momentum_alone():
        """``opt.step()`` on a step's gradients, eagerly: the update's
        kernels and their device time a call."""
        model, opt, _, x, y = routes["resnet"]
        from paddle_tpu_torch.nn import functional as F

        F.cross_entropy(model(x), y).backward()
        res, _ = profile(opt.step, 2)
        return res

    shapes = {"bert": ("float32", "bert-base float32, batch 16 x 128"),
              "bert-bf16": ("bfloat16", "bert-base bf16, batch 16 x 512")}
    print(f"card: {smi}")
    out = {"card": smi}
    if {"eager", "graph", "fit"} & set(order):
        # the GPT routes' configuration; the other routes name their own
        out.update(preset=args.preset, batch=args.batch,
                   seq_len=args.seq_len)
    prof = None
    for route in order:
        if route.startswith("ernie-static"):
            train = route == "ernie-static-train"
            step = ernie_static_route(train)
            what = ("ernie classifier float32 (BASELINE config 5), 16 x "
                    "128, static.Executor.run, "
                    + ("AdamW step" if train else "inference"))
        elif route == "lstm":
            step = lstm_route()
            c = LSTM_LM
            what = (f"lstm lm float32 ({c['vocab']} x {c['hidden']} x "
                    f"{c['layers']} layers, dropout {c['dropout']}), batch "
                    f"{c['batch']} x {c['steps']}")
        elif route == "resnet":
            step = resnet_route()
            what = (f"resnet50 float32, batch {RESNET_FULL['batch']} x 3 x "
                    f"{RESNET_FULL['side']}^2")
        elif route in shapes:
            step = bert_route(shapes[route][0],
                              128 if route == "bert" else 512)
            what = shapes[route][1]
        else:
            step = fit_route() if route == "fit" else routes[route]
            kind = "float32 under O1" if route == "fit" else "bf16"
            what = (f"{args.preset} {kind}, batch {args.batch} x "
                    f"{args.seq_len}")
        res, prof = profile(step, args.steps)
        top = res.pop("top")
        out[route] = {"config": what, **res}
        print(f"{what}, {route}: step {res['step_ms']:.1f} ms (host clock, 5 "
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
        for ms, n, name in top:
            print(f"  {ms:9.2f} ms  {n:6d}/step  {name[:90]}")
        print(f"host operators per step: {res['host_ops_per_step']}")
        if route == "resnet":
            upd = momentum_alone()
            upd.pop("top")
            out["resnet_momentum_update"] = upd
            print(f"Momentum update alone (eager, 161 parameters): device "
                  f"{upd['device_ms_per_step']:.2f} ms, "
                  f"{upd['kernels_per_step']:.0f} kernels a call")
    if args.trace and prof is not None:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
