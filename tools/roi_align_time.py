#!/usr/bin/env python3
"""Time ``vision.ops.roi_align`` at ``chip_smoke.py`` phase 18a's shape:
Faster R-CNN R50-C4's 1000 proposals an image (``generate_proposals`` on
the phase's seeded RPN, 2 images of 800 x 1333) pooled 14 x 14 from a
1024-channel 50 x 84 map, scale 1/16, ``sampling_ratio`` 0 (adaptive),
aligned.

Run on a machine with one NVIDIA GPU, from the repository root:

    python3 tools/roi_align_time.py [--root DIR] [--reps 11]

``--root`` names the tree whose ``paddle_tpu_torch`` is timed (default:
this repository), so two versions can be compared in one run of the
card. Prints the card (nvidia-smi name and power limit) and one JSON
line: the median host and device (CUDA events) milliseconds of ``--reps``
calls after a first one, the peak memory above the inputs, the RoIs, and
the adaptive sample counts per bin (their mean and largest, per axis).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--reps", type=int, default=11)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from paddle_tpu_torch.vision import ops

    if not Path(ops.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"paddle_tpu_torch came from {ops.__file__}, "
                           f"not from {root}")
    sys.path.append(str(REPO))
    from chip_smoke import (DETECT, host_and_device_ms, memory_above,
                            rpn_inputs)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    rois, _, num = ops.generate_proposals(
        *rpn_inputs(dev), pre_nms_top_n=6000, post_nms_top_n=1000,
        nms_thresh=0.7, min_size=0.0)
    feat = torch.randn(DETECT["rpn_batch"], DETECT["align_channels"],
                       *DETECT["rpn_map"], device=dev,
                       generator=torch.Generator(device=dev).manual_seed(1))
    kw = dict(output_size=14, spatial_scale=1 / 16, sampling_ratio=0,
              aligned=True)

    def call():
        return ops.roi_align(feat, rois, num, **kw)

    _, peak, _ = memory_above(call)
    ms, device_ms = host_and_device_ms(call, n=args.reps)
    side = (rois[:, 2:] - rois[:, :2]) / 16 / 14      # bin size, x then y
    counts = torch.ceil(side).clamp_min(1)
    out = {"card": smi, "root": str(root), "rois": int(rois.shape[0]),
           "ms": ms, "device_ms": device_ms, "reps": args.reps,
           "peak_above_inputs_gb": peak / 1e9,
           "samples_per_bin_mean": float(counts.prod(1).mean()),
           "samples_max_xy": counts.max(0).values.tolist()}
    print(f"card: {smi}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
