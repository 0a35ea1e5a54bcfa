#!/usr/bin/env python3
"""Planted faults in the flash-attention kernels K1-K3, and which of the
on-card parity checks see them.

Run on a machine with one NVIDIA GPU and nvcc, from the repository root:

    python3 tools/flash_mutation_check.py [--only NAME ...]

Each mutant below is one edit of ``paddle_tpu_torch/csrc/flash_attention.cu``
that breaks the kernels in bf16 only: the K1 and K3 mutants edit the Hopper
design, which only bf16 takes, and the K2 mutant the WMMA design's bf16
branch. For each, the tool copies ``paddle_tpu_torch/`` into
``build/mutants/<name>/`` (the copy builds its own library under that
directory), applies the edit there and runs, in a child process against the
copy, the checks of ``chip_smoke.py``:

* the kernel parity sweep of phase 6, every case and the training step's
  shape, counting the outputs that fail the elementwise bound
  ``FLASH_PARITY_TOL`` and those that fail the relative bound
  ``FLASH_PARITY_REL``;
* the bf16 training parity of phase 8 (kernel route against plain route).

The unmutated source ("none") runs first and must pass every check. Prints
one line per mutant and a JSON summary as the last line; exits 1 if "none"
fails a check or a mutant passes them all.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCE = "csrc/flash_attention.cu"
IS_BF16 = "!std::is_same<T, float>::value"

# name -> (what it breaks, text of the source, its replacement)
MUTANTS = {
    "none": ("the source as committed", None, None),
    "k1_late_key_tile": (
        "K1 (Hopper design) drops key tile 14 (keys 1792-1919) from every "
        "query row: only rows past 1791 see it, so only T = 2048",
        "      fence_regs(sc);\n\n      // the mask, only on tiles",
        "      fence_regs(sc);\n"
        "      if (j == 14)\n"
        "#pragma unroll\n"
        "        for (int e = 0; e < BN / 2; ++e) sc[e] = -INFINITY;\n\n"
        "      // the mask, only on tiles"),
    "k3_late_query_tile": (
        "K3 (Hopper design) drops query tile 30 from every key tile's loop: "
        "dK and dV lose one tile of query rows, only at T = 2048",
        "      fence_regs(dpt);\n\n      // P^T = exp(scale s - lse)",
        "      fence_regs(dpt);\n"
        "      if (i == 30)\n"
        "#pragma unroll\n"
        "        for (int e = 0; e < BQ / 2; ++e) st[e] = -INFINITY;\n\n"
        "      // P^T = exp(scale s - lse)"),
    "k2_short_fragment": (
        "K2's dS.K product stops 16 keys short of each tile (one WMMA "
        "k-step missing)",
        "    mm<T, BLK, H, BLK, false, false>(DQ, C::LDFH, DS, C::LDB, Ks, "
        "C::LDH,",
        f"    mm<T, BLK, H, ({IS_BF16} ? BLK - 16 : BLK), false, false>(DQ, "
        "C::LDFH, DS, C::LDB, Ks, C::LDH,"),
}


def make_mutant(name):
    """``build/mutants/<name>/paddle_tpu_torch`` with the mutant's edit;
    returns the directory to put first on ``sys.path``."""
    _, old, new = MUTANTS[name]
    root = REPO / "build" / "mutants" / name
    pkg = root / "paddle_tpu_torch"
    if pkg.exists():
        shutil.rmtree(pkg)
    shutil.copytree(REPO / "paddle_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    if old is not None:
        src = pkg / SOURCE
        text = src.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"mutant {name}: its text occurs "
                               f"{text.count(old)} times in {SOURCE}")
        src.write_text(text.replace(old, new))
    return root


def child(root):
    """Runs in the child: the checks against the package under ``root``."""
    sys.path[:0] = [str(root), str(REPO)]
    import torch

    import chip_smoke as cs
    import paddle_tpu_torch
    from paddle_tpu_torch.ops import flash_attention as fa

    assert Path(paddle_tpu_torch.__file__).is_relative_to(root)
    dev = torch.device("cuda", 0)
    cases = list(cs.flash_cases())
    B, T, N, H = cs.STEP_SHAPE
    cases.append((torch.bfloat16, True, H, T, B, N, True, 9))
    fails = {"elementwise": [], "relative": []}
    worst = {}
    for dtype, causal, H, T, B, N, strided, seed in cases:
        q, k, v, do = cs.flash_case(dev, dtype, B, T, N, H, seed, strided)
        res = cs.flash_case_errors(q, k, v, do, causal)
        what = f"{str(dtype)[6:]} causal={causal} H={H} T={T} B*N={B * N}"
        for out, (err, n_bad, rel) in res.items():
            key = f"{out} {str(dtype)[6:]}"
            if rel is not None:
                worst[key] = max(worst.get(key, 0.0), rel)
            if n_bad:
                fails["elementwise"].append(f"{out} {what}")
            if rel is not None and not rel <= fa.FLASH_PARITY_REL[dtype]:
                fails["relative"].append(f"{out} {what}")
    try:
        cs.phase_training_parity_bf16(dev)
        train = "pass"
    except AssertionError as e:
        train = f"fail: {e}"
    print(json.dumps({"cases": len(cases), "outputs": 5 * len(cases),
                      "fails": fails, "worst_rel": worst,
                      "bf16_training_parity": train}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", choices=list(MUTANTS))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(Path(args.child))
        return 0
    names = args.only or list(MUTANTS)
    if "none" not in names:
        names.insert(0, "none")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    summary, ok = {}, True
    for name in names:
        root = make_mutant(name)
        proc = subprocess.run([sys.executable, __file__, "--child",
                               str(root)], cwd=REPO, capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
            raise RuntimeError(f"mutant {name}: the child exited "
                               f"{proc.returncode}")
        for line in proc.stdout.splitlines()[:-1]:
            print(f"  [{name}] {line}")
        r = json.loads(proc.stdout.splitlines()[-1])
        caught = {
            "elementwise": len(r["fails"]["elementwise"]),
            "relative": len(r["fails"]["relative"]),
            "bf16_training_parity": r["bf16_training_parity"] != "pass"}
        summary[name] = {"what": MUTANTS[name][0], "caught": caught,
                         "first_fails": {k: v[:3]
                                         for k, v in r["fails"].items()},
                         "worst_rel": r["worst_rel"],
                         "bf16_training_parity": r["bf16_training_parity"]}
        seen = any(caught.values())
        ok &= (not seen) if name == "none" else seen
        print(f"{name}: {MUTANTS[name][0]}\n  outputs failing the "
              f"elementwise bound {caught['elementwise']} of {r['outputs']},"
              f" the relative bound {caught['relative']}; bf16 training "
              f"parity {r['bf16_training_parity'][:300]}", flush=True)
    print(json.dumps({"card": smi, "ok": ok, "mutants": summary}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
