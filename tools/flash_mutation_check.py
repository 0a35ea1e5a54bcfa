#!/usr/bin/env python3
"""Planted faults in the attention kernels K1-K4, and which of the on-card
parity checks see them.

Run on a machine with one NVIDIA GPU and nvcc, from the repository root:

    python3 tools/flash_mutation_check.py [--only NAME ...]

Each mutant below is one edit of a kernel source under
``paddle_tpu_torch/csrc/``. The K1-K3 mutants edit the flash kernels'
Hopper design, which only bf16 takes; the K4 mutants edit the paged
kernel's split pass or its combine, every dtype. For each, the tool copies ``paddle_tpu_torch/`` into
``build/mutants/<name>/`` (the copy builds its own libraries under that
directory), applies the edit there and runs, in a child process against the
copy, the checks of ``chip_smoke.py``:

* the flash kernel parity sweep of phase 6, every case and the training
  step's shape, counting the outputs that fail the elementwise bound
  ``FLASH_PARITY_TOL`` and those that fail the relative bound
  ``FLASH_PARITY_REL``;
* the paged kernel parity sweep of phase 3, counting by dtype the cases
  outside the elementwise ``PAGED_PARITY_TOL`` and those outside the
  relative ``PAGED_PARITY_REL``;
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
FLASH = "csrc/flash_attention.cu"
PAGED = "csrc/paged_attention.cu"

# name -> (what it breaks, source, text of the source, its replacement)
MUTANTS = {
    "none": ("the source as committed", None, None, None),
    "k1_late_key_tile": (
        "K1 (Hopper design) drops key tile 14 (keys 1792-1919) from every "
        "query row: only rows past 1791 see it, so only T = 2048", FLASH,
        "      fence_regs(sc);\n\n      // the mask, only on tiles",
        "      fence_regs(sc);\n"
        "      if (j == 14)\n"
        "#pragma unroll\n"
        "        for (int e = 0; e < BN / 2; ++e) sc[e] = -INFINITY;\n\n"
        "      // the mask, only on tiles"),
    "k3_late_query_tile": (
        "K3 (Hopper design) drops query tile 30 from every key tile's loop: "
        "dK and dV lose one tile of query rows, only at T = 2048", FLASH,
        "      fence_regs(dpt);\n\n      // P^T = exp(scale s - lse)",
        "      fence_regs(dpt);\n"
        "      if (i == 30)\n"
        "#pragma unroll\n"
        "        for (int e = 0; e < BQ / 2; ++e) st[e] = -INFINITY;\n\n"
        "      // P^T = exp(scale s - lse)"),
    "k2_late_key_tile": (
        "K2 (Hopper design) drops key tile 28 (keys 1792-1855) from every "
        "query row's dQ: only rows past 1791 see it, so only T = 2048",
        FLASH,
        "        fence_regs(dp);\n\n        // P = exp(scale s - lse)",
        "        fence_regs(dp);\n"
        "        if (j == 28)\n"
        "#pragma unroll\n"
        "          for (int e = 0; e < BN / 2; ++e) sc[e] = -INFINITY;\n\n"
        "        // P = exp(scale s - lse)"),
    "k4_drop_last_split": (
        "K4's combine skips each row's last non-empty split (every dtype)",
        PAGED,
        "      if (ms == -INFINITY) continue;  // no key of split s serves "
        "row t\n",
        "      if (ms == -INFINITY) continue;  // no key of split s serves "
        "row t\n"
        "      if (s + 1 == S || part.m[(s + 1) * n_rows + t] == -INFINITY)\n"
        "        continue;\n"),
    "k4_drop_one_fetch": (
        "K4's split 1 skips its second fetch (keys 320-383 at bf16 T = 1; "
        "fewer keys at T > 1, Dh = 128 or float32)", PAGED,
        "    consume(kb, vb, base + STEP);\n",
        "    if (!(s == 1 && base == lo)) consume(kb, vb, base + STEP);\n"),
    "k4_drop_one_key": (
        "K4 leaves out key position 300 of every slot that holds it",
        PAGED,
        "        valid[u] = j < hi && j <= qo + t;\n",
        "        valid[u] = j < hi && j <= qo + t && j != 300;\n"),
}


def make_mutant(name):
    """``build/mutants/<name>/paddle_tpu_torch`` with the mutant's edit;
    returns the directory to put first on ``sys.path``."""
    _, source, old, new = MUTANTS[name]
    root = REPO / "build" / "mutants" / name
    pkg = root / "paddle_tpu_torch"
    if pkg.exists():
        shutil.rmtree(pkg)
    shutil.copytree(REPO / "paddle_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    if old is not None:
        src = pkg / source
        text = src.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"mutant {name}: its text occurs "
                               f"{text.count(old)} times in {source}")
        src.write_text(text.replace(old, new))
    return root


def child(root):
    """Runs in the child: the checks against the package under ``root``."""
    sys.path[:0] = [str(root), str(REPO)]
    import torch

    import chip_smoke as cs
    import paddle_tpu_torch
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

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
    paged = cs.paged_parity_errors(dev)
    for dt in ("float32", "bfloat16"):
        fails[f"paged {dt} elementwise"] = [
            f"{what}: {n_bad} elements, max |err| {err:.3e}"
            for what, dtype, err, n_bad, _ in paged
            if n_bad and str(dtype)[6:] == dt]
        fails[f"paged {dt} relative"] = [
            f"{what}: relative {rel:.3e}"
            for what, dtype, _, _, rel in paged
            if str(dtype)[6:] == dt
            and not rel <= pa.PAGED_PARITY_REL[dtype]]
        worst[f"paged {dt}"] = max(rel for _, dtype, _, _, rel in paged
                                   if str(dtype)[6:] == dt)
    try:
        cs.phase_training_parity_bf16(dev)
        train = "pass"
    except AssertionError as e:
        train = f"fail: {e}"
    print(json.dumps({"cases": len(cases), "outputs": 5 * len(cases),
                      "paged_cases": len(list(cs.paged_parity_cases())),
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
        caught = {k: len(v) for k, v in r["fails"].items()}
        caught["bf16_training_parity"] = r["bf16_training_parity"] != "pass"
        summary[name] = {"what": MUTANTS[name][0], "caught": caught,
                         "first_fails": {k: v[:3]
                                         for k, v in r["fails"].items()},
                         "worst_rel": r["worst_rel"],
                         "bf16_training_parity": r["bf16_training_parity"]}
        seen = any(caught.values())
        ok &= (not seen) if name == "none" else seen
        print(f"{name}: {MUTANTS[name][0]}\n  flash outputs failing the "
              f"elementwise bound {caught['elementwise']} of {r['outputs']},"
              f" the relative bound {caught['relative']}; paged cases (of "
              f"{r['paged_cases']}, half per dtype) outside the elementwise"
              f" / relative bound: float32 "
              f"{caught['paged float32 elementwise']} / "
              f"{caught['paged float32 relative']}, bf16 "
              f"{caught['paged bfloat16 elementwise']} / "
              f"{caught['paged bfloat16 relative']}; bf16 training "
              f"parity {r['bf16_training_parity'][:300]}", flush=True)
    print(json.dumps({"card": smi, "ok": ok, "mutants": summary}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
