#!/usr/bin/env python3
"""Is mesh serving repeatable, and where it leaves the single card's tokens,
why: ``chip_smoke.py`` phase 4 and phase 13, each run twice in one process.

Run on a machine with one NVIDIA GPU, from the repository root:

    python3 tools/torch_mesh_repeat.py

Phase 4's server (gpt3-1.3B bf16, seed 0, ``max_batch_size=8``, its
16-request mix after its warm-up) serves twice with one base key; then
phase 13's mesh server (two ranks on ``cuda:0`` over gloo, mp = 2, that
base key) serves the mix twice, its rank 0 keeping its logits row at the
first position each request leaves phase 4's tokens. Prints which
requests differ between the two runs of each phase, then, for each
request where the mesh's tokens leave phase 4's, one JSON line: the
position, both tokens, and the sampler's view of the single card's logits
there (taken by prefilling the prompt and phase 4's tokens before it) and
of the mesh's: the top two logits' gap, for a sampled request the top two
scores' gap times the temperature and the size of the nucleus, the
decision margin of ``chip_smoke.decision_gap``, and how far apart the two
logits rows are.
"""
from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

VOCAB = 50304


def phase4(dev, base_key=None):
    """Phase 4's server over its mix; its tokens and base key."""
    from paddle_tpu_torch.serving import GenerationServer

    model = cs.build_gpt(dev, 0, dtype="bfloat16")
    srv = GenerationServer(model, max_batch_size=cs.MESH_BATCH,
                           block_size=16, max_queue_size=64, device=dev)
    if base_key is not None:
        srv.engine._base_key = base_key.clone()
    try:
        handles, *_ = cs.serve(srv, cs.serving_requests(VOCAB), VOCAB)
    finally:
        srv.shutdown()
    out = {"tokens": [list(h.tokens) for h in handles],
           "base_key": srv.engine._base_key.clone()}
    del srv, model
    cs.free_memory()
    return out


def view(logits, opts, key, pos):
    """The sampler's view of one logits row at token index ``pos``."""
    from paddle_tpu_torch.serving import sampling

    dev = logits.device
    row = logits.float().reshape(1, -1)
    T = opts.get("temperature", 0.0)
    top = row[0].topk(2).values
    out = {"top2_gap": float(top[0] - top[1])}
    gum = sampling.gumbel_rows(key[None].to(dev),
                               torch.tensor([pos], device=dev), row.shape[-1])
    if T:
        kept = sampling.filter_top_p(
            sampling.filter_top_k(row / T, torch.tensor([0], device=dev)),
            torch.tensor([opts["top_p"]], device=dev))
        scores = (kept + gum)[0].topk(2)
        out.update(score_gap_x_T=float(scores.values[0] - scores.values[1])
                   * T, choice=int(scores.indices[0]),
                   nucleus=int(torch.isfinite(kept).sum()))
    else:
        out["choice"] = int(row[0].argmax())
    out["margin"] = cs.decision_gap(row, T, 0, opts.get("top_p", 1.0), gum)
    return out


def main():
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.serving import GenerationEngine

    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    _build.build()
    a = phase4(dev)
    b = phase4(dev, a["base_key"])
    print("phase 4 twice: requests differing",
          [i for i, (x, y) in enumerate(zip(a["tokens"], b["tokens"]))
           if x != y], flush=True)
    world = cs.two_ranks(dev, tempfile.mkdtemp(prefix="mesh_repeat_"))
    try:
        runs = [world.run(cs.mesh_serving_rank, a["base_key"], a["tokens"],
                          16)[0] for _ in range(2)]
    finally:
        world.close()
    print("phase 13 twice: requests differing",
          [i for i, (x, y) in enumerate(zip(runs[0]["tokens"],
                                             runs[1]["tokens"])) if x != y],
          flush=True)
    reqs = cs.serving_requests(VOCAB)
    eng = GenerationEngine(cs.build_gpt(dev, 0, dtype="bfloat16"),
                           max_batch_size=cs.MESH_BATCH, block_size=16,
                           device=dev)
    eng._base_key = a["base_key"].clone()
    for r, run in enumerate(runs):
        for i, (got, want) in enumerate(zip(run["tokens"], a["tokens"])):
            if got == want:
                continue
            pos = next(j for j, (x, y) in enumerate(zip(got, want)) if x != y)
            prompt, opts = reqs[i]
            eng.prefill(0, list(prompt) + list(want[:pos]),
                        seed=opts["seed"], max_new_tokens=1)
            single = eng.last_prefill_logits[0].clone()
            eng.release(0)
            key = torch.as_tensor(eng._request_key(opts["seed"]))
            mesh = (run["differ"][i][1] if pos else
                    run["first_logits"][i]).to(dev)
            print(json.dumps({
                "run": r, "request": i, "position": pos,
                "phase4_token": want[pos], "mesh_token": got[pos],
                "opts": opts, "single": view(single, opts, key, pos),
                "mesh": view(mesh, opts, key, pos),
                "logits_apart": float((mesh - single).abs().max())}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
