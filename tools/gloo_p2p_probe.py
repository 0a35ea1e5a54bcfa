"""What gloo does with a CUDA tensor sent point to point, without the
port's host staging: two processes on one card join a gloo group, rank 0
calls ``torch.distributed.send`` on a CUDA tensor and rank 1
``torch.distributed.recv`` into one. Each rank reports whether the call
raised (and what), hung past the deadline, or returned, and rank 1
whether the bytes it received are the ones sent.

Run on a machine with a GPU:  python3 tools/gloo_p2p_probe.py
Prints one JSON line: {"rank0": ..., "rank1": ...}. The port's
``collective`` module stages every CUDA tensor of a point-to-point call
over gloo through host memory whatever this shows; the probe records why.
"""
import json
import multiprocessing as mp
import os
import sys
import tempfile


def _rank(rank, init, out):
    import torch
    import torch.distributed as dist

    try:
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=2)
        x = torch.arange(4096, dtype=torch.float32, device="cuda:0")
        if rank == 0:
            dist.send(x, dst=1)
            res = {"returned": True}
        else:
            y = torch.zeros_like(x)
            dist.recv(y, src=0)
            torch.cuda.synchronize()
            res = {"returned": True, "right_bytes": bool(torch.equal(x, y))}
        dist.destroy_process_group()
    except BaseException as e:  # the finding is the exception itself
        res = {"raised": f"{type(e).__name__}: {str(e)[:300]}"}
    out.put((rank, res))


def main(deadline=60.0):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    init = "file://" + os.path.join(tempfile.mkdtemp(), "rdzv")
    procs = [ctx.Process(target=_rank, args=(r, init, out))
             for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    for p in procs:
        p.join(deadline)
    while not out.empty():
        r, res = out.get()
        got[f"rank{r}"] = res
    for r, p in enumerate(procs):
        if p.is_alive():
            p.kill()
            p.join()
            got.setdefault(f"rank{r}", {"hung": deadline})
        elif f"rank{r}" not in got:
            got[f"rank{r}"] = {"exit_code": p.exitcode}
    print(json.dumps(got))
    return 0


if __name__ == "__main__":
    sys.exit(main())
