"""A world of ranks for tests: ``n`` processes joined into one gloo process
group over a ``file://`` rendezvous (no port to race for), kept alive so
that many test cases run on the same world.

``World(n, root)`` starts the ranks (``spawn`` children that import torch
and this package, nothing else of the caller's) on the CPU, or with
``device="cuda:0", backend="gloo"`` every rank on one card, gloo carrying
its CUDA tensors, and waits for every rank to join. ``world.run(fn, *args)`` sends ``fn`` and its arguments to every
rank, pickled with cloudpickle (``fn``'s module by value, so the ranks do
not import the caller's module), runs ``fn(*args)`` on each, and returns
the ranks' results in rank order. Every wait has a deadline: a rank that
raises, or a world that does not answer within ``timeout`` seconds (a
hung collective), fails that call with the ranks' tracebacks; the world
is then stopped and the next call starts a fresh one. ``close()`` stops
the ranks, waits for them, and closes and drops the queues, whose
semaphores are then unlinked at once (a resource tracker stopped after
``close()`` finds none left to clean up).
"""
from __future__ import annotations

import gc
import multiprocessing as mp
import os
import pickle
import queue
import sys
import time
import traceback
import uuid

__all__ = ["World"]


def _rank_main(rank, n, init_method, tasks, results, timeout, device,
               backend):
    os.environ["PADDLE_TRAINERS_NUM"] = str(n)
    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    try:
        import torch

        torch.set_num_threads(1)
        from paddle_tpu_torch.distributed import parallel_env

        parallel_env.init_parallel_env(device=device, backend=backend,
                                       init_method=init_method,
                                       timeout=timeout)
        results.put((rank, True, "ready"))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    while True:
        blob = tasks.get()
        if blob is None:
            break
        try:
            fn, args = pickle.loads(blob)
            results.put((rank, True, fn(*args)))
        except BaseException:
            results.put((rank, False, traceback.format_exc()))
    import torch.distributed as dist

    dist.destroy_process_group()


class World:
    def __init__(self, n, root, timeout=60.0, device="cpu", backend=None):
        self.n = int(n)
        self.root = str(root)
        self.timeout = float(timeout)
        self.device, self.backend = device, backend
        self._procs = []
        self._start()

    def _start(self):
        ctx = mp.get_context("spawn")
        self._tasks = [ctx.Queue() for _ in range(self.n)]
        self._results = ctx.Queue()
        init = "file://" + os.path.join(self.root,
                                        f"rdzv-{uuid.uuid4().hex}")
        self._procs = [ctx.Process(
            target=_rank_main, args=(r, self.n, init, self._tasks[r],
                                     self._results, self.timeout,
                                     self.device, self.backend),
            daemon=True) for r in range(self.n)]
        # a child must not run the caller's __main__ again
        main = sys.modules.get("__main__")
        saved = (getattr(main, "__file__", None),
                 getattr(main, "__spec__", None))
        try:
            if main is not None:
                if saved[0] is not None:
                    del main.__file__
                main.__spec__ = None
            for p in self._procs:
                p.start()
        finally:
            if main is not None:
                if saved[0] is not None:
                    main.__file__ = saved[0]
                main.__spec__ = saved[1]
        self._gather("joining the process group")

    def _gather(self, what):
        """Every rank's result, in rank order, within ``timeout``."""
        got = {}
        deadline = time.monotonic() + self.timeout
        failed = None
        while len(got) < self.n:
            remaining = deadline - time.monotonic()
            if failed is not None:  # the others may wait on the failed one
                remaining = min(remaining, failed - time.monotonic())
            try:
                rank, ok, value = self._results.get(
                    timeout=max(remaining, 0.01))
            except queue.Empty:
                break
            got[rank] = (ok, value)
            if not ok and failed is None:
                failed = time.monotonic() + 5.0
        if len(got) == self.n and all(ok for ok, _ in got.values()):
            return [got[r][1] for r in range(self.n)]
        self.close()
        lines = [f"rank {r}: {'no answer' if r not in got else got[r][1]}"
                 for r in range(self.n)
                 if r not in got or not got[r][0]]
        raise RuntimeError(f"world of {self.n} failed {what}:\n"
                           + "\n".join(lines))

    def run(self, fn, *args):
        """``[fn(*args) on rank r for r in range(n)]``."""
        import cloudpickle

        if not self._procs:
            self._start()
        mod = sys.modules.get(getattr(fn, "__module__", None))
        by_value = mod is not None and mod.__name__ != "__main__" and \
            not mod.__name__.startswith("paddle_tpu_torch")
        if by_value:
            cloudpickle.register_pickle_by_value(mod)
        try:
            blob = cloudpickle.dumps((fn, args))
        finally:
            if by_value:
                cloudpickle.unregister_pickle_by_value(mod)
        for q in self._tasks:
            q.put(blob)
        return self._gather(f"running {getattr(fn, '__name__', fn)}")

    def close(self):
        for q in self._tasks:
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        deadline = time.monotonic() + 5.0
        for p in self._procs:
            p.join(timeout=max(deadline - time.monotonic(), 0.01))
        killed = False
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
                killed = True
        self._procs = []
        # close the queues, wait for their feeder threads (which hold two
        # of each queue's semaphores) and drop them: the semaphores are
        # unlinked now, not left to a resource tracker that may be stopped
        # first. A killed rank may leave data unread: nothing waits for it.
        for q in self._tasks + ([self._results]
                               if self._results is not None else []):
            if killed:
                q.cancel_join_thread()
            q.close()
            q.join_thread()
        self._tasks, self._results, q = [], None, None
        gc.collect()
