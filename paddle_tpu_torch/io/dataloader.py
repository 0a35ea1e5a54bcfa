"""DataLoader (counterpart of paddle_tpu/io/dataloader.py).

Batches are assembled on the host as numpy and handed out as CPU torch
tensors; the consumer moves them to the card (``jit.TrainStep`` pins and
copies them with ``non_blocking=True``). A background thread prefetches
``prefetch_factor`` batches ahead (``_PrefetchIterator``, the reference's
BufferedReader). ``num_workers > 0`` runs the reference's worker loop in
``forkserver`` processes that pickle numpy batches into
the repository's shared-memory ring (``shm_ring``); the parent puts them
back in order by batch index.

Telemetry (``profiler.registry``): timing ``dataloader.wait`` (how long
the consumer waited for each batch), timing ``dataloader.worker_busy``
(each worker's busy seconds, from its DONE frame), counter
``dataloader.worker_batches``, ``dataloader.worker_cuda_inits``
(workers that initialised CUDA: must stay 0) and
``dataloader.worker_torch_imports`` (workers that imported torch: 0 for a
dataset and collate function of numpy alone); the
``dataloader.worker_start`` timing is the seconds from starting the
workers to the first batch read from the ring.
"""
from __future__ import annotations

import atexit
import itertools
import multiprocessing as mp
import os
import pickle
import queue
import runpy
import sys
import threading
import time
import uuid
import weakref

import cloudpickle
import numpy as np
import torch

from ..profiler import registry as _registry
from . import _worker
from . import dataset as _dataset
from .dataset import BatchSampler, IterableDataset
from .shm_ring import ShmRing, library

# modules whose objects a job pickles by value (both import numpy alone)
_BY_VALUE = (_worker, _dataset)

__all__ = ["DataLoader", "default_collate_fn"]


def stop_servers():
    """Stop what the workers leave running in this process and wait for
    it to end: workers of an iterator that was never closed, the fork
    server they fork from and the resource tracker it started. Left
    alone, the two servers outlive this process for a moment (each stops
    when it reads EOF from its pipe). Runs at exit once workers have
    started; the next ``DataLoader`` iteration starts the servers again."""
    from multiprocessing import forkserver, resource_tracker
    live = [p for p in mp.active_children() if p.daemon]
    for p in live:
        p.terminate()
    for p in live:
        p.join(timeout=5)
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def _from_numpy_tree(x):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_from_numpy_tree(v) for v in x)
    if isinstance(x, dict):
        return {k: _from_numpy_tree(v) for k, v in x.items()}
    return x


def default_collate_fn(batch):
    """Stack samples into batch tensors by the workers' rule
    (``_worker.np_collate``: arrays stacked, integers as int64, floats as
    float32, lists, tuples and dicts field by field, anything else the
    list it is), as CPU tensors. Samples that are torch tensors are
    stacked by torch, keeping their dtype and device."""
    if isinstance(batch[0], torch.Tensor):
        return torch.stack(batch)
    return _from_numpy_tree(_worker.np_collate(batch))


class _PrefetchIterator:
    """Background-thread prefetcher.

    ``close()`` (and ``__del__``) stop the producer thread and close the
    underlying generator so that its ``finally`` runs (workers stopped, the
    ring unlinked) when the consumer abandons iteration early."""

    def __init__(self, gen_fn, depth=2):
        self._q = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._err = None
        self._stop = threading.Event()
        # the thread holds no strong reference to self: a live thread's
        # closure is reachable, so it would keep the iterator alive and
        # __del__ (the cleanup) would never run on an early break
        q, stop, sentinel = self._q, self._stop, self._sentinel
        weak_self = weakref.ref(self)

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def run():
            gen = gen_fn()
            try:
                for item in gen:
                    if not put(item):
                        return
            except BaseException as e:  # re-raised in the consumer
                s = weak_self()
                if s is not None:
                    s._err = e
            finally:
                gen.close()
                # the sentinel must arrive, or a consumer that drained the
                # queue would wait forever
                put(sentinel)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def close(self):
        self._stop.set()

    def __del__(self):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        # bounded gets with a liveness check: a dead producer ends the
        # iteration or raises, never blocks forever
        t0 = time.perf_counter()
        while True:
            try:
                item = self._q.get(timeout=1.0)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    try:  # the sentinel may have arrived just before
                        item = self._q.get_nowait()
                        break
                    except queue.Empty:
                        if self._err is not None:
                            raise self._err
                        raise StopIteration from None
        if item is self._sentinel:
            if self._err is not None:
                raise self._err
            raise StopIteration
        # the stall the consumer saw for this batch
        _registry.timing("dataloader.wait", time.perf_counter() - t0)
        return item


class DataLoader:
    """``DataLoader(dataset, batch_size=..., shuffle=..., num_workers=...)``:
    an iterable of batches (CPU torch tensors, in the structure the samples
    have). ``num_workers > 0`` produces batches in worker processes through
    the shared-memory ring; an ``IterableDataset`` is read in this
    process."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.worker_init_fn = worker_init_fn
        self._shm_slot_size = 32 << 20
        self.use_buffer_reader = use_buffer_reader
        self.prefetch_factor = prefetch_factor
        self._iterable_ds = isinstance(dataset, IterableDataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        if self._iterable_ds:
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_ds:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    def _gen(self):
        if self._iterable_ds:
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                yield self.collate_fn(batch)
        else:
            for indices in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in indices])

    # ------------------------------------------------ multiprocess workers
    def _start_workers(self, ring_name, lib_path, batches):
        nw = self.num_workers
        ctx = mp.get_context("forkserver")
        # the fork server imports numpy once and every worker forks from
        # it; neither imports torch (the worker file runs by path). It
        # takes effect when the server starts, once per process.
        ctx.set_forkserver_preload(["numpy"])
        atexit.unregister(stop_servers)
        atexit.register(stop_servers)
        collate = (_worker.np_collate
                   if self.collate_fn is default_collate_fn
                   else _worker.UserCollate(self.collate_fn))
        # by value: a dataset defined in __main__ reaches the workers, and
        # the worker file's collate functions and this package's datasets
        # (numpy only) need no package import there
        for mod in _BY_VALUE:
            cloudpickle.register_pickle_by_value(mod)
        try:
            job_blob = cloudpickle.dumps(
                (self.dataset, collate, batches, self.worker_init_fn))
        finally:
            for mod in _BY_VALUE:
                cloudpickle.unregister_pickle_by_value(mod)
        procs = [ctx.Process(
            target=runpy.run_path, args=(_worker.__file__,),
            kwargs={"run_name": "__ptt_worker__", "init_globals": {
                "WORKER_ARGS": (ring_name, str(lib_path), job_blob, w, nw)}},
            daemon=True) for w in range(nw)]
        # a child must not import the user's __main__ again (the job goes
        # by value; re-running a training script there would be waste or
        # worse): hide it while the children start
        main_mod = sys.modules.get("__main__")
        saved = (getattr(main_mod, "__file__", None),
                 getattr(main_mod, "__spec__", None))
        try:
            if main_mod is not None:
                if saved[0] is not None:
                    del main_mod.__file__
                main_mod.__spec__ = None
            for p in procs:
                p.start()
        finally:
            if main_mod is not None:
                if saved[0] is not None:
                    main_mod.__file__ = saved[0]
                main_mod.__spec__ = saved[1]
        return procs

    def _gen_multiprocess(self):
        """Batches from ``num_workers`` processes through the shm ring, in
        batch order. A worker's exception is re-raised here with its
        traceback; a worker that dies without one raises too. However the
        iteration ends (done, error, or abandoned early), the workers are
        stopped and the ring is unlinked."""
        batches = list(self.batch_sampler)
        nw = self.num_workers
        lib_path = library()
        # a fresh name per iteration: creating a ring unlinks any segment
        # of the same name, which would destroy a live iterator's ring
        ring_name = f"/ptt_dl_{os.getpid()}_{uuid.uuid4().hex[:12]}"
        ring = ShmRing(ring_name, n_slots=max(2 * nw, 4),
                       slot_size=self._shm_slot_size, lib_path=lib_path)
        t_start = time.perf_counter()
        procs = []
        try:
            procs = self._start_workers(ring_name, lib_path, batches)
            pending = {}
            done = [0]
            next_bi = 0
            while next_bi < len(batches):
                while next_bi not in pending:
                    msg = self._read(ring, procs, done)
                    if msg is None:
                        continue
                    payload, tag = msg
                    if tag == _worker._DONE_TAG:
                        if done[0] == nw:
                            raise RuntimeError(
                                f"all workers exited but batch {next_bi} "
                                f"was never produced")
                        continue
                    if next_bi == 0 and not pending:
                        _registry.timing("dataloader.worker_start",
                                         time.perf_counter() - t_start)
                    pending[tag] = payload
                yield _from_numpy_tree(pickle.loads(pending.pop(next_bi)))
                next_bi += 1
            # every worker's DONE frame, for its telemetry
            while done[0] < nw and self._read(ring, procs, done,
                                              drain=True) is not None:
                pass
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.join(timeout=5)
            ring.close()

    @staticmethod
    def _read(ring, procs, done, drain=False):
        """One frame from the ring, or None after a quiet 5 s (1 s when
        draining). An ERR frame raises; a DONE frame is counted in ``done``
        and its telemetry recorded; a worker dead without a frame raises
        (a drain just ends)."""
        msg = ring.read(timeout_ms=1000 if drain else 5000)
        if msg is None:
            dead = [p for p in procs if not p.is_alive() and p.exitcode != 0]
            if dead and not drain:
                raise RuntimeError(f"DataLoader worker died with exit code "
                                   f"{dead[0].exitcode}")
            return None
        payload, tag = msg
        if tag == _worker._ERR_TAG:
            name, message, tb = pickle.loads(payload)
            raise RuntimeError(f"DataLoader worker raised {name}: "
                               f"{message}\n{tb}")
        if tag == _worker._DONE_TAG:
            info = pickle.loads(payload)
            _registry.timing("dataloader.worker_busy", float(info["busy_s"]))
            _registry.inc("worker_batches", int(info["n_batches"]),
                          scope="dataloader")
            _registry.inc("worker_cuda_inits", int(info["cuda"]),
                          scope="dataloader")
            _registry.inc("worker_torch_imports", int(info["torch"]),
                          scope="dataloader")
            done[0] += 1
        return msg

    def __iter__(self):
        if self.num_workers and self.num_workers > 0 \
                and not self._iterable_ds:
            gen = self._gen_multiprocess
        else:
            gen = self._gen
        if self.use_buffer_reader:
            return _PrefetchIterator(gen, depth=self.prefetch_factor)
        return gen()
