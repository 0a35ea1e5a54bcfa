"""DataLoader worker process (counterpart of the reference's top-level
``paddle_tpu_worker.py`` and paddle_tpu/io/_worker.py).

Workers are ``forkserver`` children, never ``fork``: CUDA does not survive
a fork once the parent has initialised it. A worker imports the standard
library and numpy, and no torch: the parent starts it on
``runpy.run_path`` of this file (``run_name="__ptt_worker__"``), so no
package ``__init__`` runs, and this file loads the shm ring's binding by
its path too. The job (dataset, collate function, batch indices) comes
pickled with cloudpickle, this file's functions by value; a dataset or a
collate function that uses torch imports it there, on demand. Nothing
here touches CUDA; batches cross the ring as pickled numpy. The parent
hands over the built ring library's path, so a worker never builds it.
"""
from __future__ import annotations

import importlib.util
import os
import pickle
import sys
import time
import traceback

import numpy as np

_DONE_TAG = 2 ** 63 - 1
_ERR_TAG = 2 ** 63 - 2


def np_collate(batch):
    """The default collate rule, in numpy: arrays (and samples with a
    ``numpy()``) stacked, integers as int64, floats as float32, lists,
    tuples and dicts field by field, anything else the list it is.
    ``dataloader.default_collate_fn`` wraps its result in tensors."""
    sample = batch[0]
    if hasattr(sample, "numpy") and not isinstance(sample, np.ndarray):
        return np.stack([np.asarray(s.numpy()) for s in batch])
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, np.float32)
    if isinstance(sample, (list, tuple)):
        return [np_collate(list(s)) for s in zip(*batch)]
    if isinstance(sample, dict):
        return {k: np_collate([d[k] for d in batch]) for k in sample}
    return batch


class UserCollate:
    """A user's collate_fn, its tensors stripped down to numpy for the
    trip through the ring."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, samples):
        return _strip(self.fn(samples))


def _strip(x):
    if hasattr(x, "numpy") and not isinstance(x, np.ndarray):
        return np.asarray(x.detach().cpu().numpy()
                          if hasattr(x, "detach") else x.numpy())
    if isinstance(x, (list, tuple)):
        return type(x)(_strip(v) for v in x)
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items()}
    return x


def _shm_ring_cls():
    """``ShmRing`` from ``shm_ring.py`` beside this file, loaded by path."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "shm_ring.py")
    spec = importlib.util.spec_from_file_location("_ptt_shm_ring", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.ShmRing


def worker_main(ring_name, lib_path, job_blob, worker_id, nw):
    """Produce batches ``worker_id, worker_id + nw, ...`` of the job
    ``(dataset, collate, batches, worker_init_fn)`` into the ring, each
    tagged with its index. The DONE frame carries the worker's telemetry
    (batches produced, busy seconds: dataset access, collate and pickling,
    waits for a free slot excluded; whether CUDA was initialised here,
    which it must not be); an exception goes to the parent as an ERR frame
    with its traceback."""
    ShmRing = _shm_ring_cls()
    dataset, collate, batches, worker_init_fn = pickle.loads(job_blob)
    wring = ShmRing(ring_name, create=False, lib_path=lib_path)
    try:
        if worker_init_fn is not None:
            worker_init_fn(worker_id)
        busy = 0.0
        produced = 0
        for bi in range(worker_id, len(batches), nw):
            t0 = time.perf_counter()
            payload = pickle.dumps(
                collate([dataset[i] for i in batches[bi]]), protocol=4)
            busy += time.perf_counter() - t0
            wring.write(payload, tag=bi)
            produced += 1
        torch = sys.modules.get("torch")
        wring.write(pickle.dumps({
            "n_batches": produced, "busy_s": busy,
            "cuda": bool(torch is not None and torch.cuda.is_initialized()),
            "torch": torch is not None}),
            tag=_DONE_TAG)
    except Exception as e:  # the parent re-raises it
        wring.write(pickle.dumps(
            (type(e).__name__, str(e), traceback.format_exc())),
            tag=_ERR_TAG)
    finally:
        wring.close()


if __name__ == "__ptt_worker__":  # a worker, started by runpy.run_path
    worker_main(*WORKER_ARGS)  # noqa: F821 (given as init_globals)
