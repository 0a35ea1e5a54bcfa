"""paddle_tpu_torch.io against paddle_tpu.io on the CPU.

Samplers draw from numpy's global generator as the reference's do: under
the same ``np.random.seed`` every index order is equal, exactly. Datasets,
``random_split``, ``default_collate_fn``, an ``IterableDataset`` and the
DataLoader's batches at ``num_workers=0`` and ``2`` (the shared-memory
ring) equal the reference's, exactly. Workers: an error is re-raised in
the parent with its traceback, a worker that dies raises, an early break
leaves no ring in ``/dev/shm``, a process that used workers leaves
neither its fork server nor its resource tracker running once it has
exited, and the telemetry counts every batch and
worker. The ring library is built from ``csrc/shm_ring`` into ``build/``,
never into the JAX package.
"""
import gc
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from paddle_tpu import io as jio  # noqa: E402
from paddle_tpu_torch import io as tio  # noqa: E402
from paddle_tpu_torch.io import shm_ring  # noqa: E402
from paddle_tpu_torch.profiler import registry  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _np(x):
    return np.asarray(x.numpy()) if hasattr(x, "numpy") else np.asarray(x)


def _flat(batch):
    if isinstance(batch, (list, tuple)):
        return [a for b in batch for a in _flat(b)]
    if isinstance(batch, dict):
        return [a for k in sorted(batch) for a in _flat(batch[k])]
    return [_np(batch)]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        fg, fw = _flat(g), _flat(w)
        assert len(fg) == len(fw)
        for a, b in zip(fg, fw):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def _data(n=20):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    y = (np.arange(n) % 3).astype(np.int64)
    return x, y


SAMPLERS = {
    "random": lambda io, ds: io.RandomSampler(ds),
    "random_replacement": lambda io, ds: io.RandomSampler(
        ds, replacement=True, num_samples=7),
    "random_num_samples": lambda io, ds: io.RandomSampler(ds, num_samples=5),
    "sequence": lambda io, ds: io.SequenceSampler(ds),
    "weighted": lambda io, ds: io.WeightedRandomSampler(
        np.linspace(0.1, 1.0, len(ds)), 9),
    "weighted_no_replacement": lambda io, ds: io.WeightedRandomSampler(
        np.linspace(0.1, 1.0, len(ds)), 6, replacement=False),
    "batch_shuffle": lambda io, ds: io.BatchSampler(ds, shuffle=True,
                                                     batch_size=3),
    "batch_drop_last": lambda io, ds: io.BatchSampler(
        ds, batch_size=3, drop_last=True),
    "batch_of_sampler": lambda io, ds: io.BatchSampler(
        sampler=io.RandomSampler(ds), batch_size=4),
    "distributed_shuffle_rank1": lambda io, ds: _dist(io, ds, 1),
    "distributed_rank0_default": lambda io, ds: io.DistributedBatchSampler(
        ds, batch_size=3, num_replicas=1, rank=0),
}


def _dist(io, ds, rank):
    s = io.DistributedBatchSampler(ds, batch_size=2, num_replicas=3,
                                   rank=rank, shuffle=True, drop_last=True)
    s.set_epoch(4)
    return s


@pytest.mark.parametrize("kind", list(SAMPLERS))
def test_sampler_order_matches_reference(kind):
    x, y = _data(17)
    orders = []
    for io in (tio, jio):
        np.random.seed(5)
        s = SAMPLERS[kind](io, io.TensorDataset([x, y]))
        orders.append((list(s), len(s)))
    assert orders[0] == orders[1]


def test_distributed_sampler_without_rank_is_rank_0_of_1():
    s = tio.DistributedBatchSampler(list(range(10)), batch_size=4)
    assert (s.nranks, s.local_rank) == (1, 0)
    assert list(s) == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]


def test_datasets_and_random_split_match_reference():
    x, y = _data(12)
    out = []
    for io in (tio, jio):
        np.random.seed(2)
        td = io.TensorDataset([x, y])
        comp = io.ComposeDataset([td, io.TensorDataset([y])])
        concat = io.ConcatDataset([td, io.Subset(td, [3, 1])])
        parts = io.random_split(td, [0.5, 0.5])
        items = [td[4], comp[2], concat[13], concat[-1], parts[1][0],
                 [len(comp), len(concat), len(parts[0]), len(parts[1])]]
        out.append([np.asarray(a).tolist() for it in items for a in it])
    assert out[0] == out[1]


COLLATE = {
    "arrays": lambda i: np.full((2, 3), i, np.float32),
    "ints": lambda i: int(i),
    "floats": lambda i: float(i) / 3,
    "tuple": lambda i: (np.arange(4) + i, np.int64(i)),
    "dict": lambda i: {"a": np.float32(i), "b": [np.arange(2) * i]},
}


@pytest.mark.parametrize("kind", list(COLLATE))
def test_default_collate_matches_reference(kind):
    samples = [COLLATE[kind](i) for i in range(4)]
    got = tio.default_collate_fn(samples)
    want = jio.default_collate_fn(samples)
    _assert_batches_equal([got], [want])
    assert all(isinstance(t, torch.Tensor) for t in
               (got if isinstance(got, list) else
                list(got.values()) if isinstance(got, dict) else [got])
               if not isinstance(t, list))


class _Count(tio.IterableDataset):
    def __init__(self, n):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.float32(i), np.int64(i % 2)


class _RefCount(jio.IterableDataset):
    def __init__(self, n):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.float32(i), np.int64(i % 2)


@pytest.mark.parametrize("drop_last", [False, True])
def test_iterable_dataset_matches_reference(drop_last):
    got = list(tio.DataLoader(_Count(10), batch_size=3, drop_last=drop_last))
    want = list(jio.DataLoader(_RefCount(10), batch_size=3,
                               drop_last=drop_last))
    _assert_batches_equal(got, want)
    chained = list(iter(tio.ChainDataset([_Count(2), _Count(3)])))
    assert [float(a) for a, _ in chained] == [0, 1, 0, 1, 2]


def test_dataloader_batches_match_reference_workers_0_and_2():
    x, y = _data(22)
    registry.reset("dataloader")
    registry.reset("timings")
    runs = {}
    for name, io, nw in (("ref", jio, 0), ("port0", tio, 0),
                         ("port2", tio, 2)):
        np.random.seed(9)
        dl = io.DataLoader(io.TensorDataset([x, y]), batch_size=4,
                           shuffle=True, num_workers=nw)
        runs[name] = list(dl)
    _assert_batches_equal(runs["port0"], runs["ref"])
    _assert_batches_equal(runs["port2"], runs["ref"])
    assert isinstance(runs["port2"][0][0], torch.Tensor)
    # telemetry: every batch and both workers counted, waits per batch of
    # both port loaders, one worker start
    t = registry.timings("timings")
    assert registry.counters("dataloader")["worker_batches"] == 6
    assert registry.counters("dataloader")["worker_cuda_inits"] == 0
    assert t["timings.dataloader.worker_busy"]["count"] == 2
    assert t["timings.dataloader.wait"]["count"] == 12
    assert t["timings.dataloader.worker_start"]["count"] == 1


class _Bad(tio.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("boom at 5")
        return np.float32(i)


class _Dies(tio.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        os._exit(3)


def test_worker_error_is_reraised_and_death_raises():
    with pytest.raises(RuntimeError, match="boom at 5") as info:
        list(tio.DataLoader(_Bad(), batch_size=2, num_workers=2))
    assert "Traceback" in str(info.value)
    with pytest.raises(RuntimeError, match="died with exit code 3"):
        list(tio.DataLoader(_Dies(), batch_size=2, num_workers=1))


def _rings():
    """This process's DataLoader rings (other test processes may have
    theirs)."""
    return {f for f in os.listdir("/dev/shm")
            if f.startswith(f"ptt_dl_{os.getpid()}_")}


def test_early_break_leaves_no_ring():
    x, y = _data(40)
    before = _rings()
    it = iter(tio.DataLoader(tio.TensorDataset([x, y]), batch_size=2,
                             num_workers=2))
    first = next(it)
    assert len(_rings() - before) == 1  # the live iterator's ring
    np.testing.assert_array_equal(first[0].numpy(), x[:2])
    del it
    gc.collect()
    deadline = time.monotonic() + 10
    while _rings() - before and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not _rings() - before


_LEAVES_NOTHING = """
import multiprocessing.forkserver as fs, multiprocessing.resource_tracker as rt
import numpy as np
from paddle_tpu_torch import io
it = iter(io.DataLoader(io.TensorDataset([np.arange(16).reshape(8, 2)]),
                        batch_size=2, num_workers=2))
next(it)  # an iterator left open at exit
print(fs._forkserver._forkserver_pid, rt._resource_tracker._pid, flush=True)
"""


def _running(pid):
    try:
        stat = pathlib.Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


def test_workers_servers_end_with_the_process():
    """The fork server and the resource tracker end before the process
    that started them does, not a moment after (a supervisor that checks
    for leftover processes at exit would find them)."""
    out = subprocess.run([sys.executable, "-c", _LEAVES_NOTHING], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    pids = [int(p) for p in out.stdout.split()]
    assert len(pids) == 2 and all(pids)
    assert not [p for p in pids if _running(p)]


def test_ring_library_is_built_into_build_and_round_trips(tmp_path):
    so = shm_ring.library()
    assert so.parent == REPO / "build" and re.fullmatch(
        r"shm_ring-[0-9a-f]{16}\.so", so.name)
    ring = shm_ring.ShmRing(f"/ptt_test_{os.getpid()}", n_slots=2,
                            slot_size=1 << 10, lib_path=so)
    try:
        ring.write(b"hello", tag=7)
        assert ring.read(timeout_ms=100) == (b"hello", 7)
        assert ring.read(timeout_ms=10) is None
        with pytest.raises(ValueError, match="exceeds slot size"):
            ring.write(b"x" * 2048)
    finally:
        ring.close()
    assert not any(f.startswith(f"ptt_test_{os.getpid()}")
                   for f in os.listdir("/dev/shm"))


@pytest.mark.parametrize("module", ["io/dataloader.py", "io/_worker.py",
                                    "io/shm_ring.py", "hapi/model.py"])
def test_port_imports_no_reference_worker_module(module):
    src = (REPO / "paddle_tpu_torch" / module).read_text()
    assert not re.search(r"^\s*(import|from)\s+paddle_tpu_worker\b", src,
                         re.MULTILINE)
    assert "make" not in re.findall(r'"(make)"', src)


def test_numpy_only_workers_import_no_torch():
    # the reference's workers import the standard library and numpy
    # alone; the port's run their file by path, so a dataset and collate
    # function of numpy (a local class, and the package's TensorDataset)
    # leave torch out of every worker's sys.modules, while a collate
    # function returning torch tensors imports it there on demand
    class Squares:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            return np.full(3, i * i, np.float32)

    def torch_collate(samples):
        return torch.stack([torch.as_tensor(s[0]) for s in samples])

    ds = tio.TensorDataset([np.arange(16).reshape(8, 2)])
    cases = [(Squares(), None, 0), (ds, None, 0), (ds, torch_collate, 2)]
    for dataset, collate, want in cases:
        registry.reset("dataloader")
        got = [b for b in tio.DataLoader(dataset, batch_size=2,
                                         num_workers=2, collate_fn=collate)]
        c = registry.counters("dataloader")
        assert c["worker_batches"] == 4 and c["worker_cuda_inits"] == 0
        assert c["worker_torch_imports"] == want
        assert len(got) == 4 and isinstance(got[0], (torch.Tensor, list))
    np.testing.assert_array_equal(got[1].numpy(), [[4, 5], [6, 7]])
