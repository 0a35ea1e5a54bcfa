"""Fault-tolerant checkpoint engine (counterpart of
paddle_tpu/incubate/checkpoint.py), in the same on-disk format, so that a
checkpoint written by either package loads in the other.

Layout, one directory per step under the caller's base directory::

    <dir>/ckpt-00000042/
        data-rank00000.pkl        payload: a pickled saveable nest
        data-rank00001.pkl        (per-rank shards in distributed runs)
        MANIFEST-rank00001.json   per-shard integrity record (ranks > 0)
        MANIFEST.json             rank 0's record and the commit marker

Each rank of a distributed run writes its own payload and manifest
(``CheckpointManager(rank=, world_size=, shard=)``); with ``shard=True``
a rank's payload holds its flat chunk of every tensor
(``framework._shard_saveable``, the reference's layout), and
``load_resharded`` merges every saved rank's payload. Write order: the
payload through tmp + fsync + rename, then the manifest the same way,
last. The manifest is the commit marker: a crash at
any point leaves a valid checkpoint or one that the loaders skip (missing
manifest, size or crc32 mismatch, truncated pickle).

MANIFEST.json (schema 1)::

    {"schema": 1, "step": 42, "epoch": 3, "time": 1722700000.0,
     "rank": 0, "world_size": 1, "sharded": false,
     "files": {"data-rank00000.pkl": {"crc32": 912..., "bytes": 10240}},
     "rng": null, "torch_rng": {"default": "...", "model": "..."},
     "user": {...}}

``"rng"`` is the reference's threefry key; the port writes null, which the
reference skips, and keeps its own ``torch.Generator`` states (the default
CPU generator, the CUDA ones when CUDA is up, and a model's dropout
generator) as hex strings under ``"torch_rng"``. Restoring a reference
checkpoint ignores its threefry key, with an explainer record.

What is saved is the reference's: ``capture_training_state`` gives the
model's and the optimizer's state in the reference's names and layout
(``convert.state_to_paddle_tpu``), and ``framework`` writes bf16 tensors as
float32. The loaders return numpy arrays in that layout;
``restore_training_state`` converts them back and copies them into the
live tensors in place, so tensor identity is kept.

Saves are asynchronous by default: ``CheckpointManager.save`` snapshots
the tensors to host numpy on the caller's thread (the one part that must
see a consistent step boundary) and hands pickling, checksumming and the
disk writes to one writer thread. Retention keeps the newest
``max_to_keep`` committed checkpoints.

Telemetry: ``checkpoint.saves/async_saves/sharded_saves/restores/
skipped_corrupt/pruned/emergency_saves/reshard_loads`` counters,
``checkpoint.save.snapshot/save.write/restore`` timings, and
``checkpoint_save``/``checkpoint_restore``/``checkpoint_skip`` explainer
records.

Fault injection: ``truncate_checkpoint`` (``testing.faults``) tears a
payload right after its commit, so loads exercise the skip-and-fall-back
path; ``CheckpointHook.on_step_end`` fires ``kill_at_step``,
``rank_preempt`` and ``step_hang``, in that order, before its step
boundary.

Elastic training: ``CheckpointHook(elastic=ctx)`` takes a
``distributed.fleet.elastic.ElasticTrainContext``. Each step boundary
re-arms the step watchdog; a local SIGTERM is announced through the
store, or a peer's notice adopted, so every rank writes its emergency
shard at the fleet's target step after a coordinated barrier (the
manifest records the local step, ``coordinated`` and
``preempt_target``); and the generation fence runs before every save, so
a rank of a stale world returns "fenced" and writes nothing. With
``reshard=True``, ``restore`` resumes a checkpoint written at another
world size (``load_resharded``).
"""
from __future__ import annotations

import json
import os
import pickle
import queue
import re
import shutil
import signal
import threading
import time
import zlib

import torch

from .. import convert
from ..framework import (_from_saveable, _merge_saveable, _shard_saveable,
                         _to_saveable, atomic_write_bytes)
from ..profiler import explainer as _explain
from ..profiler import registry as _registry
from ..testing import faults as _faults

__all__ = ["CheckpointManager", "CheckpointHook", "load_latest",
           "load_resharded", "save_checkpoint", "latest_step", "list_steps",
           "capture_training_state", "restore_training_state",
           "WorldSizeMismatchError"]

SCHEMA = 1
_CKPT_RE = re.compile(r"^ckpt-(\d{8})$")

_counters = _registry.scoped_counters("checkpoint", {
    "saves": 0, "async_saves": 0, "sharded_saves": 0, "restores": 0,
    "skipped_corrupt": 0, "pruned": 0, "emergency_saves": 0,
    "reshard_loads": 0})


class WorldSizeMismatchError(RuntimeError):
    """A checkpoint written at world size N was opened raw by a job of
    world size M, or a sharded checkpoint was opened raw. Carries both
    sizes and names the entry point that merges the shards."""

    def __init__(self, saved_world_size, world_size, step=None, dir=None,
                 sharded=False):
        self.saved_world_size = int(saved_world_size)
        self.world_size = int(world_size)
        self.step = step
        self.dir = dir
        self.sharded = bool(sharded)
        where = f" (step {step})" if step is not None else ""
        what = "a sharded checkpoint" if sharded else "a checkpoint"
        super().__init__(
            f"{what}{where} saved at world_size={self.saved_world_size} "
            f"cannot load raw into a job with world_size={self.world_size}."
            f" Pass reshard=True (CheckpointManager.load_latest / "
            f"CheckpointHook) or call paddle_tpu_torch.incubate.checkpoint"
            f".load_resharded({dir!r}, rank, world_size) to merge the "
            "per-rank payloads through the manifests.")


def _ckpt_dir(base, step):
    return os.path.join(base, f"ckpt-{int(step):08d}")


def _payload_name(rank):
    return f"data-rank{int(rank):05d}.pkl"


def _manifest_name(rank):
    return "MANIFEST.json" if rank == 0 \
        else f"MANIFEST-rank{int(rank):05d}.json"


def list_steps(base):
    """Committed-or-partial checkpoint steps under ``base``, ascending."""
    try:
        entries = os.listdir(base)
    except OSError:
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT_RE.match, entries)
                  if m)


# -- RNG state ---------------------------------------------------------------

def _model_generator(network):
    """The ``torch.Generator`` a model draws its dropout from, or None."""
    if network is None:
        return None
    return next((m.generator for m in network.modules()
                 if isinstance(getattr(m, "generator", None),
                               torch.Generator)), None)


def _hex(state):
    return bytes(state.numpy()).hex()


def _unhex(s):
    return torch.frombuffer(bytearray.fromhex(s), dtype=torch.uint8)


def _rng_snapshot(network=None):
    """torch's generator states as JSON-able hex strings."""
    blob = {"default": _hex(torch.get_rng_state())}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        blob["cuda"] = [_hex(s) for s in torch.cuda.get_rng_state_all()]
    gen = _model_generator(network)
    if gen is not None:
        blob["model"] = _hex(gen.get_state())
    return blob


def _rng_restore(manifest, network=None):
    if manifest.get("rng"):
        _explain.record(
            "checkpoint_rng_skipped", op="restore",
            why="the checkpoint carries a threefry key (written by "
                "paddle_tpu); torch's generators cannot take it and keep "
                "their state", step=manifest.get("step"))
    blob = manifest.get("torch_rng") or {}
    if "default" in blob:
        torch.set_rng_state(_unhex(blob["default"]))
    if "cuda" in blob and torch.cuda.is_available():
        torch.cuda.set_rng_state_all([_unhex(s) for s in blob["cuda"]])
    gen = _model_generator(network)
    if gen is not None and "model" in blob:
        gen.set_state(_unhex(blob["model"]))


# -- manager -----------------------------------------------------------------

class CheckpointManager:
    """Atomic, asynchronous checkpoint writer with rolling retention::

        mgr = CheckpointManager(dir, max_to_keep=3)
        mgr.save(state, step=i)        # returns before the disk write
        ...
        mgr.wait()                     # every queued save is durable

    ``state`` is a saveable nest (``framework``); its tensors are copied to
    host numpy on the calling thread. In a distributed run each rank keeps
    one manager with its ``rank`` and ``world_size`` (None: the process
    group's) and writes its own payload and manifest; ``shard=True`` keeps
    only the rank's flat chunk of every tensor (the reference's layout,
    merged back by :func:`load_resharded`). Only rank 0 prunes."""

    def __init__(self, dir, max_to_keep=3, async_save=True, rank=None,
                 world_size=None, shard=False):
        from ..distributed import parallel_env

        self.dir = str(dir)
        self.max_to_keep = max(1, int(max_to_keep)) if max_to_keep else None
        self.rank = int(parallel_env.get_rank() if rank is None else rank)
        self.world_size = int(parallel_env.get_world_size()
                              if world_size is None else world_size)
        self.shard = bool(shard) and self.world_size > 1
        self._async = bool(async_save)
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._writer = None
        self._error = None
        os.makedirs(self.dir, exist_ok=True)

    # -- save ----------------------------------------------------------------
    def save(self, state, step, epoch=None, user_meta=None, block=False,
             network=None):
        """Snapshot ``state`` and commit it as checkpoint ``step``.

        Returns once the snapshot (device-to-host copy) is taken; pickling
        and the writes happen on the writer thread unless the manager is
        synchronous or ``block=True``. A failed write raises at the next
        ``save()`` or ``wait()``. ``network``: a model whose dropout
        generator state rides in the manifest with torch's own."""
        self._reraise()
        with _registry.time_block("save.snapshot", scope="checkpoint"):
            payload = _to_saveable(state)
            if self.shard:
                payload = _shard_saveable(payload, self.rank,
                                          self.world_size)
                _counters["sharded_saves"] += 1
            rng = _rng_snapshot(network)
        job = {"step": int(step), "epoch": epoch, "payload": payload,
               "torch_rng": rng, "user": user_meta}
        if self._async and not block:
            if self._writer is None:
                self._writer = threading.Thread(
                    target=self._writer_loop, daemon=True,
                    name="paddle-tpu-torch-ckpt-writer")
                self._writer.start()
            self._q.put(job)  # maxsize bounds the snapshots in flight
            _counters["async_saves"] += 1
        else:
            self._write(job)
        return _ckpt_dir(self.dir, step)

    def wait(self):
        """Block until every queued save is durable; raise the first
        writer error if there was one."""
        if self._writer is not None:
            self._q.join()
        self._reraise()

    def _reraise(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _writer_loop(self):
        while True:
            job = self._q.get()
            try:
                self._write(job)
            except BaseException as e:  # raised at the next save()/wait()
                self._error = e
            finally:
                self._q.task_done()

    def _write(self, job):
        t0 = time.perf_counter()
        step = job["step"]
        d = _ckpt_dir(self.dir, step)
        os.makedirs(d, exist_ok=True)
        blob = pickle.dumps(job["payload"], protocol=4)
        payload_path = os.path.join(d, _payload_name(self.rank))
        atomic_write_bytes(blob, payload_path)
        if _faults.ACTIVE:
            # a torn write, after the commit, so that loads meet it
            _faults.fire("truncate_checkpoint", path=payload_path)
        manifest = {
            "schema": SCHEMA, "step": step, "epoch": job["epoch"],
            "time": time.time(), "rank": self.rank,
            "world_size": self.world_size, "sharded": self.shard,
            "files": {_payload_name(self.rank):
                      {"crc32": zlib.crc32(blob), "bytes": len(blob)}},
            "rng": None, "torch_rng": job["torch_rng"], "user": job["user"],
        }
        atomic_write_bytes(json.dumps(manifest, indent=1).encode(),
                           os.path.join(d, _manifest_name(self.rank)))
        dt = time.perf_counter() - t0
        _registry.timing("save.write", dt, scope="checkpoint")
        _counters["saves"] += 1
        _explain.record("checkpoint_save", op="save",
                        why=f"step {step} committed in {dt * 1e3:.1f} ms",
                        step=step, dir=d, bytes=len(blob))
        if self.rank == 0 and self.max_to_keep:
            self._prune()

    # -- load ----------------------------------------------------------------
    def load_latest(self, reshard=False):
        """The newest valid checkpoint as (state, manifest), or (None, None)
        on a fresh directory; see :func:`load_latest`."""
        return load_latest(self.dir, rank=self.rank,
                           world_size=self.world_size, reshard=reshard)

    def _prune(self):
        steps = list_steps(self.dir)
        committed = [s for s in steps if os.path.exists(
            os.path.join(_ckpt_dir(self.dir, s), "MANIFEST.json"))]
        if not committed:
            return
        keep = set(committed[-self.max_to_keep:])
        newest = committed[-1]
        for s in steps:
            # a step past the newest commit may be mid-commit; uncommitted
            # leftovers older than it are dead writers
            if s in keep or s >= newest:
                continue
            shutil.rmtree(_ckpt_dir(self.dir, s), ignore_errors=True)
            _counters["pruned"] += 1


# -- load --------------------------------------------------------------------

def _read_manifest(d, rank):
    try:
        with open(os.path.join(d, _manifest_name(rank))) as f:
            m = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(m, dict) or m.get("schema") != SCHEMA:
        return None
    return m


def _verified_blob(base, step, rank):
    """One rank's payload bytes of checkpoint ``step`` after the manifest
    checks (commit marker, record, size, crc32): (blob, commit manifest),
    or (None, reason)."""
    d = _ckpt_dir(base, step)
    commit = _read_manifest(d, 0)
    if commit is None:
        return None, "no commit marker (MANIFEST.json missing/invalid)"
    manifest = commit if rank == 0 else _read_manifest(d, rank)
    if manifest is None:
        return None, f"rank {rank} shard manifest missing/invalid"
    name = _payload_name(rank)
    rec = (manifest.get("files") or {}).get(name)
    if rec is None:
        return None, f"manifest has no record for {name}"
    try:
        with open(os.path.join(d, name), "rb") as f:
            blob = f.read()
    except OSError as e:
        return None, f"payload unreadable ({e})"
    if len(blob) != rec.get("bytes") or zlib.crc32(blob) != rec.get("crc32"):
        return None, (f"payload checksum mismatch (got {len(blob)} bytes, "
                      f"manifest says {rec.get('bytes')})")
    return blob, commit


def _load_one(base, step, rank, raw=False):
    """One rank's payload of checkpoint ``step``: (state, commit manifest)
    or (None, reason). ``raw=True`` keeps the tensor records (the
    resharder merges them before one ``_from_saveable``). A payload that
    passed its checksum but needs a module this machine lacks (a
    reference file of ``ml_dtypes.bfloat16`` arrays) raises that
    ``ImportError`` rather than being skipped as torn."""
    blob, commit = _verified_blob(base, step, rank)
    if blob is None:
        return None, commit
    try:
        state = pickle.loads(blob)
    except ImportError:
        raise
    except Exception as e:
        return None, f"payload unpicklable ({type(e).__name__}: {e})"
    return (state if raw else _from_saveable(state)), commit


def load_latest(base, rank=0, world_size=None, reshard=False):
    """The newest valid checkpoint under ``base`` as (state, manifest), or
    (None, None). A torn, partial or mis-checksummed checkpoint is skipped
    with a ``checkpoint_skip`` explainer record. ``world_size``, when
    given, is checked against the manifest: a mismatch, or any sharded
    checkpoint, raises :class:`WorldSizeMismatchError` unless
    ``reshard=True``, which goes through :func:`load_resharded`."""
    if reshard:
        return load_resharded(base, rank=rank, world_size=world_size or 1)
    t0 = time.perf_counter()
    for step in reversed(list_steps(base)):
        commit = _read_manifest(_ckpt_dir(base, step), 0)
        if commit is not None:
            saved_w = int(commit.get("world_size", 1))
            if commit.get("sharded") or (
                    world_size is not None and saved_w != int(world_size)):
                raise WorldSizeMismatchError(
                    saved_w, world_size if world_size is not None else 1,
                    step=step, dir=base,
                    sharded=bool(commit.get("sharded")))
        state, man = _load_one(base, step, rank)
        if state is not None:
            _registry.timing("restore", time.perf_counter() - t0,
                             scope="checkpoint")
            _counters["restores"] += 1
            _explain.record("checkpoint_restore", op="load_latest",
                            why=f"restored step {man['step']} from "
                                f"{_ckpt_dir(base, step)}",
                            step=man["step"], rank=rank)
            return state, man
        _counters["skipped_corrupt"] += 1
        _explain.record("checkpoint_skip", op="load_latest",
                        why=f"skipping ckpt-{step:08d}: {man}",
                        step=step, rank=rank)
    return None, None


def load_resharded(base, rank=0, world_size=1, step=None):
    """The newest valid checkpoint whatever world size wrote it: every
    saved rank's payload is read through its checksummed manifest and the
    flat chunks merge back into full arrays (concatenation and a reshape,
    bitwise). Returns (full state, commit manifest), or (None, None). A
    checkpoint with any unreadable shard is skipped whole."""
    t0 = time.perf_counter()
    steps = [step] if step is not None else list(reversed(list_steps(base)))
    for s in steps:
        commit = _read_manifest(_ckpt_dir(base, s), 0)
        if commit is None:
            reason = "no commit marker (MANIFEST.json missing/invalid)"
        else:
            saved_w = int(commit.get("world_size", 1))
            shards, reason = [], None
            for r in range(saved_w):
                raw, why = _load_one(base, s, r, raw=True)
                if raw is None:
                    reason = f"shard {r}/{saved_w}: {why}"
                    break
                shards.append(raw)
            if reason is None:
                state = _from_saveable(_merge_saveable(shards))
                _registry.timing("restore", time.perf_counter() - t0,
                                 scope="checkpoint")
                _counters["reshard_loads"] += 1
                _counters["restores"] += 1
                _explain.record(
                    "checkpoint_reshard", op="load_resharded",
                    why=f"step {commit['step']}: merged {saved_w} shard(s)"
                        f" -> world_size {world_size} (rank {rank})",
                    step=commit["step"], saved_world_size=saved_w,
                    world_size=int(world_size), rank=rank)
                return state, commit
        _counters["skipped_corrupt"] += 1
        _explain.record("checkpoint_skip", op="load_resharded",
                        why=f"skipping ckpt-{s:08d}: {reason}",
                        step=s, rank=rank)
    return None, None


def latest_step(base, rank=0):
    """Step of the newest valid checkpoint, or None. Valid means whole:
    committed, and its payload's size and crc32 match the manifest (the
    reference also unpickles it; here the one unpickling is left to the
    loader, so a follower reads a checkpoint's payload into objects once).
    Sharded and foreign-world checkpoints count."""
    for step in reversed(list_steps(base)):
        if _verified_blob(base, step, rank)[0] is not None:
            return step
    return None


def save_checkpoint(base, state, step, epoch=None, user_meta=None,
                    max_to_keep=None, rank=None, world_size=None,
                    shard=False):
    """One synchronous checkpoint commit (atomic, checksummed); ``rank``,
    ``world_size`` and ``shard`` as :class:`CheckpointManager`'s."""
    mgr = CheckpointManager(base, max_to_keep=max_to_keep, async_save=False,
                            rank=rank, world_size=world_size, shard=shard)
    return mgr.save(state, step, epoch=epoch, user_meta=user_meta)


# -- training state ----------------------------------------------------------

def capture_training_state(network, optimizer=None):
    """The model's state, and the optimizer's, as one saveable nest in the
    reference's names and layout. The nest aliases the live tensors: hand
    it straight to ``CheckpointManager.save``, which snapshots it."""
    net = getattr(network, "network", network)
    state = {"model": convert.state_to_paddle_tpu(net)}
    if optimizer is not None:
        state["optimizer"] = convert.optimizer_state_to_paddle_tpu(
            optimizer, net)
    return state


def restore_training_state(network, optimizer, state):
    """Copy a loaded state (reference names and layout, either package's
    checkpoint) into the live parameters and optimizer slots in place, so
    tensor identity is kept. Every name must match: a missing or an extra
    name raises ``KeyError``, a shape mismatch ``ValueError``."""
    net = getattr(network, "network", network)
    sd = state.get("model", state)
    own = dict(net.state_dict(keep_vars=True))
    with torch.no_grad():
        for name, t in convert.state_from_paddle_tpu(sd, net).items():
            own[name].copy_(t)
    if optimizer is not None and "optimizer" in state:
        optimizer.set_state_dict(convert.optimizer_state_from_paddle_tpu(
            state["optimizer"], optimizer, net))


# -- step-loop hook ----------------------------------------------------------

class CheckpointHook:
    """Ties a manager to a training loop and to preemption::

        hook = CheckpointHook(dir, net, opt, save_interval=50)
        start = hook.restore()                  # 0 on a fresh run
        for step in range(start, total):
            loss = train_step(batch(step))
            if hook.on_step_end(step) == "preempted":
                break                            # emergency ckpt written
        hook.wait()

    On SIGTERM the handler only sets a flag; the next ``on_step_end``
    writes a synchronous emergency checkpoint and reports "preempted", so
    the save lands on a step boundary with consistent parameter and
    optimizer state. ``rank``, ``world_size`` and ``shard`` are
    :class:`CheckpointManager`'s; ``reshard=True`` lets :meth:`restore`
    resume from a checkpoint written at another world size; ``elastic``
    is an ``ElasticTrainContext`` (or anything of its shape), wired as
    the module's docstring says."""

    def __init__(self, dir, network, optimizer=None, save_interval=100,
                 max_to_keep=3, async_save=True, rank=None, world_size=None,
                 shard=False, reshard=False, install_sigterm=True,
                 elastic=None):
        self.manager = CheckpointManager(dir, max_to_keep=max_to_keep,
                                         async_save=async_save, rank=rank,
                                         world_size=world_size, shard=shard)
        self.reshard = bool(reshard)
        self.elastic = elastic
        self._net = network
        self._opt = optimizer
        self.save_interval = max(1, int(save_interval))
        self._preempt = threading.Event()
        self._old_handler = None
        if install_sigterm:
            self.install_sigterm()

    def install_sigterm(self):
        """Install the preemption handler (main thread only; elsewhere the
        caller routes signals and calls ``request_preempt()``)."""
        if threading.current_thread() is not threading.main_thread():
            return False
        try:
            self._old_handler = signal.signal(
                signal.SIGTERM, lambda signum, frame: self._preempt.set())
        except ValueError:
            return False
        return True

    def uninstall_sigterm(self):
        if self._old_handler is not None:
            try:
                signal.signal(signal.SIGTERM, self._old_handler)
            except ValueError:
                pass
            self._old_handler = None

    def request_preempt(self):
        """Programmatic preemption (tests; callers off the main thread)."""
        self._preempt.set()

    @property
    def preempt_requested(self):
        return self._preempt.is_set()

    def restore(self):
        """Resume from the newest valid checkpoint: parameters, optimizer
        slots and torch's generators, in place. Returns the step to run
        next (0 on a fresh start)."""
        state, man = self.manager.load_latest(reshard=self.reshard)
        if state is None:
            return 0
        restore_training_state(self._net, self._opt, state)
        _rng_restore(man, getattr(self._net, "network", self._net))
        return int(man["step"]) + 1

    def _save(self, step, epoch, user_meta, block=False):
        net = getattr(self._net, "network", self._net)
        self.manager.save(capture_training_state(self._net, self._opt),
                          step, epoch=epoch, user_meta=user_meta,
                          block=block, network=net)

    def on_step_end(self, step, epoch=None, user_meta=None):
        """Call once per completed step. Returns "preempted" after an
        emergency save (the caller should exit), "fenced" when this rank's
        world was resized past it (the caller exits without saving),
        "saved" after a periodic save, else "ok"."""
        if _faults.ACTIVE:
            _faults.fire("kill_at_step", step=step)
            _faults.fire("rank_preempt", step=step)
            # step_hang sleeps with the watchdog still armed for this
            # step: it fires before the boundary tick below
            _faults.fire("step_hang", step=step)
        el = self.elastic
        coordinator = getattr(el, "coordinator", None) if el else None
        if el is not None:
            el.step_boundary(step)
        if coordinator is not None:
            if self._preempt.is_set() and not coordinator.triggered:
                # a stale rank must not make the new world take a
                # fleet-wide emergency checkpoint on its behalf
                if not el.fence_check("preemption announce"):
                    return "fenced"
                # local SIGTERM: every rank saves at one step
                coordinator.announce(step)
            elif coordinator.triggered:
                self._preempt.set()  # a peer announced; adopt it here
        if self._preempt.is_set():
            if coordinator is not None and not coordinator.should_save(step):
                return "ok"  # the fleet's target is a later boundary
            if el is not None and not el.fence_check("emergency save"):
                return "fenced"
            meta = {"emergency": True, **(user_meta or {})}
            coordinated = None
            if coordinator is not None:
                # the barrier is keyed by the fleet's target step, so a
                # rank that adopted the notice a boundary late meets its
                # peers there; the manifest keeps the local step, the
                # state actually saved, beside the target
                coordinated = coordinator.barrier(coordinator.save_step(step))
                meta["coordinated"] = coordinated
                meta["preempt_target"] = coordinator.save_step(step)
            self._save(step, epoch, meta, block=True)
            _counters["emergency_saves"] += 1
            _explain.record(
                "checkpoint_save", op="emergency",
                why=f"SIGTERM: emergency checkpoint at step boundary {step}"
                    + (f" ({coordinated} ranks coordinated)"
                       if coordinated is not None else ""),
                step=step)
            return "preempted"
        if (step + 1) % self.save_interval == 0:
            if el is not None and not el.fence_check("periodic save"):
                return "fenced"
            self._save(step, epoch, user_meta)
            return "saved"
        return "ok"

    def wait(self):
        self.manager.wait()

    def close(self):
        self.wait()
        self.uninstall_sigterm()
