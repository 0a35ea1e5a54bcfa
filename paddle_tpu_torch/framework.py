"""paddle_tpu_torch.framework — save/load of state nests (counterpart of
paddle_tpu/framework.py:16-186), in the reference's pickle format, so that
a file written by either package loads in the other.

A nest is dicts, lists and tuples over leaves. ``save`` turns every torch
tensor leaf into the reference's record ``{"__tensor__": True, "data":
ndarray, "stop_gradient": bool, "param": bool}``; other leaves (numpy
arrays, numbers, strings) are pickled as they are. bf16 tensors are written
as float32: the widening is exact, and it is the one encoding both readers
take without ``ml_dtypes``. ``load`` returns every record as its numpy
array, in the file's layout: the port keeps no reference ``Tensor`` type,
and converting layouts is the caller's business (``convert``). A reference
file whose leaves are ``ml_dtypes.bfloat16`` arrays unpickles only where
``ml_dtypes`` is installed; elsewhere it raises ``ModuleNotFoundError``.

The write is atomic (tmp + fsync + rename): a reader sees the previous
file or the whole new one, never a torn one.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch
from torch import nn

__all__ = ["save", "load", "atomic_write_bytes"]


def _to_saveable(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        t = t.to(dtype=torch.float32 if t.dtype == torch.bfloat16
                 else t.dtype, memory_format=torch.contiguous_format)
        data = t.cpu().numpy()
        if obj.device.type == "cpu":
            data = data.copy()  # a snapshot, not a view of a live tensor
        return {"__tensor__": True, "data": data,
                "stop_gradient": not obj.requires_grad,
                "param": isinstance(obj, nn.Parameter)}
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_saveable(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _merge_saveable(shards):
    """Per-rank saveable nests of a sharded checkpoint (as the reference's
    distributed runs write them: each tensor record cut into flat
    ceil-divided chunks, ``__tensor_shard__``), in rank order, to one nest
    with plain tensor records. Concatenation and a reshape, so bitwise;
    other leaves are replicated in every shard and rank 0's copy is
    taken."""
    first = shards[0]
    if isinstance(first, dict):
        if first.get("__tensor_shard__"):
            parts = [np.asarray(s["data"]).reshape(-1) for s in shards]
            flat = parts[0] if len(parts) == 1 else np.concatenate(parts)
            shape = tuple(int(d) for d in first.get("shape") or ())
            want = int(np.prod(shape, dtype=np.int64))
            if flat.size != want:
                raise RuntimeError(
                    f"sharded tensor reassembles to {flat.size} elements "
                    f"but its recorded shape {shape} needs {want}: the "
                    "shard set is incomplete or from mixed checkpoints")
            return {"__tensor__": True, "data": flat.reshape(shape),
                    "stop_gradient": first.get("stop_gradient", True),
                    "param": first.get("param", False)}
        if first.get("__tensor__"):
            return first  # an unsharded leaf: rank 0's copy
        return {k: _merge_saveable([s[k] for s in shards]) for k in first}
    if isinstance(first, (list, tuple)):
        t = [_merge_saveable([s[i] for s in shards])
             for i in range(len(first))]
        return t if isinstance(first, list) else tuple(t)
    return first


def _from_saveable(obj):
    """A loaded nest with every tensor record replaced by its array."""
    if isinstance(obj, dict):
        if obj.get("__tensor_shard__"):
            raise RuntimeError(
                f"this payload is one shard of a world-size-"
                f"{obj.get('world_size')} sharded checkpoint (rank "
                f"{obj.get('rank')}), not a complete state; use "
                "paddle_tpu_torch.incubate.checkpoint.load_resharded(dir) "
                "to merge the per-rank shards")
        if obj.get("__tensor__"):
            return obj["data"]
        return {k: _from_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_from_saveable(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _fsync_dir(d):
    """Make a committed rename durable (best effort: some filesystems
    refuse a read-only directory descriptor)."""
    try:
        fd = os.open(d or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(data: bytes, path: str):
    """tmp + fsync + rename: a reader never sees a partial file. The tmp
    name carries the pid, so concurrent writers into one directory never
    clobber each other."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(d)


def save(obj, path, protocol=4):
    """Pickle ``obj`` with its tensors as records, atomically (the
    reference's ``paddle.save`` format)."""
    atomic_write_bytes(pickle.dumps(_to_saveable(obj), protocol=protocol),
                       path)


def load(path):
    """Unpickle a ``save`` file (of either package): every tensor record
    comes back as its numpy array, in the file's layout. Only for files
    this program or the reference wrote: unpickling runs code."""
    try:
        with open(path, "rb") as f:
            obj = pickle.load(f)
    except (EOFError, pickle.UnpicklingError) as e:
        raise RuntimeError(
            f"checkpoint {path!r} is corrupt or truncated "
            f"({type(e).__name__}: {e}); if it is one of a series of "
            "training checkpoints, paddle_tpu_torch.incubate.checkpoint."
            "load_latest(dir) falls back to the newest valid one") from e
    return _from_saveable(obj)
