"""ctypes binding of the repository's shared-memory ring
(``csrc/shm_ring/shm_ring.cc``; counterpart of paddle_tpu/io/shm_ring.py):
a multi-producer, single-consumer ring of fixed-size slots in POSIX shared
memory that carries DataLoader batches from worker processes.

The library is built at first use with ``g++`` into the port's ``build/``
directory as ``shm_ring-<hash>.so``, the hash covering the source and the
flags, under a file lock so that concurrent first uses build it once. It
never runs ``make -C csrc``, which writes into the JAX package.
:func:`library` builds and returns the path; a worker process is handed
that path and only loads it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "shm_ring" \
    / "shm_ring.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared", "-pthread")

_libs: dict = {}


def library():
    """Path of the built ring library, building it first if needed."""
    return build_library(SOURCE, "shm_ring", ("-lrt",))


def build_library(source, stem, link=()):
    """Path of ``source`` built with ``g++`` into the port's ``build/`` as
    ``<stem>-<hash>.so`` (the hash covers the source and the flags),
    building it first if needed, under a file lock so that concurrent first
    uses build it once. A failed compile raises with the compiler's
    output. (The rendezvous store, ``distributed/store.py``, builds its
    library here too.)"""
    h = hashlib.sha256(Path(source).read_bytes())
    h.update(" ".join((*CXX_FLAGS, *link)).encode())
    so = BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    import fcntl

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            res = subprocess.run(
                [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
                 str(source), *link], capture_output=True, text=True)
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"building {Path(source).name} failed "
                                   f"(exit {res.returncode}):\n"
                                   f"{res.stdout}{res.stderr}")
            os.replace(tmp, so)
    return so


def _lib(path=None):
    path = str(path or library())
    lib = _libs.get(path)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(path)
    lib.ptshm_create.restype = ctypes.c_void_p
    lib.ptshm_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                 ctypes.c_uint64]
    lib.ptshm_open.restype = ctypes.c_void_p
    lib.ptshm_open.argtypes = [ctypes.c_char_p]
    lib.ptshm_write.restype = ctypes.c_int
    lib.ptshm_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_uint64, ctypes.c_uint64]
    lib.ptshm_read.restype = ctypes.c_int64
    lib.ptshm_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_uint64,
                               ctypes.POINTER(ctypes.c_uint64),
                               ctypes.c_int64]
    lib.ptshm_slot_size.restype = ctypes.c_uint64
    lib.ptshm_slot_size.argtypes = [ctypes.c_void_p]
    lib.ptshm_close.restype = None
    lib.ptshm_close.argtypes = [ctypes.c_void_p]
    _libs[path] = lib
    return lib


class ShmRing:
    """Multi-producer / single-consumer shared-memory message ring.
    ``create=True`` makes the segment (and unlinks it on close);
    ``create=False`` opens an existing one. ``lib_path`` loads a library
    already built (a worker process's case) instead of building it."""

    def __init__(self, name: str, n_slots=8, slot_size=32 << 20,
                 create=True, lib_path=None):
        self._h = None
        self._libref = _lib(lib_path)
        self.name = name.encode()
        if create:
            self._h = self._libref.ptshm_create(self.name, n_slots,
                                                slot_size)
        else:
            self._h = self._libref.ptshm_open(self.name)
        if not self._h:
            raise OSError(f"shm ring {'create' if create else 'open'} "
                          f"failed for {name}")
        self.slot_size = self._libref.ptshm_slot_size(self._h)
        # one consumer: one read buffer, reused for every message
        self._read_buf = None

    def write(self, payload: bytes, tag: int = 0):
        """Block until a slot is free, then copy ``payload`` into it."""
        rc = self._libref.ptshm_write(self._h, payload, len(payload), tag)
        if rc == -1:
            raise ValueError(
                f"payload of {len(payload)} bytes exceeds slot size "
                f"{self.slot_size}; raise DataLoader slot_size")
        if rc != 0:
            raise OSError(f"shm ring write failed (rc={rc})")
        return rc

    def read(self, timeout_ms: int = -1):
        """``(payload bytes, tag)``, or None after ``timeout_ms``."""
        if self._read_buf is None:
            self._read_buf = ctypes.create_string_buffer(int(self.slot_size))
        buf = self._read_buf
        tag = ctypes.c_uint64(0)
        n = self._libref.ptshm_read(self._h, buf, self.slot_size,
                                    ctypes.byref(tag), timeout_ms)
        if n == -2:
            return None
        if n < 0:
            raise OSError(f"shm ring read failed (rc={n})")
        return ctypes.string_at(buf, int(n)), int(tag.value)

    def close(self):
        if self._h:
            self._libref.ptshm_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
