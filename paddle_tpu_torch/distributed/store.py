"""``TCPStore``: a key-value store over TCP for rendezvous (counterpart of
paddle_tpu/distributed/store.py), bound with ``ctypes`` to the repository's
native store, ``csrc/tcpstore/tcpstore.cc``, through the same C ABI.

The rank hosting the server passes ``is_master=True``; every rank connects
as a client and exchanges bootstrap records with ``set`` / ``get`` /
``add`` / ``wait`` / ``check`` / ``delete_key``. A transient transport
error is retried with exponential backoff (``PADDLE_TPU_STORE_RETRIES``,
default 3, from ``PADDLE_TPU_STORE_BACKOFF`` seconds, default 0.05), each
retry counted in ``fault.store.retries``. The fault points
``store_flaky``, ``store_slow`` and ``store_partition``
(``testing.faults``) fire at every operation but ``num_keys``.

The process group's own rendezvous is torch's c10d store
(``parallel_env.init_parallel_env``: ``env://``, or ``file://`` in the
tests, so that test processes never race for a port). This store
carries ``fleet.elastic``'s keys (generations, leases, preemption,
fences, resize requests), ``distributed.launch``'s node records and
per-generation coordinators, and the serving ``ReplicaSupervisor``'s
generations; the serving fleet's endpoints wait for ROADMAP queue 1 item
9.

The library is built at first use with ``g++`` into the port's ``build/``
directory as ``tcpstore-<hash>.so``, the hash covering the source and the
flags, under a file lock; it never runs ``make -C csrc``, which writes
into the JAX package.
"""
from __future__ import annotations

import ctypes
import os
import threading
import time
from pathlib import Path

from ..io.shm_ring import build_library
from ..profiler import registry as _registry
from ..testing import faults as _faults

__all__ = ["TCPStore", "library"]

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "tcpstore" \
    / "tcpstore.cc"

_RETRIES = max(0, int(os.environ.get("PADDLE_TPU_STORE_RETRIES", "3")))
_BACKOFF_S = float(os.environ.get("PADDLE_TPU_STORE_BACKOFF", "0.05"))
_counters = _registry.scoped_counters("fault", {"store.retries": 0})
_LIB = {}


def library():
    """Path of the built library (``io.shm_ring.build_library``), building
    it first if needed."""
    return build_library(SOURCE, "tcpstore")


def _load():
    lib = _LIB.get("lib")
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(library()))
    vp, cp, i64 = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64
    for name, res, args in (
            ("tcpstore_server_start", vp, [ctypes.c_int]),
            ("tcpstore_server_port", ctypes.c_int, [vp]),
            ("tcpstore_server_stop", None, [vp]),
            ("tcpstore_client_connect", vp, [cp, ctypes.c_int]),
            ("tcpstore_client_close", None, [vp]),
            ("tcpstore_set", ctypes.c_int, [vp, cp, cp, ctypes.c_uint64]),
            ("tcpstore_get", i64, [vp, cp, cp, ctypes.c_uint64]),
            ("tcpstore_add", i64, [vp, cp, i64]),
            ("tcpstore_check", ctypes.c_int, [vp, cp]),
            ("tcpstore_delete", ctypes.c_int, [vp, cp]),
            ("tcpstore_num_keys", i64, [vp])):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    _LIB["lib"] = lib
    return lib


class TCPStore:
    """``TCPStore(host, port, is_master, world_size, timeout)``: the master
    starts the server (``port=0`` picks a free one, read back as
    ``.port``); every instance connects a client, retrying for
    ``timeout`` seconds."""

    def __init__(self, host="127.0.0.1", port=0, is_master=False,
                 world_size=1, timeout=30.0):
        lib = _load()
        self._lib = lib
        self._server = None
        self._client = None
        self.timeout = timeout
        # one socket per client: a thread must not read another's reply
        self._lock = threading.Lock()
        if is_master:
            self._server = lib.tcpstore_server_start(port)
            if not self._server:
                raise RuntimeError(f"TCPStore server failed on port {port}")
            port = lib.tcpstore_server_port(self._server)
        self.port = port
        self.host = host
        deadline = time.time() + timeout
        while time.time() < deadline:
            self._client = lib.tcpstore_client_connect(host.encode(), port)
            if self._client:
                break
            time.sleep(0.05)
        if not self._client:
            raise TimeoutError(f"cannot connect TCPStore at {host}:{port}")

    @staticmethod
    def _retry(attempt):
        """Run one operation, retrying transient transport errors
        (``ConnectionError`` from a fault point, ``RuntimeError`` from the
        C ABI) with exponential backoff."""
        tries = 0
        while True:
            try:
                return attempt()
            except (ConnectionError, RuntimeError):
                if tries >= _RETRIES:
                    raise
                _counters["store.retries"] += 1
                time.sleep(_BACKOFF_S * (2 ** tries))
                tries += 1

    def set(self, key, value):
        if isinstance(value, str):
            value = value.encode()

        def attempt():
            if _faults.ACTIVE:
                _faults.store_op("set")
            with self._lock:
                rc = self._lib.tcpstore_set(self._client, key.encode(),
                                            value, len(value))
            if rc != 0:
                raise RuntimeError("TCPStore.set transport failure")

        self._retry(attempt)

    def get(self, key):
        """The value of ``key`` as bytes, waiting up to ``timeout`` for it
        to be set."""
        deadline = time.time() + self.timeout
        buf = ctypes.create_string_buffer(1 << 20)
        transient = 0
        while True:
            try:
                if _faults.ACTIVE:
                    _faults.store_op("get")
                with self._lock:
                    n = self._lib.tcpstore_get(self._client, key.encode(),
                                               buf, len(buf))
                    if n > len(buf):
                        buf = ctypes.create_string_buffer(int(n))
                        n = self._lib.tcpstore_get(
                            self._client, key.encode(), buf, len(buf))
                if n == -2:
                    raise RuntimeError("TCPStore.get transport error")
            except (ConnectionError, RuntimeError):
                transient += 1
                if transient > _RETRIES:
                    raise
                _counters["store.retries"] += 1
                time.sleep(_BACKOFF_S * (2 ** (transient - 1)))
                continue
            if n >= 0:
                return buf.raw[:n]
            if time.time() > deadline:
                raise TimeoutError(f"TCPStore.get({key!r}) timed out")
            time.sleep(0.02)

    def add(self, key, amount=1):
        """Add ``amount`` to the integer at ``key`` (0 when unset); returns
        the new value. Only failures reported before the server applied
        the increment are retried, so ``add() == 1`` stays exclusive."""
        def attempt():
            if _faults.ACTIVE:
                _faults.store_op("add")
            with self._lock:
                v = self._lib.tcpstore_add(self._client, key.encode(),
                                           amount)
            if v == -(2 ** 63):
                raise RuntimeError("TCPStore.add transport failure")
            return v

        return self._retry(attempt)

    def wait(self, keys, timeout=None):
        """Block until every key in ``keys`` is set."""
        if isinstance(keys, str):
            keys = [keys]
        deadline = time.time() + (timeout or self.timeout)
        for k in keys:
            while not self.check(k):
                if time.time() > deadline:
                    raise TimeoutError(f"TCPStore.wait({k!r}) timed out")
                time.sleep(0.02)

    def check(self, key):
        """Whether ``key`` is set (a transport error raises, after its
        retries: it is never read as "missing")."""
        def attempt():
            if _faults.ACTIVE:
                _faults.store_op("check")
            with self._lock:
                rc = self._lib.tcpstore_check(self._client, key.encode())
            if rc < 0:
                raise RuntimeError("TCPStore.check transport failure")
            return rc == 1

        return self._retry(attempt)

    def delete_key(self, key):
        """Delete ``key``; True when it existed."""
        def attempt():
            if _faults.ACTIVE:
                _faults.store_op("delete")
            with self._lock:
                rc = self._lib.tcpstore_delete(self._client, key.encode())
            if rc < 0:
                raise RuntimeError("TCPStore.delete transport failure")
            return rc == 0

        return self._retry(attempt)

    def num_keys(self):
        with self._lock:
            return self._lib.tcpstore_num_keys(self._client)

    def close(self):
        """Close the client, and stop the server if this instance runs it."""
        if self._client:
            self._lib.tcpstore_client_close(self._client)
            self._client = None
        if self._server:
            self._lib.tcpstore_server_stop(self._server)
            self._server = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter teardown: the library may be gone
            pass
