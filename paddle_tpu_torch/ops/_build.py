"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``paddle_tpu_torch/csrc/<name>.cu`` compiles on its own into
``<repo>/build/<name>-<hash>.so``, where the hash covers the source, the
headers beside it (``csrc/*.cuh``) and the flags, so an edited kernel or
header rebuilds and an unchanged one loads the library already built.
Libraries expose a plain ``extern "C"`` launcher; no PyTorch header is
compiled, which keeps a build to seconds.

A missing ``nvcc`` or a failed compile raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}


def sources():
    """Names of every CUDA source of the port (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc():
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, then
    ``PATH``. Raises when none has it."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of paddle_tpu_torch are built from "
            "source at first use and have no fallback")
    return found


def library_path(name):
    """``build/<name>-<hash>.so``; the hash covers the source, every header
    beside it (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None):
    """Compile every source in ``names`` (default: all) that has no
    up-to-date library yet, one ``nvcc`` process per source, all started
    together. Returns ``{name: path}``. Each compile's output, ``-Xptxas -v``
    register and spill report included, is kept beside the library as
    ``<library>.log``."""
    names = sources() if names is None else list(names)
    out, procs = {}, []
    for name in names:
        so = library_path(name)
        out[name] = so
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        # the child keeps its own copy of the log's descriptor
        with open(so.with_suffix(".so.log"), "w") as log:
            procs.append((name, so, tmp, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, so, tmp, proc in procs:
        rc = proc.wait()
        if rc != 0:
            failed.append(f"{name} (nvcc exit {rc}):\n"
                          + so.with_suffix(".so.log").read_text()[-4000:])
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return out


def load(name):
    """The ``ctypes.CDLL`` of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build([name])[name]))
        return lib
