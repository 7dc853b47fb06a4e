"""Build a CUDA source under ``kernels/csrc`` into a shared library with
``nvcc`` and load it with ``ctypes``.

Each source exposes a plain C interface, so it compiles in seconds (no
PyTorch headers).  The library is built at first use into ``build/`` at
the root of the checkout, named by a hash of the source and the flags, and
the build runs under a file lock so concurrent processes build it once.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "BUILD_INFO", "load_library"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# source name -> {"seconds": build time (0.0 if found built), "log": nvcc stderr}
BUILD_INFO: dict[str, dict] = {}

_lock = threading.Lock()                      # guards _source_locks
_source_locks: dict[str, threading.Lock] = {}  # one per source: builds run in parallel
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH); "
                           "the CUDA kernels are built on the machine with the card")
    return found


def _build(src: Path, so: Path, flags: tuple[str, ...]) -> dict:
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src.name} ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return {"seconds": time.perf_counter() - t0, "log": proc.stderr}


def load_library(source: str, signatures: dict[str, tuple],
                 extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (once) and load ``csrc/<source>``; ``signatures`` maps each C
    function to ``(restype, argtypes)``, set on first load; ``extra_flags``
    follow ``NVCC_FLAGS`` on the source's nvcc line.  Different sources
    build concurrently when loaded from several threads."""
    with _lock:
        source_lock = _source_locks.setdefault(source, threading.Lock())
    with source_lock:
        lib = _libs.get(source)
        if lib is not None:
            return lib
        src = CSRC_DIR / source
        flags = (*NVCC_FLAGS, *extra_flags)
        digest = hashlib.sha1(src.read_bytes() + " ".join(flags).encode())
        so = BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:12]}.so"
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / f"{src.stem}.lock", "w") as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)
            if so.exists():
                BUILD_INFO[source] = {"seconds": 0.0, "log": ""}
            else:
                BUILD_INFO[source] = _build(src, so, flags)
        lib = ctypes.CDLL(str(so))
        for name, (restype, argtypes) in signatures.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _libs[source] = lib
        return lib
