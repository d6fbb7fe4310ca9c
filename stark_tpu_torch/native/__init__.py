"""The port's host C library: batched Blake2b, Keccak, field kernels and
the Rescue-Prime hash chain.

The C sources under ``stark_tpu_torch/csrc/host/`` are compiled at first
use by the system C compiler into one shared library in ``build/host/`` at
the repository root, named by a hash of the sources and flags (an edit
rebuilds, an unchanged tree reuses the last build), and loaded with
``ctypes``.  Nothing is built when this package is imported.

:func:`library` raises ImportError when the library cannot be built or
loaded, and remembers the failure; the host modules that use it
(:mod:`stark_tpu_torch.hashing`, :mod:`stark_tpu_torch.ntt`, the prover's
batch inversion and folds, the Rescue chain's witness) then take their
pure-Python paths, which compute the same bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

_CSRC = Path(__file__).resolve().parent.parent / "csrc" / "host"
_SOURCES = ("blake2b.h", "blake2b.c", "hashing.c", "keccak.c", "fieldvec.c", "rescue.c")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
_CFLAGS = ("-O3", "-fPIC", "-fopenmp", "-Wall", "-Wextra", "-std=c11", "-shared")

_lock = threading.Lock()
_lib = None
_failure = None
#: facts of the build that loaded the library (path, seconds, cached)
build_info: Dict[str, object] = {}


def _compiler() -> str:
    for name in ("cc", "gcc", "clang"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C compiler (cc, gcc or clang) on PATH")


def _source_digest() -> str:
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(_CFLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if this source tree has not been built; returns
    the path of the shared library.  Raises RuntimeError if the compiler
    fails."""
    so = _BUILD_DIR / f"libstark_hash-{_source_digest()}.so"
    if so.exists():
        build_info.update(path=str(so), seconds=0.0, cached=True)
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_compiler(), *_CFLAGS, "-o", str(tmp)]
    cmd += [str(_CSRC / s) for s in _SOURCES if s.endswith(".c")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"C compiler failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    build_info.update(path=str(so), seconds=seconds, cached=False)
    return so


def library() -> ctypes.CDLL:
    """The loaded host library, built on first call.  Raises ImportError
    (every call after the first failure, without retrying) when it cannot
    be built or loaded."""
    global _lib, _failure
    with _lock:
        if _lib is None:
            if _failure is not None:
                raise ImportError(_failure)
            try:
                _lib = ctypes.CDLL(str(build()))
            except (RuntimeError, OSError) as exc:
                _failure = f"the host library does not build or load here: {exc}"
                raise ImportError(_failure) from exc
    return _lib
