"""Build, load and launch the hand-written CUDA kernels.

The sources under ``stark_tpu_torch/csrc/`` are compiled at first use by
``nvcc`` for ``sm_90a`` into one shared library with a plain C interface,
loaded with ``ctypes``.  The library lands in ``build/stark_kernels/`` at
the repository root, named by a hash of the sources, so an edit rebuilds
and an unchanged tree reuses the last build.  Nothing here runs when the
module is imported, so a machine without ``nvcc`` or a card can still
import every module of the port.

Every C entry point returns ``cudaGetLastError()`` (0 on success); the
launch helper raises on anything else.  Each kernel has a launch counter
that its wrapper bumps exactly where it launches, so a run can show that
its main path went through the kernels.
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

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("field.cuh", "ntt.cu", "merkle.cu")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "stark_kernels"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_SIGNATURES = {
    "stark_ntt_pass1": [_P, _P, _I, _I, _P, _P, _P, _P, _P],
    "stark_ntt_pass2": [_P, _P, _I, _I, _P, _P, _P, _P],
    "stark_merkle_leaves": [_P, _P, _I64, _P],
    "stark_merkle_level": [_P, _P, _I64, _P],
}

#: kernel name -> launches since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"ntt_pass1": 0, "ntt_pass2": 0, "merkle_leaves": 0, "merkle_level": 0}

_lock = threading.Lock()
_lib = None
#: facts of the build that loaded the library (path, seconds, ptxas report)
build_info: Dict[str, object] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _source_digest() -> str:
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernel library if this source tree has not been built;
    returns the path of the shared library."""
    so = _BUILD_DIR / f"libstark_kernels-{_source_digest()}.so"
    if so.exists():
        build_info.update(path=str(so), seconds=0.0, cached=True)
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp)]
    cmd += [str(_CSRC / s) for s in _SOURCES if s.endswith(".cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    build_info.update(path=str(so), seconds=seconds, cached=False, ptxas=proc.stderr)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(kernel: str, entry: str, *args, device: torch.device) -> None:
    """Call one C entry point on ``device``'s current stream, raise if it
    reports a CUDA error, and count the launch."""
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(library(), entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed with CUDA error {err}")
    LAUNCHES[kernel] += 1


def ptr(t) -> int:
    """Device pointer of a tensor, or 0 (NULL) for None."""
    return 0 if t is None else t.data_ptr()
