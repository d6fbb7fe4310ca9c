"""Build, load and launch the hand-written CUDA kernels.

The sources under ``stark_tpu_torch/csrc/`` are compiled at first use by
``nvcc`` for ``sm_90a``, one ``nvcc`` per source, all started together,
and linked into one shared library with a plain C interface, loaded with
``ctypes``.  The library lands in ``build/stark_kernels/`` at
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
_SOURCES = ("field.cuh", "blake2b.cuh", "ntt.cu", "merkle.cu", "fold.cu", "fs.cu", "fieldvec.cu", "rescue.cu",
            "probes.cu", "combination.cu")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "stark_kernels"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_U64 = ctypes.c_uint64
_PI = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "stark_ntt_pass1": [_P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P],
    "stark_ntt_pass2": [_P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _P],
    "stark_ntt_occupancy": [_I, _I, _I, _I, _PI, _PI, _PI, _PI],
    "stark_merkle_leaves": [_P, _P, _I64, _P],
    "stark_merkle_leaves_mont": [_P, _P, _I64, _P],
    "stark_mont_digits": [_P, _P, _I64, _P],
    "stark_mont_digits_gather": [_P, _P],
    "stark_mont_digits_gather_params_size": [],
    "stark_merkle_level": [_P, _P, _I64, _P],
    "stark_merkle_top": [_P, _P, _I64, _P],
    "stark_merkle_subtrees": [_P, _P, _I64, _I, _P],
    "stark_fri_fold": [_P, _P, _P, _P, _I64, _P],
    "stark_fs_round": [_P, _I64, _U64, _P, _P, _P],
    "stark_mont_inv": [_P, _P, _I64, _P],
    "stark_prefix_mul": [_P, _P, _I64, _P, _P, _P, _P, _I64, ctypes.c_uint32, _U64, _P],
    "stark_geometric_table": [_P, _P, _I, _P, _I64, _P],
    "stark_geometric_step_bits": [_I64],
    "stark_mont_binary": [_P, _P, _P, _I64, _I, _I, _I, _P],
    "stark_mont_outer": [_P, _P, _P, _I64, _I64, _P],
    "stark_rescue_permutation": [_P, _P, _P, _I64, _I, _P],
    "stark_combination": [_P, _P],
    "stark_combination_params_size": [],
    "stark_probe_mont13_chain": [_P, _P, _P, _I64, _I64, _I64, _P],
    "stark_probe_mont_chain": [_P, _P, _P, _I64, _I64, _I64, _P],
    "stark_probe_mont16_chain": [_P, _P, _P, _I64, _I64, _I64, _I, _P],
    "stark_probe_level_stub": [_P, _P, _I64, _P],
    "stark_probe_level_rounds": [_P, _P, _I64, _I, _P],
    "stark_launch_floor": [_P],
}

#: the timing probes' kernels (``csrc/probes.cu``, :mod:`.cuda_probes`),
#: on no path of a prove: B1, B2, B3 in its three modes, B4's stub and its
#: compress cut to 1 and 6 rounds (at 12 B4 runs ``merkle_level``)
PROBES = ("probe_mont13_chain", "probe_mont_chain", "probe_mont16_chain/base", "probe_mont16_chain/hint16",
          "probe_mont16_chain/xor", "probe_level_stub", "probe_level_rounds/1", "probe_level_rounds/6")
#: the kernel variants of the sharded prover's path (``stark_tpu_torch.parallel``),
#: on no one-device prove's: K11's next-row form and K10's row-by-column form
MESH_VARIANTS = ("combination_next", "mont_outer")
#: kernel name -> launches since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {
    "ntt_pass1": 0, "ntt_pass2": 0, "merkle_leaves": 0, "merkle_level": 0, "merkle_subtrees": 0, "merkle_top": 0,
    "fri_fold": 0, "fs_round": 0, "mont_inv": 0, "prefix_mul": 0, "geometric_table": 0, "mont_binary": 0,
    "rescue_permutation": 0, "combination": 0, "mont_digits": 0, "mont_digits_gather": 0,
    "combination_next": 0, "mont_outer": 0,
    **{name: 0 for name in PROBES},
}
#: size of the launch -> kernel name -> launches since the last reset: the
#: transform's points (NTT passes), the leaves or the input level's width
#: (Merkle kernels and B4), the codeword's length (fold), the body's bytes
#: (fs_round), the elements (field kernels, the digit conversion and its
#: gather form, B1-B3), the instances (rescue_permutation) or the points
#: (combination)
LAUNCHES_BY_SIZE: Dict[int, Dict[str, int]] = {}

_lock = threading.Lock()
_count_lock = threading.Lock()  # launches from several threads (Stark.precompile's pool)
_lib = None
#: facts of the build that loaded the library (path, seconds, ptxas report)
build_info: Dict[str, object] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCHES_BY_SIZE.clear()


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
    log = so.with_suffix(".ptxas")  # ptxas's -v lines, kept for a reused library
    if so.exists():
        build_info.update(path=str(so), seconds=0.0, cached=True, ptxas=log.read_text() if log.exists() else "")
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    units = [(_CSRC / s, _BUILD_DIR / f"{so.stem}.{os.getpid()}.{Path(s).stem}.o")
             for s in _SOURCES if s.endswith(".cu")]
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen([nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for src, obj in units]
        outs = [p.communicate() for p in procs]
        failed = [f"{src.name} ({p.returncode}):\n{out}\n{err}"
                  for (src, _), p, (out, err) in zip(units, procs, outs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj in units)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    finally:
        for _, obj in units:
            obj.unlink(missing_ok=True)
    ptxas = "".join(err for _, err in outs)
    log.write_text(ptxas)
    os.replace(tmp, so)
    seconds = time.perf_counter() - t0
    build_info.update(path=str(so), seconds=seconds, cached=False, ptxas=ptxas)
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


def launch(kernel: str, entry: str, *args, device: torch.device, size: int) -> None:
    """Call one C entry point, which launches one kernel, on ``device``'s
    current stream, raise if it reports a CUDA error, and count the launch
    (also under ``size`` in :data:`LAUNCHES_BY_SIZE`)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(library(), entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed with CUDA error {err}")
    with _count_lock:
        LAUNCHES[kernel] += 1
        by_kernel = LAUNCHES_BY_SIZE.setdefault(size, {})
        by_kernel[kernel] = by_kernel.get(kernel, 0) + 1


def ptr(t) -> int:
    """Device pointer of a tensor, or 0 (NULL) for None."""
    return 0 if t is None else t.data_ptr()
