"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each library is built from ``csrc/<library>.cu`` and the sources
``EXTRA_SOURCES`` adds to it, into one shared library with a plain
``extern "C"`` interface, compiled for Hopper (``sm_90a``) at first use into
``build/evdr_tpu_torch_kernels/`` at the repository root. The build is keyed
on a hash of every source and header plus the compiler flags, so an edited
``.cu`` or ``.cuh`` rebuilds and an unchanged one loads the cached library.
:func:`build_all` compiles every missing library with one ``nvcc`` per
source, all started together.

Nothing here runs at import time: the CPU tests import this module on
machines that have no ``nvcc``.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
              / "evdr_tpu_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# library (= source file stem) -> exported function -> argtypes. Every
# pointer and the stream are c_void_p; ctypes would cut a bare int to 32 bits.
LIBRARIES = {
    "maxsim_bf16": {
        "evdr_maxsim_bf16": [_P] * 5 + [_I] * 5 + [_P],
        "evdr_maxsim_fwd_train": [_P] * 6 + [_I] * 5 + [_P],
        "evdr_bf16_config": [_I, _I, _P],
        "evdr_maxsim_bf16_wide": [_P] * 5 + [_I] * 5 + [_P],
        "evdr_maxsim_fwd_train_wide": [_P] * 6 + [_I] * 5 + [_P],
    },
    "maxsim_int8": {
        "evdr_maxsim_int8full": [_P] * 6 + [_I] * 5 + [_P],
        "evdr_maxsim_int8full_wg": [_P] * 6 + [_I] * 5 + [_P],
        "evdr_int8full_wg_config": [_I, _P],
        "evdr_maxsim_int8": [_P] * 6 + [_I] * 5 + [_P],
        "evdr_maxsim_int8full_wide": [_P] * 6 + [_I] * 5 + [_P],
        "evdr_maxsim_int8_wide": [_P] * 6 + [_I] * 5 + [_P],
    },
    "maxsim_int8_defer": {
        "evdr_maxsim_int8full_defer": [_P] * 6 + [_I] * 5 + [_P],
        "evdr_maxsim_int8_defer": [_P] * 6 + [_I] * 5 + [_P],
        "evdr_maxsim_int8full_defer_wide": [_P] * 6 + [_I] * 5 + [_P],
        "evdr_maxsim_int8_defer_wide": [_P] * 6 + [_I] * 5 + [_P],
    },
    "maxsim_f32": {
        "evdr_maxsim_f32": [_P] * 5 + [_I] * 5 + [_P],
        "evdr_maxsim_fwd_train_f32": [_P] * 6 + [_I] * 5 + [_P],
        "evdr_f32_occupancy": [_I, _I, _P],
        "evdr_maxsim_f32_wide": [_P] * 5 + [_I] * 5 + [_P],
        "evdr_maxsim_fwd_train_f32_wide": [_P] * 6 + [_I] * 5 + [_P],
    },
    "maxsim_int4": {
        "evdr_maxsim_int4full": [_P] * 6 + [_I] * 5 + [_P],
        "evdr_maxsim_int4": [_P] * 6 + [_I] * 5 + [_P],
        "evdr_maxsim_int4full_wide": [_P] * 6 + [_I] * 5 + [_P],
        "evdr_maxsim_int4_wide": [_P] * 6 + [_I] * 5 + [_P],
    },
    "maxsim_pq": {
        "evdr_maxsim_pq": [_P] * 6 + [_I] * 7 + [_P],
        "evdr_maxsim_pqfull": [_P] * 6 + [_I] * 7 + [_P],
        "evdr_maxsim_pq_sum": [_P] * 6 + [_I] * 7 + [_P],
        "evdr_pq_occupancy": [_I] * 4 + [_P],
        "evdr_maxsim_pq_wide": [_P] * 6 + [_I] * 7 + [_P],
        "evdr_maxsim_pqfull_wide": [_P] * 6 + [_I] * 7 + [_P],
        "evdr_maxsim_pq_sum_wide": [_P] * 6 + [_I] * 7 + [_P],
    },
    "maxsim_train": {
        "evdr_maxsim_bwd": [_P] * 8 + [_I] * 7 + [_P],
        "evdr_maxsim_bwd_f32": [_P] * 8 + [_I] * 7 + [_P],
        "evdr_bwd_config": [_I] * 3 + [_P],
        "evdr_maxsim_bwd_wide": [_P] * 10 + [_I] * 5 + [_P],
        "evdr_maxsim_bwd_f32_wide": [_P] * 10 + [_I] * 5 + [_P],
    },
    "rerank_int8": {
        "evdr_rerank_int8": [_P] * 7 + [_I] * 6 + [_P],
    },
}

# library -> the sources compiled into it beside csrc/<library>.cu: K2
# int8full's wgmma kernel (a file of its own) joins K2's library
EXTRA_SOURCES = {"maxsim_int8": ("maxsim_int8full_wg.cu",)}

_lock = threading.Lock()
_loaded: dict = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def sources(name: str) -> list:
    """The ``.cu`` files library ``name`` is compiled from."""
    return [CSRC / f"{name}.cu"] + [CSRC / f
                                    for f in EXTRA_SOURCES.get(name, ())]


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_ROOT / f"{name}-{_source_hash()}" / f"lib{name}.so"


def build_all(names=None) -> float:
    """Compile every library in ``names`` (default: all) that is not built
    yet, one nvcc per source in parallel. Returns the wall seconds spent;
    raises RuntimeError with the compiler's output if any build fails.
    Each build writes its nvcc output (``-Xptxas=-v``: registers, shared
    memory, spills) to ``build.log`` beside the library."""
    names = list(LIBRARIES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = []
    for n in todo:
        out = library_path(n)
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(out.parent / "build.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources(n))]
        procs.append((n, out, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for n, out, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{n} (nvcc rc={rc}):\n"
                          + (out.parent / "build.log").read_text())
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    path = library_path(name).parent / "build.log"
    return path.read_text() if path.exists() else ""


def kernel(name: str, func: str):
    """The ctypes function ``func`` of library ``name``, built and loaded on
    first use (restype int: the launch's cudaGetLastError())."""
    key = (name, func)
    with _lock:
        if key not in _loaded:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, func)
            fn.argtypes = LIBRARIES[name][func]
            fn.restype = ctypes.c_int
            _loaded[key] = fn
        return _loaded[key]
