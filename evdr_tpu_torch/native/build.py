"""Build/load the native library (g++ -> .so).

The library is cached under ``build/evdr_tpu_torch_native/`` at the
repository root (keyed on a hash of the sources), never where the JAX
package caches its own, so the two packages never share a ``.so``."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

SRC_DIR = Path(__file__).resolve().parent
SOURCES = ["metrics.cpp"]
CACHE_DIR = SRC_DIR.parents[1] / "build" / "evdr_tpu_torch_native"


def _src_digest() -> str:
    h = hashlib.sha256()
    for s in SOURCES:
        h.update((SRC_DIR / s).read_bytes())
    return h.hexdigest()[:16]


def _lib_path() -> Path:
    return CACHE_DIR / f"libevdr_{_src_digest()}.so"


def build_library(verbose: bool = False) -> Path:
    out = _lib_path()
    if out.exists():
        return out
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename into place: concurrent builders
    # (test workers) never dlopen a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           "-o", str(tmp)] + [str(SRC_DIR / s) for s in SOURCES]
    if verbose:
        print("[native]", " ".join(cmd))
    try:
        subprocess.run(cmd, check=True, capture_output=not verbose)
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def load_library() -> Optional[ctypes.CDLL]:
    """Compile (if needed) and dlopen the native library; None on failure."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        _lib = ctypes.CDLL(str(build_library()))
    except Exception:
        _load_failed = True
        _lib = None
    return _lib


if __name__ == "__main__":
    path = build_library(verbose=True)
    print(f"[native] built {path}")
