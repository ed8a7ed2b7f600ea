"""Profiling helpers on the GPU: device memory reporting and a trace
context (the port of ``evdr_tpu/utils/timing.py``, replacements for the
reference's CUDA memory dump, mainv2_distill_infonce.py:44-53).

``enable_persistent_cache`` (JAX's compilation cache) has no counterpart:
PyTorch runs eagerly and the kernels are built once per source hash
(``ops/_cuda_build.py``).
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict


def device_memory_report() -> Dict[str, Dict[str, int]]:
    """Per-GPU allocator bytes, current and peak
    (``torch.cuda.memory_stats``): ``{"cuda:0": {"bytes_in_use": ...,
    "peak_bytes_in_use": ...}}``, the JAX report's keys. Raises where no
    GPU is present (the port's rule: nothing falls back)."""
    import torch

    from evdr_tpu_torch.engine import resolve_device

    resolve_device("cuda")
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
        }
    return out


def trace_ctx(trace_dir=None):
    """A ``torch.profiler`` context over the CPU and the GPU (the JAX
    package's ``jax.profiler`` trace hook). With a directory it writes a
    Chrome trace of everything run inside the context to
    ``<dir>/trace.json`` (chrome://tracing or ui.perfetto.dev); with None
    it is a no-op, so call sites can wrap their hot section
    unconditionally:

        with trace_ctx(args.trace):
            run_benchmark()
    """
    if not trace_dir:
        return contextlib.nullcontext()
    return _trace(str(trace_dir))


@contextlib.contextmanager
def _trace(trace_dir: str):
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
