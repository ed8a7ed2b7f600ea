"""Profiling helpers on the GPU: device memory reporting, a trace context
and the program's spans (the port of ``evdr_tpu/utils/timing.py``,
replacements for the reference's CUDA memory dump,
mainv2_distill_infonce.py:44-53).

The program marks its layer boundaries with :func:`span`. Under a running
``torch.profiler`` (``trace_ctx``, or any profile the caller starts) a span
is a ``record_function`` range in the profiler's own timeline, on the
clock of the kernels, copies and sets that it records; otherwise it is one
flag check. Span names start with ``evdr.``; a span's parent is the span
that encloses it on the same thread:

- ``evdr.batcher.wait``, ``evdr.batcher.dispatch`` (children
  ``evdr.batcher.assemble``, ``evdr.batcher.scatter``):
  ``tools/serve_http.MicroBatcher``;
- ``evdr.engine.search`` (children ``evdr.engine.queries``,
  ``evdr.engine.fetch``): ``RetrievalEngine.search_dense``;
- ``evdr.topk.score``, ``evdr.topk.select``: ``parallel/topk.py``, every
  kernel route and every selection;
- ``evdr.pruned.stage1``, ``evdr.pruned.stage2``: the two stages of
  pruned search, on one device and on a mesh;
- ``evdr.mesh.shard`` (one shard's scores and local top-k),
  ``evdr.mesh.gather`` (copies between devices: the queries out to each
  shard, ``parallel/topk._on``, and every ``parallel/mesh.gather_blocks``)
  and ``evdr.mesh.merge`` (the candidates' gather and final sort,
  ``parallel/topk.merge_shard_topk``): a search on a doc mesh;
- ``evdr.index.build_block``: one block of a block build
  (``parallel/sharded_index.build_sharded_index_blocks``);
- ``evdr.train.step`` (children ``evdr.train.feed``,
  ``evdr.train.forward``, ``evdr.train.backward``,
  ``evdr.train.optimizer``) and ``evdr.train.teacher_table``:
  ``train/harness.py``.

Counters beside the spans: ``parallel/mesh.TRANSFER_BYTES``, the bytes a
search moves between devices (``queries`` out, ``candidates`` back,
whole ``scores``; a copy within one device counts nothing), always on.

``enable_persistent_cache`` (JAX's compilation cache) has no counterpart:
PyTorch runs eagerly and the kernels are built once per source hash
(``ops/_cuda_build.py``).
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict

import torch
from torch.autograd import profiler as _profiler

# what span() returns while no profiler runs: one object, shared by every
# call and thread (a nullcontext holds no state)
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named range of the program for a running ``torch.profiler``: its
    ``record_function(name)``. With no profiler running, the shared no-op
    context: nothing is built, the call costs one flag check."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def profiler_config():
    """The profiler's experimental config that records every thread
    (``profile_all_threads``): without it, ``torch.profiler`` records the
    operations and spans of only the thread that started it, and misses a
    dispatcher thread such as ``MicroBatcher``'s. None where the installed
    torch has no such option."""
    try:
        return torch.profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


def device_memory_report() -> Dict[str, Dict[str, int]]:
    """Per-GPU allocator bytes, current and peak
    (``torch.cuda.memory_stats``): ``{"cuda:0": {"bytes_in_use": ...,
    "peak_bytes_in_use": ...}}``, the JAX report's keys. Raises where no
    GPU is present (the port's rule: nothing falls back)."""
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
    package's ``jax.profiler`` trace hook), every thread included
    (:func:`profiler_config`). With a directory it writes a Chrome trace
    of everything run inside the context, the ``evdr.`` spans among it, to
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
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 experimental_config=profiler_config()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
