"""The traced window: ``torch.profiler`` over the CPU and the GPU, reduced to
what the per-layer readers and the result's ``device`` and ``breakdown``
need.

The window is the span ``bench.window`` that the harness records around
the measured loop (a ``torch.cuda.synchronize`` closes it, so every kernel
it launched ends inside it). From the Chrome trace that the profiler
exports to ``TMPDIR`` (deleted once read):
- device activity: kernels, copies and sets, clipped to the window, merged
  into busy intervals; ``busy_s`` is their union;
- ``device_ops``: device seconds by kernel name, the 10 largest;
- ``idle_gaps``: the 10 longest gaps with no device activity, each named by
  the innermost host operation or benchmark span that was running at its
  middle.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass
from typing import List, Optional, Tuple

WINDOW_SPAN = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: int
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


@contextlib.contextmanager
def profiled(enabled: bool, sink: list):
    """Profile the block when ``enabled``; append its ``TraceSummary`` (or
    None where the trace holds no window) to ``sink``."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        yield
    fd, path = tempfile.mkstemp(prefix="evdr_bench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    del prof
    torch.cuda.empty_cache()
    sink.append(summarize(events))


def idle_pct(obs: dict, count: str):
    """The share (%) of the traced window in which no kernel, copy or set
    ran on the card, where the window ran some ``obs[count]`` calls or
    steps; None where there is nothing to read."""
    t = obs.get("trace")
    if t is None or not obs.get(count) or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def _merge(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events) -> Optional[TraceSummary]:
    """Reduce Chrome-trace events (times in microseconds) to the window's
    summary."""
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == WINDOW_SPAN
           and str(e.get("cat", "")).lower() == "user_annotation"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, host = [], []
    by_name = defaultdict(float)
    n_kernels = 0
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        a = float(e["ts"])
        b = a + float(e["dur"])
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            dev.append((a, b))
            by_name[str(e.get("name", "?"))[:120]] += (b - a) * 1e-6
            n_kernels += cat == "kernel"
        elif cat in HOST_CATS and e.get("name") != WINDOW_SPAN:
            if b > w0 and a < w1:
                host.append((a, b, str(e.get("name", "?"))[:120]))
    busy = _merge(dev)
    busy_us = sum(b - a for a, b in busy)
    gaps, prev = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        inner = [h for h in host if h[0] <= mid <= h[1]]
        name = (min(inner, key=lambda h: h[1] - h[0])[2] if inner
                else "host: outside any operation")
        named.append((name, (b - a) * 1e-6))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                        kernels=int(n_kernels), device_ops=ops[:10],
                        idle_gaps=named)
