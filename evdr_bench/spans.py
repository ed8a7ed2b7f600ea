"""The program's spans in a traced window: what each ``evdr.`` span of
``evdr_tpu_torch`` (``utils/timing.span``) held, read from the Chrome trace
of a profile that records every thread.

For each span name, over the spans that start in the window:
- ``count``, and ``host_ms``: their time on the host, clipped to the window;
- ``device_ms``: kernels, copies and sets whose launch (the runtime or
  driver call with the same ``correlation``) ran while the span was open on
  the launching thread, its children included. A launch from a thread with
  no ``evdr.`` span open, such as the autograd engine's backward thread,
  goes to the innermost ``evdr.`` span open on any thread at that moment;
- ``idle_ms``: the span's time in which no kernel, copy or set ran.

The window's idle gaps are named ``<innermost evdr. span> / <innermost
operation>`` where a program span covers the gap's middle.

Run one cell with them (on a CUDA device, from the root of a checkout):

    python3 evdr_bench/spans.py --workload <name> --seed <n> --seconds <s>

runs the cell as ``run.py --trace 1`` does, with every thread profiled,
and prints, beside ``run.py``'s own output, to standard error: a ``span``
line per span name, the share of the window's device-idle time that lies
inside some span, the ten longest idle gaps named as above, and a
``metric`` line for each reader in ``SPAN_METRICS`` that finds something.
Python's garbage collections show in the trace as ranges ``gc.gen<n>``
(generation n), so an idle gap that a collection holds is named after it.
``--cost`` times a span with no profiler and under one.
"""

from __future__ import annotations

import bisect
import contextlib
import gc
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from evdr_bench import run  # noqa: E402  (first: its clock starts set-up)
from evdr_bench.trace import (DEVICE_CATS, HOST_CATS,  # noqa: E402
                              WINDOW_SPAN, TraceSummary, _merge, summarize)

PREFIX = "evdr."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the readers of the program's spans and request counters
SPAN_METRICS = ("batcher.queue_wait_p95_ms", "batcher.dispatch_idle_ms",
                "engine.idle_ms", "topk.select_ms", "maxsim.score_ms",
                "pruned.stage1_window_ms", "pruned.stage2_window_ms",
                "train.feed_ms")


@dataclass
class SpanStat:
    count: int = 0
    host_ms: float = 0.0
    device_ms: float = 0.0
    idle_ms: float = 0.0


@dataclass
class SpanSummary:
    """The spans of one traced window (``spans`` by name), the window's
    device-idle ms and the part of it inside some span, the rest by the
    innermost host operation at each stretch (``idle_outside``, ms), its
    ten longest idle gaps named by span and operation, and what every
    thread ran at the middle of the three longest (``gap_threads``)."""
    spans: Dict[str, SpanStat] = field(default_factory=dict)
    idle_ms: float = 0.0
    idle_in_spans_ms: float = 0.0
    idle_outside: Dict[str, float] = field(default_factory=dict)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    gap_threads: List[List[str]] = field(default_factory=list)


@dataclass
class SpannedTrace(TraceSummary):
    """``trace.TraceSummary`` with the window's spans beside it."""
    spans: Optional[SpanSummary] = None


def _overlap(a: list, b: list) -> float:
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


class _Open:
    """The spans open at a time: boundaries and, between each boundary and
    the next, the spans open there."""

    def __init__(self, spans):
        at = defaultdict(lambda: ([], []))
        for i, s in enumerate(spans):
            at[s[1]][0].append(i)
            at[s[2]][1].append(i)
        self.t, self.open, active = sorted(at), [], set()
        for t in self.t:
            active.update(at[t][0])
            active.difference_update(at[t][1])
            self.open.append([spans[i] for i in sorted(active)])

    def at(self, t: float) -> list:
        i = bisect.bisect_right(self.t, t) - 1
        return self.open[i] if i >= 0 else []


def window_of(events) -> Optional[Tuple[float, float]]:
    """(start, end) in microseconds of the benchmark's window span."""
    for e in events:
        if (e.get("ph") == "X" and e.get("name") == WINDOW_SPAN
                and str(e.get("cat", "")).lower() == "user_annotation"):
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    return None


def summarize_spans(events, w0: float, w1: float) -> SpanSummary:
    """The spans of Chrome-trace ``events`` (microseconds) in the window
    [w0, w1)."""
    spans, host, dev, launch = [], [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        name = str(e.get("name", "?"))
        a = float(e["ts"])
        b = a + float(e["dur"])
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((a, b, corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launch[corr] = (a, e.get("tid"))
        elif cat == "user_annotation" and name.startswith(PREFIX):
            if b > w0 and a < w1:
                spans.append((name, a, b, e.get("tid")))
        elif cat in HOST_CATS and name != WINDOW_SPAN:
            if b > w0 and a < w1:
                host.append((name, a, b, e.get("tid")))
    busy = _merge([(a, b) for a, b, _ in dev])
    out = SpanSummary()
    by_tid = defaultdict(list)
    for s in spans:
        by_tid[s[3]].append(s)
    on_tid = {tid: _Open(ss) for tid, ss in by_tid.items()}
    anywhere = _Open(spans)
    stats = defaultdict(SpanStat)
    for name, a, b, _ in spans:
        if w0 <= a < w1:
            stats[name].count += 1
        stats[name].host_ms += (min(b, w1) - max(a, w0)) * 1e-3
    for a, b, corr in dev:
        if corr not in launch:
            continue
        t, tid = launch[corr]
        owners = on_tid[tid].at(t) if tid in on_tid else []
        if not owners:
            inner = anywhere.at(t)
            if not inner:
                continue
            s = min(inner, key=lambda s: s[2] - s[1])
            owners = on_tid[s[3]].at(t)
        for name in {s[0] for s in owners}:
            stats[name].device_ms += (b - a) * 1e-3
    for name, st in stats.items():
        iv = _merge([(max(a, w0), min(b, w1)) for n, a, b, _ in spans
                     if n == name])
        tot = sum(b - a for a, b in iv)
        st.idle_ms = (tot - _overlap(iv, busy)) * 1e-3
    out.spans = dict(sorted(stats.items()))
    union = _merge([(max(a, w0), min(b, w1)) for _, a, b, _ in spans])
    out.idle_ms = ((w1 - w0) - sum(b - a for a, b in busy)) * 1e-3
    out.idle_in_spans_ms = (sum(b - a for a, b in union)
                            - _overlap(union, busy)) * 1e-3
    outside = defaultdict(float)
    for a, b in _gaps(_merge(busy + union), w0, w1):
        outside[_innermost(host, 0.5 * (a + b))] += (b - a) * 1e-3
    out.idle_outside = dict(sorted(outside.items(), key=lambda kv: -kv[1]))
    gaps = sorted(_gaps(busy, w0, w1), key=lambda g: g[0] - g[1])[:10]
    out.idle_gaps = [(_gap_name(0.5 * (a + b), anywhere, host),
                      (b - a) * 1e-6) for a, b in gaps]
    out.gap_threads = [_threads(0.5 * (a + b), spans, host)
                       for a, b in gaps[:3]]
    return out


def _gaps(busy, w0, w1) -> list:
    """The stretches of [w0, w1] that merged intervals ``busy`` leave."""
    gaps, prev = [], w0
    for a, b in list(busy) + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    return gaps


def _innermost(events, t, default="host: outside any operation") -> str:
    inner = [h for h in events if h[1] <= t <= h[2]]
    return min(inner, key=lambda h: h[2] - h[1])[0] if inner else default


def _gap_name(mid, anywhere: _Open, host) -> str:
    """``<innermost evdr. span> / <innermost operation inside it>`` at the
    gap's middle, or the innermost operation where no span covers it."""
    inner = anywhere.at(mid)
    if not inner:
        return _innermost(host, mid)
    sp = min(inner, key=lambda s: s[2] - s[1])
    ops = [h for h in host if sp[1] <= h[1] and h[2] <= sp[2]]
    op = _innermost(ops, mid, None)
    return sp[0] if op is None else f"{sp[0]} / {op}"


def _threads(mid, spans, host) -> list:
    """Each thread's innermost span or operation at ``mid``."""
    by_tid = defaultdict(list)
    for e in list(spans) + list(host):
        if e[1] <= mid <= e[2]:
            by_tid[e[3]].append(e)
    return [f"{tid}: " + min(es, key=lambda e: e[2] - e[1])[0]
            for tid, es in sorted(by_tid.items(), key=lambda kv: str(kv[0]))]


def spans_of(obs: dict) -> Optional[Dict[str, SpanStat]]:
    """The traced window's spans by name, where the trace holds them."""
    summary = getattr(obs.get("trace"), "spans", None)
    return None if summary is None else summary.spans


def per(obs: dict, name: str, value: str, by: Optional[str] = None):
    """Span ``name``'s ``value`` (``host_ms``, ``device_ms`` or
    ``idle_ms``) over the count of span ``by`` (default ``name``); None
    where the window holds neither."""
    spans = spans_of(obs)
    if not spans or name not in spans:
        return None
    n = spans.get(by or name, SpanStat()).count
    if not n:
        return None
    return getattr(spans[name], value) / n


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(prefix="evdr_bench_spans_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)


@contextlib.contextmanager
def profiled(enabled: bool, sink: list):
    """``trace.profiled`` with every thread recorded (the program's
    ``profiler_config``) and the window's spans kept: appends a
    ``SpannedTrace`` (or None) to ``sink``."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from evdr_tpu_torch.utils.timing import profiler_config

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   experimental_config=profiler_config())
    with prof:
        yield
    events = _events(prof)
    del prof
    torch.cuda.empty_cache()
    base, win = summarize(events), window_of(events)
    sink.append(None if base is None else SpannedTrace(
        **vars(base), spans=summarize_spans(events, *win)))


def report(summary: SpanSummary, out=None) -> None:
    out = out or sys.stderr
    for name, st in summary.spans.items():
        print(f"span {name}: count {st.count}, host {st.host_ms!r} ms, "
              f"device {st.device_ms!r} ms, idle {st.idle_ms!r} ms",
              file=out)
    share = (100.0 * summary.idle_in_spans_ms / summary.idle_ms
             if summary.idle_ms > 0 else 100.0)
    print(f"span idle inside evdr spans: {summary.idle_in_spans_ms!r} of "
          f"{summary.idle_ms!r} ms ({share:.2f}%)", file=out)
    for name, ms in list(summary.idle_outside.items())[:5]:
        print(f"span idle outside evdr spans: {ms!r} ms in {name}",
              file=out)
    for name, s in summary.idle_gaps:
        print(f"span gap {s * 1e3!r} ms: {name}", file=out)
    for i, threads in enumerate(summary.gap_threads):
        print(f"span gap {i} threads: {'; '.join(threads) or '-'}",
              file=out)


def span_cost(n_off: int = 200_000, n_on: int = 20_000) -> dict:
    """Microseconds a span costs with no profiler and under one (CPU and
    CUDA activities, every thread), and a request's two clock reads."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from evdr_tpu_torch.utils.timing import profiler_config, span

    def loop(n):
        t0 = time.perf_counter()
        for _ in range(n):
            with span("evdr.cost"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    def clocks(n):
        t0 = time.perf_counter()
        for _ in range(n):
            time.perf_counter()
            time.perf_counter()
        return (time.perf_counter() - t0) / n * 1e6

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    off = loop(n_off)
    with profile(activities=acts, experimental_config=profiler_config()):
        on = loop(n_on)
    return {"span_off_us": off, "span_on_us": on,
            "counters_us": clocks(n_off)}


class _Kept:
    """What a run leaves for the span readers: the window's requests (the
    open loop's), the harness's Context and the driver's Outcome."""

    def __init__(self):
        self.requests, self.ctx, self.out = [], None, None


class GCRanges:
    """A ``gc.callbacks`` entry: while a profiler runs, each garbage
    collection is a ``record_function`` range ``gc.gen<generation>`` on the
    thread that ran it (collections never overlap, so one is open at a
    time)."""

    def __init__(self):
        self.open = []

    def __call__(self, phase: str, info: dict) -> None:
        from torch.autograd import profiler
        from torch.profiler import record_function

        if phase == "start" and profiler._is_profiler_enabled:
            rf = record_function(f"gc.gen{info['generation']}")
            rf.__enter__()
            self.open.append(rf)
        elif phase == "stop" and self.open:
            self.open.pop().__exit__(None, None, None)


def _hook(kept: _Kept) -> None:
    """Lay the span reading over the harness as it stands."""
    from evdr_bench import harness, trace
    from evdr_tpu_torch.tools.serve_http import MicroBatcher

    trace.profiled = profiled
    gc.callbacks.append(GCRanges())
    submit, result = MicroBatcher.submit, harness.result

    def keep_submit(self, *a, **k):
        req = submit(self, *a, **k)
        kept.requests.append(req)
        return req

    def keep_result(ctx, out, *a, **k):
        kept.ctx, kept.out = ctx, out
        return result(ctx, out, *a, **k)

    MicroBatcher.submit, harness.result = keep_submit, keep_result


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    p.add_argument("--seconds", type=float)
    p.add_argument("--cost", action="store_true")
    a = p.parse_args(argv)
    if a.cost:
        for k, v in span_cost().items():
            print(f"span cost {k}: {v!r}", file=sys.stderr)
        return
    kept = _Kept()
    _hook(kept)
    run.main(["--workload", a.workload, "--seed", str(a.seed),
              "--seconds", str(a.seconds), "--trace", "1"])
    read_kept(kept)


def read_kept(kept: _Kept, out=None) -> dict:
    """Print the spans and the span metrics of a run that ``_hook``
    watched; return the metrics that found something."""
    out = out or sys.stderr
    from evdr_bench import harness

    obs = dict(kept.out.obs, trace=(kept.ctx.traces[0] if kept.ctx.traces
                                    else None))
    waits = [r.wait_ms for r in kept.requests
             if getattr(r, "t_start", None) is not None]
    if waits:
        obs["queue_wait_ms"] = waits
    if getattr(obs["trace"], "spans", None) is not None:
        report(obs["trace"].spans, out)
    found = {}
    for name in SPAN_METRICS:
        v = harness.reader(name).read(obs)
        if v is not None:
            found[name] = v
            print(f"metric {name}: {v!r}", file=out)
    return found


if __name__ == "__main__":
    main()
