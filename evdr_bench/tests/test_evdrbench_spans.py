"""The program's spans as the benchmark reads them (``spans.py``): device
time by launch correlation, idle time inside a span, nesting, the named
idle gaps, and the readers of the span metrics."""

from __future__ import annotations

import json

import numpy as np
import pytest

from evdr_bench import harness, spans, trace

MAIN, AUTOGRAD = 1, 2


def _x(cat, name, ts, dur, tid=MAIN, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace():
    """One search from 100 to 600 us in a 1 ms window: the score span
    launches k1, a thread with no span open launches k2 (it goes to the
    innermost span open anywhere), the fetch span launches a copy, and k3
    runs outside every span."""
    return [
        _x("user_annotation", trace.WINDOW_SPAN, 0, 1000),
        _x("user_annotation", "evdr.engine.search", 100, 500),
        _x("user_annotation", "evdr.topk.score", 150, 150),
        _x("user_annotation", "evdr.engine.fetch", 500, 90),
        _x("user_annotation", "bench.search_dense", 95, 510),
        _x("cpu_op", "aten::copy_", 100, 20),
        _x("cpu_op", "aten::sort", 800, 100),
        _x("cuda_runtime", "cudaLaunchKernel", 160, 5, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 320, 5, AUTOGRAD, corr=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 510, 5, corr=3),
        _x("cuda_driver", "cuLaunchKernel", 700, 1, corr=4),
        _x("kernel", "k1", 200, 250, corr=1),
        _x("kernel", "k2", 460, 20, corr=2),
        _x("gpu_memcpy", "copy", 520, 20, corr=3),
        _x("kernel", "k3", 700, 20, corr=4),
    ]


def test_device_time_goes_to_the_spans_open_at_its_launch():
    s = spans.summarize_spans(_trace(), 0.0, 1000.0)
    assert set(s.spans) == {"evdr.engine.search", "evdr.topk.score",
                            "evdr.engine.fetch"}
    search = s.spans["evdr.engine.search"]
    # k1 through its child, k2 from the other thread, the copy: not k3
    assert search.device_ms == pytest.approx(0.290)
    assert s.spans["evdr.topk.score"].device_ms == pytest.approx(0.250)
    assert s.spans["evdr.engine.fetch"].device_ms == pytest.approx(0.020)
    assert search.count == 1 and search.host_ms == pytest.approx(0.5)


def test_idle_inside_a_span_is_its_time_without_device_activity():
    s = spans.summarize_spans(_trace(), 0.0, 1000.0)
    assert s.spans["evdr.engine.search"].idle_ms == pytest.approx(0.210)
    assert s.spans["evdr.topk.score"].idle_ms == pytest.approx(0.050)
    assert s.spans["evdr.engine.fetch"].idle_ms == pytest.approx(0.070)
    # the window: 1000 us less 310 us busy; spans cover 210 us of it
    assert s.idle_ms == pytest.approx(0.690)
    assert s.idle_in_spans_ms == pytest.approx(0.210)
    # the rest by the innermost operation at each stretch
    assert s.idle_outside == pytest.approx(
        {"aten::sort": 0.280, "host: outside any operation": 0.200})


def test_idle_gaps_are_named_by_span_and_operation_as_trace_finds_them():
    ev = _trace()
    s = spans.summarize_spans(ev, 0.0, 1000.0)
    base = trace.summarize(ev)
    # the same gaps, in the same order, as the harness's summary
    assert [g for _, g in s.idle_gaps] == pytest.approx(
        [g for _, g in base.idle_gaps])
    assert [n for n, _ in s.idle_gaps] == [
        "aten::sort",
        "evdr.engine.search / aten::copy_",
        "host: outside any operation",
        "evdr.engine.fetch",
        "evdr.engine.search"]
    # each thread's innermost span or operation at the longest gaps' middle
    assert s.gap_threads[0] == [f"{MAIN}: aten::sort"]
    assert s.gap_threads[1] == [f"{MAIN}: aten::copy_"]


def test_spans_clip_to_the_window_and_count_those_starting_in_it():
    ev = _trace() + [_x("user_annotation", "evdr.batcher.wait", -400, 450,
                        tid=3)]
    s = spans.summarize_spans(ev, 0.0, 1000.0)
    wait = s.spans["evdr.batcher.wait"]
    assert wait.count == 0 and wait.host_ms == pytest.approx(0.050)
    assert wait.idle_ms == pytest.approx(0.050)


def test_nested_spans_of_one_name_count_their_device_time_once():
    ev = _trace() + [_x("user_annotation", "evdr.topk.score", 155, 100)]
    s = spans.summarize_spans(ev, 0.0, 1000.0)
    st = s.spans["evdr.topk.score"]
    assert st.count == 2 and st.device_ms == pytest.approx(0.250)


def _obs(**stats):
    summary = spans.SpanSummary(spans={
        name: spans.SpanStat(*v) for name, v in stats.items()})
    return {"trace": spans.SpannedTrace(1.0, 0.5, 3, [], [],
                                        spans=summary)}


@pytest.mark.parametrize("name", spans.SPAN_METRICS)
def test_readers_find_nothing_without_the_programs_spans(name):
    r = harness.reader(name)
    assert r.read({}) is None
    # the harness's summary has no spans (a program without them)
    assert r.read({"trace": trace.TraceSummary(1.0, 0.5, 3, [], []),
                   "batched_with": [1]}) is None


@pytest.mark.parametrize("name,stats,want", [
    ("batcher.dispatch_idle_ms",
     {"evdr.batcher.dispatch": (4, 200.0, 180.0, 8.0)}, 2.0),
    ("engine.idle_ms", {"evdr.engine.search": (5, 900.0, 880.0, 5.0)}, 1.0),
    ("topk.select_ms", {"evdr.engine.search": (4, 0, 0, 0),
                        "evdr.topk.select": (8, 0, 3.2, 0)}, 0.8),
    ("maxsim.score_ms", {"evdr.engine.search": (2, 0, 0, 0),
                         "evdr.topk.score": (2, 0, 340.0, 0)}, 170.0),
    ("pruned.stage1_window_ms", {"evdr.pruned.stage1": (3, 0, 60.0, 0)},
     20.0),
    ("pruned.stage2_window_ms", {"evdr.pruned.stage2": (2, 0, 330.0, 0)},
     165.0),
    ("train.feed_ms", {"evdr.train.step": (10, 0, 0, 0),
                       "evdr.train.feed": (10, 25.0, 0, 0)}, 2.5),
])
def test_span_readers_divide_by_their_calls(name, stats, want):
    assert harness.reader(name).read(_obs(**stats)) == pytest.approx(want)


def test_a_reader_of_a_span_the_window_lacks_finds_nothing():
    obs = _obs(**{"evdr.topk.score": (2, 0, 340.0, 0)})
    assert harness.reader("maxsim.score_ms").read(obs) is None
    assert harness.reader("pruned.stage1_window_ms").read(obs) is None


def test_queue_wait_p95_is_the_nearest_rank():
    r = harness.reader("batcher.queue_wait_p95_ms")
    waits = list(np.arange(1, 101, dtype=float))
    assert r.read({"queue_wait_ms": waits}) == 95.0
    assert r.read({"queue_wait_ms": [3.0]}) == 3.0


def test_a_real_trace_of_the_program_on_the_cpu(tmp_path):
    """The engine's spans from ``trace_ctx`` on the CPU: counted, on the
    host clock, with no device time."""
    from evdr_tpu_torch import RetrievalEngine
    from evdr_tpu_torch.utils.timing import trace_ctx

    rng = np.random.default_rng(3)
    P = rng.normal(size=(20, 8, 16)).astype(np.float32)
    eng = RetrievalEngine(dtype="int8", device="cpu").build(
        P, np.ones((20, 8), bool))
    Q = rng.normal(size=(2, 4, 16)).astype(np.float32)
    with trace_ctx(tmp_path):
        for _ in range(3):
            eng.search_dense(Q, np.ones((2, 4), bool), k=3)
    ev = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    timed = [e for e in ev if "ts" in e and "dur" in e]
    s = spans.summarize_spans(
        ev, min(float(e["ts"]) for e in timed),
        max(float(e["ts"]) + float(e["dur"]) for e in timed))
    search = s.spans["evdr.engine.search"]
    assert search.count == 3 and search.host_ms > 0
    assert s.spans["evdr.topk.score"].count == 3
    assert all(st.device_ms == 0 for st in s.spans.values())
    assert s.spans["evdr.topk.score"].host_ms < search.host_ms


def test_span_cost_reads_on_the_cpu():
    cost = spans.span_cost(n_off=1000, n_on=200)
    assert set(cost) == {"span_off_us", "span_on_us", "counters_us"}
    assert all(v > 0 for v in cost.values())


def test_a_garbage_collection_is_a_range_in_the_trace(tmp_path):
    """``GCRanges`` marks a collection under a running profile and builds
    nothing without one."""
    import gc

    from evdr_tpu_torch.utils.timing import trace_ctx

    ranges = spans.GCRanges()
    gc.callbacks.append(ranges)
    try:
        gc.collect()
        with trace_ctx(tmp_path):
            gc.collect(1)
            gc.collect()
    finally:
        gc.callbacks.remove(ranges)
    ev = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in ev if e.get("cat") == "user_annotation"]
    assert names.count("gc.gen1") == 1 and names.count("gc.gen2") == 1
    assert not ranges.open
