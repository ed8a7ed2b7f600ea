"""The port's spans and request counters on the CPU: ``utils/timing.span``
builds nothing while no profiler runs; under ``trace_ctx`` the engine's
search, the top-k, pruned search's stages, a training step and the
serving batcher's thread record their ``evdr.`` spans, nested in time;
a coalesced group's requests share their dispatch's start time."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from evdr_tpu_torch import RetrievalEngine
from evdr_tpu_torch.tools.serve_http import MicroBatcher
from evdr_tpu_torch.train import harness as th
from evdr_tpu_torch.train.config import TrainConfig
from evdr_tpu_torch.utils import timing
from evdr_tpu_torch.utils.timing import span, trace_ctx

STEP_CHILDREN = ("evdr.train.feed", "evdr.train.forward",
                 "evdr.train.backward", "evdr.train.optimizer")


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def engine():
    rng = np.random.default_rng(5)
    P = _unit(rng.normal(size=(40, 12, 16))).astype(np.float32)
    pm = rng.random((40, 12)) > 0.2
    pm[:, 0] = True
    return RetrievalEngine(dtype="int8", device="cpu", prune_centroids=2,
                           normalize=False).build(P, pm)


def _queries(n, seed=6):
    rng = np.random.default_rng(seed)
    Q = _unit(rng.normal(size=(n, 4, 16))).astype(np.float32)
    qm = np.ones((n, 4), bool)
    qm[:, -1] = False
    return Q, qm


def _train_step(loss="liscore", chunk_p=8):
    """(run_step, batch) of a tiny distillation on the CPU, its teacher
    table precomputed."""
    g = torch.Generator().manual_seed(7)
    P = torch.nn.functional.normalize(torch.randn(10, 6, 16, generator=g),
                                      dim=-1)
    pm = torch.ones(10, 6, dtype=torch.bool)
    Q = torch.nn.functional.normalize(torch.randn(20, 4, 16, generator=g),
                                      dim=-1)
    qm = torch.ones(20, 4, dtype=torch.bool)
    cfg = TrainConfig(loss=loss, q_batch=4, lr=1e-3, k=4,
                      chunk_p=chunk_p).validate()
    bundle = th.DatasetBundle(
        dataset="x", Q_train=Q, qmask_train=qm, pos_idx=None,
        Q_test=Q[:0], qmask_test=qm[:0], P_teacher_norm=P, pmask_teacher=pm,
        docid_teacher=np.arange(10), relevant_docs_test={},
        docidx_2_docid_test={}, qsidx_2_query_test=None)
    bundle.sc_t_train = th._precompute_teacher_scores(
        Q, qm, P, pm, chunk_q=8, chunk_p=chunk_p, impl="xla")
    param = P[:, :3].clone().requires_grad_(True)
    opt = th.make_optimizer(cfg, param)
    run_step = th.build_train_step(cfg, bundle, pm[:, :3], opt)
    return run_step, np.arange(4)


def _spans(trace_dir):
    """The trace's ``evdr.`` spans: [(name, start, end, tid)]."""
    with open(trace_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e.get("tid")) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith("evdr.")]


def _inside(child, parents):
    """Whether span ``child`` lies within one of ``parents`` in time, on
    the same thread."""
    _, a, b, tid = child
    return any(pa <= a and b <= pb and ptid == tid
               for _, pa, pb, ptid in parents)


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def test_span_is_the_shared_no_op_without_a_profiler(engine, monkeypatch):
    def refuse(name, *a, **k):
        raise AssertionError(f"record_function({name!r}) was built")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert span("evdr.a") is span("evdr.b") is timing._NO_SPAN
    Q, qm = _queries(3)
    engine.search_dense(Q, qm, k=4)
    engine.search_dense(Q, qm, k=4, n_candidates=8)
    run_step, idx = _train_step()
    run_step(idx, 0)
    run_step(np.stack([idx, idx + 4]), 1)
    batcher = MicroBatcher(engine)
    try:
        batcher.search_dense(Q[:1], qm[:1], k=4)
    finally:
        batcher.close()


def test_a_search_records_its_spans_nested(engine, tmp_path):
    Q, qm = _queries(3)
    with trace_ctx(tmp_path):
        engine.search_dense(Q, qm, k=4)
    spans = _spans(tmp_path)
    (search,) = _named(spans, "evdr.engine.search")
    for name in ("evdr.engine.queries", "evdr.topk.score",
                 "evdr.topk.select", "evdr.engine.fetch"):
        inner = _named(spans, name)
        assert len(inner) == 1 and _inside(inner[0], [search]), name


def test_a_pruned_search_records_both_stages(engine, tmp_path):
    Q, qm = _queries(3)
    with trace_ctx(tmp_path):
        engine.search_dense(Q, qm, k=4, n_candidates=8)
    spans = _spans(tmp_path)
    (search,) = _named(spans, "evdr.engine.search")
    (s1,) = _named(spans, "evdr.pruned.stage1")
    (s2,) = _named(spans, "evdr.pruned.stage2")
    assert _inside(s1, [search]) and _inside(s2, [search])
    assert s1[2] <= s2[1]
    # stage 1 scores the summaries and selects the candidates; stage 2's
    # rerank selects the top-k among them
    assert _inside(_named(spans, "evdr.topk.score")[0], [s1])
    selects = _named(spans, "evdr.topk.select")
    assert any(_inside(s, [s1]) for s in selects)
    assert any(_inside(s, [s2]) for s in selects)
    assert all(_inside(f, [search])
               for f in _named(spans, "evdr.engine.fetch"))


@pytest.mark.parametrize("k_steps", [1, 2])
def test_a_train_step_records_the_step_and_its_children(tmp_path, k_steps):
    run_step, idx = _train_step()
    batch = idx if k_steps == 1 else np.stack([idx, idx + 4])
    with trace_ctx(tmp_path):
        run_step(batch, 0)
    spans = _spans(tmp_path)
    steps = _named(spans, "evdr.train.step")
    assert len(steps) == k_steps
    for name in STEP_CHILDREN:
        inner = _named(spans, name)
        if name == "evdr.train.feed":
            # one feed a dispatch: inside the step for one batch, before
            # the first row's step for K
            assert len(inner) == 1
            assert _inside(inner[0], steps) == (k_steps == 1)
            assert k_steps == 1 or inner[0][2] <= steps[0][1]
        else:
            assert len(inner) == k_steps
            assert all(_inside(s, steps) for s in inner), name


def test_the_teacher_table_records_its_span(tmp_path):
    with trace_ctx(tmp_path):
        _train_step()
    assert len(_named(_spans(tmp_path), "evdr.train.teacher_table")) == 1


def test_the_batchers_thread_records_its_spans(engine, tmp_path):
    """The dispatcher thread starts before the profile; its spans are
    recorded all the same, apart from the main thread's."""
    Q, qm = _queries(4)
    batcher = MicroBatcher(engine)
    try:
        with trace_ctx(tmp_path):
            for i in range(3):
                batcher.search_dense(Q[i:i + 1], qm[i:i + 1], k=4)
        # the wait open when the profile stopped ends later without harm
        vals, _ = batcher.search_dense(Q[3:], qm[3:], k=4)
        assert vals.shape == (1, 4)
    finally:
        batcher.close()
    spans = _spans(tmp_path)
    dispatches = _named(spans, "evdr.batcher.dispatch")
    assert len(dispatches) == 3
    assert {s[3] for s in dispatches} != {threading.get_native_id()}
    for name in ("evdr.batcher.assemble", "evdr.engine.search",
                 "evdr.batcher.scatter"):
        inner = _named(spans, name)
        assert len(inner) == 3 and all(_inside(s, dispatches)
                                       for s in inner), name
    assert _named(spans, "evdr.batcher.wait")


def test_a_coalesced_group_shares_its_dispatch_counters(engine):
    Q, qm = _queries(5)
    batcher = MicroBatcher(engine, max_batch=8)
    try:
        with batcher.engine_lock:
            first = batcher.submit(Q[:1], qm[:1], k=4)
            # the dispatcher holds the first request, blocked on the lock
            deadline = time.monotonic() + 30
            while batcher._pending and time.monotonic() < deadline:
                time.sleep(0.001)
            rest = [batcher.submit(Q[i:i + 1], qm[i:i + 1], k=4)
                    for i in range(1, 5)]
        for r in [first] + rest:
            assert r.done.wait(timeout=60) and r.err is None
    finally:
        batcher.close()
    assert first.batched_with == 1
    assert {r.batched_with for r in rest} == {4}
    assert len({r.t_start for r in rest}) == 1
    for r in [first] + rest:
        assert r.t_submit <= r.t_start and r.wait_ms >= 0.0
    assert first.t_start <= rest[0].t_start
