"""An open loop of one-query requests through the serving batcher
(``tools/serve_http.MicroBatcher`` over ``RetrievalEngine.search_dense``),
as independent users of a retrieval service send them.

Traffic keys: ``rate`` requests/s, ``k``, ``pool_queries`` distinct queries
made at set-up and cycled, ``max_batch`` and ``wait_ms`` of the batcher,
``arrival_seed``, ``check_queries``. Arrivals are Poisson at ``rate``: the
``rate x seconds`` inter-arrival gaps are drawn once from ``arrival_seed``,
so every run seed offers the same gaps, in its own order. A request's latency runs from when
it was due to when its answer was ready, so a late sender or a stall
counts; a failed request counts as infinitely late. ``search_p95_ms``: the
95th percentile (nearest rank) of every request the window offers;
``search_qps``: the requests answered over the window, which closes at
the last answer.
"""

from __future__ import annotations

import math
import queue
import threading
import time

import numpy as np

from evdr_bench import gen, serving
from evdr_bench.harness import Outcome

WAIT_AFTER_CLOSE_S = 60.0


def due_times(tr: dict, seed: int, seconds: float) -> np.ndarray:
    """Send times (s from the window's start) of ``rate x seconds``
    requests: the same exponential gaps for every seed, in the seed's
    order, so every run offers as many requests over as long a time."""
    rate = float(tr["rate"])
    n = max(1, int(round(rate * seconds)))
    gaps = np.random.default_rng(int(tr["arrival_seed"])).exponential(
        1.0 / rate, n)
    gaps = np.random.default_rng(gen.seed_for(seed, "arrivals")).permutation(
        gaps)
    return np.cumsum(gaps) - gaps[0]


def play(batcher, Qh, qmh, due, k: int, t0: float):
    """Send request i at ``t0 + due[i]`` (query ``i % len(Qh)``); return
    each request's answer time (inf where none came), its request object
    and the time the sender was late for it."""
    n = len(due)
    done = np.full(n, np.inf)
    reqs = [None] * n
    late = np.zeros(n)
    q: queue.Queue = queue.Queue()
    deadline = t0 + float(due[-1] if n else 0.0) + WAIT_AFTER_CLOSE_S

    def collect():
        while True:
            item = q.get()
            if item is None:
                return
            i, req = item
            if req.done.wait(timeout=max(0.0, deadline - time.perf_counter())):
                done[i] = time.perf_counter() if req.err is None else np.inf

    th = threading.Thread(target=collect, name="evdr-bench-collector")
    th.start()
    try:
        m = len(Qh)
        for i in range(n):
            target = t0 + float(due[i])
            dt = target - time.perf_counter()
            if dt > 0:
                time.sleep(dt)
            late[i] = time.perf_counter() - target
            j = i % m
            reqs[i] = batcher.submit(Qh[j:j + 1], qmh[j:j + 1], k)
            q.put((i, reqs[i]))
    finally:
        q.put(None)
        th.join()
    return done, reqs, late


def p95(lat: np.ndarray) -> float:
    """The 95th percentile by nearest rank (an infinite latency counts)."""
    if len(lat) == 0:
        return math.inf
    s = np.sort(lat)
    return float(s[max(0, math.ceil(0.95 * len(s)) - 1)])


def run(ctx) -> Outcome:
    from evdr_tpu_torch.tools.serve_http import MicroBatcher, _batch_bucket

    tr = ctx.traffic
    k, n_pool = int(tr["k"]), int(tr["pool_queries"])
    eng, Q, qmask = serving.build(ctx, n_pool)
    Qh, qmh = Q.cpu().numpy(), qmask.cpu().numpy()
    max_batch = int(tr["max_batch"])
    # every group bucket the batcher can form
    b = 1
    while b <= _batch_bucket(max_batch):
        eng.search_dense(Qh[:b], qmh[:b], k=k)
        b *= 2
    batcher = MicroBatcher(eng, wait_ms=float(tr["wait_ms"]),
                           max_batch=max_batch)
    try:
        due = due_times(tr, ctx.seed, ctx.seconds)
        ctx.setup_done()
        with ctx.window() as w:
            done, reqs, late = play(batcher, Qh, qmh, due, k, w.t0)
    finally:
        batcher.close()
    lat = done - (w.t0 + due)
    ok = np.isfinite(done)
    peak = ctx.memory_peak()
    obs = {"window_s": w.seconds, "requests": len(due),
           "batched_with": [r.batched_with for r in reqs if r is not None],
           "sender_late_ms_p95": p95(late * 1e3)}
    del eng, batcher
    ctx.free()
    pick = serving.sample(ctx, len(due), int(tr["check_queries"]))
    vals, idx = serving.answers(
        [(reqs[i].vals, reqs[i].idx, 0) if reqs[i].vals is not None
         else (np.zeros((0, k)), np.zeros((0, k)), 0) for i in pick], k)
    numbers = serving.compare(ctx, vals, idx, pick % n_pool, Q, qmask)
    return Outcome(
        e2e={"search_qps": int(ok.sum()) / w.seconds,
             "search_p95_ms": p95(lat) * 1e3},
        attempted=len(due), failed=int((~ok).sum()), numbers=numbers,
        memory_peak_bytes=peak, obs=obs)
