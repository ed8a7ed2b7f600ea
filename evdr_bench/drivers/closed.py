"""A closed loop of query batches through ``RetrievalEngine.search_dense``.

Traffic keys: ``batch`` queries a call, ``k``, ``pool_batches`` distinct
batches made at set-up and cycled, ``n_candidates`` (pruned search, with
``prune_centroids`` and ``summary_dtype`` for the build), ``check_queries``
answers compared after the window. One caller waits for each answer
before it sends the next batch, as a batch job or a reranking stage does.
``search_qps``: the queries of every call in the window over the window,
which ends when the last call returns.
"""

from __future__ import annotations

import numpy as np

from evdr_bench import serving
from evdr_bench.harness import Outcome


def run(ctx) -> Outcome:
    tr = ctx.traffic
    batch, n_b, k = int(tr["batch"]), int(tr["pool_batches"]), int(tr["k"])
    nc = tr.get("n_candidates")
    eng, Q, qmask = serving.build(ctx, batch * n_b)

    def search(b):
        s = slice(b * batch, (b + 1) * batch)
        return eng.search_dense(Q[s], qmask[s], k=k, n_candidates=nc)

    for b in range(min(2, n_b)):
        search(b)
    ctx.setup_done()
    calls = []
    with ctx.window() as w:
        i = 0
        while True:
            with ctx.span("bench.search_dense"):
                vals, idx = search(i % n_b)
            calls.append((i % n_b, vals, idx))
            i += 1
            if w.elapsed() >= ctx.seconds:
                break
    peak = ctx.memory_peak()
    obs = {"window_s": w.seconds, "calls": len(calls)}
    if ctx.trace and ctx.device != "cpu":
        obs.update(serving.layer_timings(ctx, eng, Q[:batch], qmask[:batch]))
    del eng
    ctx.free()
    pick = serving.sample(ctx, len(calls) * batch, int(tr["check_queries"]))
    call, row = pick // batch, pick % batch
    vals, idx = serving.answers([(calls[c][1], calls[c][2], r)
                                 for c, r in zip(call, row)], k)
    qid = np.array([calls[c][0] * batch + r for c, r in zip(call, row)])
    numbers = serving.compare(ctx, vals, idx, qid, Q, qmask)
    n = len(calls) * batch
    return Outcome(e2e={"search_qps": n / w.seconds}, attempted=n, failed=0,
                   numbers=numbers, memory_peak_bytes=peak, obs=obs)
