"""A closed loop of query batches through ``RetrievalEngine.search_dense``
over an index that one card holds but no host could make whole: the
corpus is built from blocks on the card, as ``closed_mesh.py`` builds a
mesh's shards.

Traffic keys as ``closed.py``: ``batch`` queries a call, ``k``,
``pool_batches`` distinct batches made at set-up and cycled,
``check_queries`` answers compared after the window. The configuration
names the index's storage (``index_dtype``, ``quantize_queries``); its
search is held to the int4-by-int8 reference (``reference_int4q8``:
queries at +-127, pages at +-7) over every page.

No process ever holds the float corpus:
- the engine builds from blocks (``RetrievalEngine.build_blocks`` with
  ``closed_mesh.BlockSource``), quantizing and packing each block on the
  card;
- the query pool's target pages are made again from their own blocks
  (``closed_mesh.make_queries``);
- the reference scores the generator's blocks one at a time, after the
  window and once the engine is gone.

``search_qps``: the queries of every call in the window over the window.
Traced runs also time, after the window, one whole-index
``sharded_maxsim`` on one batch and its bound (``serving.layer_timings``)
and read the program's count of index bytes the kernels covered in the
window (``ops/cuda_maxsim.INDEX_BYTES_READ``, where the program has it).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from evdr_bench import check, gen, harness, reference_int4q8, serving
from evdr_bench.harness import Outcome

closed_mesh = harness.driver("closed_mesh")


def _zeros(lo: int, hi: int, device):
    """A source of ``hi - lo`` masked pages of two zero tokens at D 16."""
    return (torch.zeros((hi - lo, 2, 16), device=device),
            torch.zeros((hi - lo, 2), dtype=torch.bool, device=device))


def program_engine(ctx):
    """The program's engine class; fails at once where it cannot build the
    configuration's index from blocks (a one-page build is tried)."""
    cfg = ctx.config
    Engine = closed_mesh.program_engine()
    probe = Engine(dtype=cfg["index_dtype"],
                   quantize_queries=bool(cfg["quantize_queries"]),
                   device=ctx.device)
    try:
        probe.build_blocks(_zeros, 1, normalize=False)
    except ValueError as e:
        raise RuntimeError(
            f"the program cannot build an index of dtype "
            f"{cfg['index_dtype']!r} from blocks ({e}), so this cell "
            f"cannot run") from e
    return Engine


def _bytes_read():
    """The program's count of index bytes its kernels covered so far, or
    None where the program does not count them."""
    from evdr_tpu_torch.ops import cuda_maxsim

    count = getattr(cuda_maxsim, "index_bytes_read", None)
    return None if count is None else int(count())


def reference_scores(ctx, Q, qmask, query_levels=None, page_levels=None):
    """The reference's (nq, N) scores over every page, block by block on
    the cell's device: the configuration's levels, or those given."""
    cfg = ctx.config

    def blocks():
        for b in range(gen.n_blocks(cfg)):
            yield gen.page_block(cfg, ctx.seed, b, ctx.device)

    return reference_int4q8.corpus_scores(
        blocks, Q, qmask,
        query_levels or reference_int4q8.QUERY_LEVELS,
        page_levels or serving.LEVELS[cfg["index_dtype"]])


# the controls: the reference at other levels in the program's place
CONTROLS = {"pages_at_3": {"page_levels": 3},
            "pages_at_127": {"page_levels": 127},
            "queries_at_7": {"query_levels": 7}}


def control(cell: dict, seed: int, device: str, kind: str) -> dict:
    """The compared numbers of the reference at a control's levels (its
    top-k over every page) against the reference at the configuration's,
    on ``check_queries`` queries of the seed."""
    ctx = harness.Context(cell, seed, 0.0, False, device=device)
    tr = cell["traffic"]
    k = int(tr["k"])
    Q, qmask = closed_mesh.make_queries(ctx, int(tr["check_queries"]),
                                        [torch.device(device)])
    ref = reference_scores(ctx, Q, qmask)
    low = reference_scores(ctx, Q, qmask, **CONTROLS[kind])
    vals, idx = torch.sort(low, dim=1, descending=True, stable=True)
    return check.topk_gaps(vals[:, :k].cpu(), idx[:, :k].cpu(), ref, k,
                           exact=True)


def run(ctx) -> Outcome:
    Engine = program_engine(ctx)
    cfg, tr = ctx.config, ctx.traffic
    batch, n_b, k = int(tr["batch"]), int(tr["pool_batches"]), int(tr["k"])
    # the index first, as a deployment loads it before any query: its
    # 68.9 GB then take the card's memory before the query pool's
    # transient blocks do
    eng = Engine(dtype=cfg["index_dtype"],
                 quantize_queries=bool(cfg["quantize_queries"]),
                 device=ctx.device)
    with ctx.span("bench.build"):
        eng.build_blocks(closed_mesh.BlockSource(cfg, ctx.seed, 1),
                         int(cfg["n_pages"]), normalize=False)
    ctx.free()
    ctx.mark("build")
    Q, qmask = closed_mesh.make_queries(ctx, batch * n_b,
                                        [torch.device(ctx.device)])
    ctx.free()
    ctx.mark("inputs")

    def search(b):
        s = slice(b * batch, (b + 1) * batch)
        return eng.search_dense(Q[s], qmask[s], k=k)

    for b in range(min(2, n_b)):
        search(b)
    ctx.setup_done()
    calls = []
    read0 = _bytes_read()
    with ctx.window() as w:
        i = 0
        while True:
            with ctx.span("bench.search_dense"):
                vals, idx = search(i % n_b)
            calls.append((i % n_b, vals, idx))
            i += 1
            if w.elapsed() >= ctx.seconds:
                break
    read = _bytes_read()
    peak = ctx.memory_peak()
    n = len(calls) * batch
    obs = {"window_s": w.seconds, "calls": len(calls), "queries": n}
    if read0 is not None and read is not None:
        obs["index_bytes_read"] = read - read0
    if ctx.trace and ctx.device != "cpu":
        obs.update(serving.layer_timings(ctx, eng, Q[:batch], qmask[:batch]))
    del eng
    ctx.free()
    t = time.perf_counter()
    pick = serving.sample(ctx, n, int(tr["check_queries"]))
    call, row = pick // batch, pick % batch
    vals, idx = serving.answers([(calls[c][1], calls[c][2], r)
                                 for c, r in zip(call, row)], k)
    qid = np.array([calls[c][0] * batch + r for c, r in zip(call, row)])
    uq, inv = np.unique(qid, return_inverse=True)
    sel = torch.as_tensor(uq, device=Q.device)
    ref = reference_scores(ctx, Q[sel], qmask[sel])
    ref = ref[torch.as_tensor(inv, device=ref.device)]
    numbers = check.topk_gaps(vals, idx, ref, k, exact=True)
    ctx.sync()
    obs["check_s"] = time.perf_counter() - t
    return Outcome(e2e={"search_qps": n / w.seconds}, attempted=n, failed=0,
                   numbers=numbers, memory_peak_bytes=peak, obs=obs)
