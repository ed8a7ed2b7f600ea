"""A closed loop of query batches through ``RetrievalEngine.search_dense``
over a doc mesh of several cards, in one process: an index that no card
holds.

Traffic keys as ``closed.py``: ``batch`` queries a call, ``k``,
``pool_batches`` distinct batches made at set-up and cycled,
``check_queries`` answers compared after the window. The configuration's
``doc_shards`` cards (``make_mesh``; on the CPU, as many CPU devices
``cpu:0``, ``cpu:1``, ...) each hold one shard of the index.

No process ever holds the float corpus:
- the engine builds from blocks (``RetrievalEngine.build_blocks``): each
  shard's rows are made on its own card from the generator's blocks
  (``gen.page_block``), which need not align with the shards' ranges;
- the query pool's target pages are made again from their own blocks only,
  spread over the cards, and ``gen.make_queries`` draws from them;
- the reference scores each card's contiguous range of the generator's
  blocks on that card (``reference.corpus_scores``), and the columns join
  on the first card.

Every card is synchronized before set-up ends and before the window
closes, and every card's peak memory starts again when set-up ends;
``memory_peak_bytes`` is the fullest card's window peak. ``search_qps``:
the queries of every call in the window over the window.

Traced runs also time, after the window and on one batch: each shard's
scores and local top-k alone on its card (CUDA events), one whole
``sharded_topk`` call with every card synchronized (host clock), and the
merge of one call's shard outputs on the first card (CUDA events); the
program's count of bytes moved between cards is read over the window.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from evdr_bench import check, gen, reference, serving
from evdr_bench.harness import Outcome

# generator blocks a card's source keeps: an engine block straddles two
KEEP_BLOCKS = 3
TIMING_REPS = 5


def program_engine():
    """The program's engine class; fails at once where it cannot build an
    index that no card holds (no block build)."""
    from evdr_tpu_torch.engine import RetrievalEngine

    if not hasattr(RetrievalEngine, "build_blocks"):
        raise RuntimeError(
            "the program has no RetrievalEngine.build_blocks: it cannot "
            "build an index that no card holds, so this cell cannot run")
    return RetrievalEngine


def make_mesh(ctx):
    """The cell's doc mesh: ``doc_shards`` distinct cards, or CPU
    devices on the CPU."""
    from evdr_tpu_torch.parallel import mesh

    n = int(ctx.config["doc_shards"])
    if ctx.device == "cpu":
        return mesh.mesh_of([f"cpu:{i}" for i in range(n)])
    return mesh.make_mesh(n)


def _cards(devs):
    return [d for d in devs if d.type == "cuda"]


def sync_all(devs) -> None:
    for d in _cards(devs):
        torch.cuda.synchronize(d)


def peaks(devs) -> list:
    """Each card's peak allocated bytes since its last reset."""
    return [int(torch.cuda.max_memory_allocated(d)) for d in _cards(devs)]


def reset_peaks(devs) -> None:
    for d in _cards(devs):
        torch.cuda.reset_peak_memory_stats(d)


class BlockSource:
    """``source(lo, hi, device)`` for ``build_blocks``: rows [lo, hi) of
    the corpus made on ``device`` from the generator's blocks, the last
    few blocks a device kept."""

    def __init__(self, cfg: dict, seed: int, n_devices: int):
        self.cfg, self.seed = cfg, int(seed)
        self.keep = KEEP_BLOCKS * max(1, n_devices)
        self.kept = OrderedDict()

    def block(self, b: int, device):
        key = (str(device), b)
        if key in self.kept:
            self.kept.move_to_end(key)
        else:
            self.kept[key] = gen.page_block(self.cfg, self.seed, b, device)
            while len(self.kept) > self.keep:
                self.kept.popitem(last=False)
        return self.kept[key]

    def __call__(self, lo: int, hi: int, device):
        B = gen.BLOCK_PAGES
        parts = [self.block(b, device) for b in range(lo // B,
                                                      (hi - 1) // B + 1)]
        s = lo - (lo // B) * B
        if len(parts) == 1:
            P, m = parts[0]
        else:
            P = torch.cat([p for p, _ in parts])
            m = torch.cat([x for _, x in parts])
        return P[s:s + hi - lo], m[s:s + hi - lo]


def target_pages(ctx, targets: torch.Tensor, devs):
    """(P, pmask) of the pages ``targets`` on the first device, each made
    again from its own generator block, the blocks spread over the
    devices. The row indices go to the devices before any block is made,
    so no host sync waits on a block."""
    cfg = ctx.config
    B = gen.BLOCK_PAGES
    dst = devs[0]
    t = targets.cpu().numpy()
    blocks = np.unique(t // B)
    lp, d = int(cfg["page_tokens"]), int(cfg["dim"])
    P = torch.empty((len(t), lp, d), dtype=torch.float32, device=dst)
    pmask = torch.empty((len(t), lp), dtype=torch.bool, device=dst)
    plan = []
    for j, b in enumerate(blocks):
        rows = np.nonzero(t // B == b)[0]
        dev = devs[j % len(devs)]
        plan.append((int(b), dev,
                     torch.as_tensor(t[rows] - b * B, device=dev),
                     torch.as_tensor(rows, device=dst)))
    for b, dev, local, at in plan:
        Pb, mb = gen.page_block(cfg, ctx.seed, b, dev)
        P.index_copy_(0, at, Pb[local].to(dst))
        pmask.index_copy_(0, at, mb[local].to(dst))
        del Pb, mb
    return P, pmask


def make_queries(ctx, n_queries: int, devs):
    """``n_queries`` queries (Q, qmask) on the first device, each from a
    page drawn from the seed, as ``serving.make_inputs`` draws them from
    the whole corpus."""
    cfg, dst = ctx.config, devs[0]
    g = gen.generator(ctx.seed, "queries", device=dst)
    targets = torch.randint(0, int(cfg["n_pages"]), (n_queries,),
                            generator=g, device=dst)
    with ctx.span("bench.target_pages"):
        Pt, pmt = target_pages(ctx, targets, devs)
    Q, qmask = gen.make_queries(
        cfg, Pt, pmt, torch.arange(n_queries, device=dst), g)
    del Pt, pmt
    return Q, qmask


def reference_scores(ctx, Q, qmask, devs, levels_of=None):
    """The reference's (nq, N) quantized scores on the first device: each
    device scores a contiguous range of the generator's blocks, made
    there (the cards at once, one thread a card; no device gets an empty
    range)."""
    cfg = ctx.config
    levels = serving.LEVELS[levels_of or cfg["index_dtype"]]
    nb = gen.n_blocks(cfg)
    nd = min(nb, len(devs))

    def one(j):
        dev = devs[j]
        lo, hi = j * nb // nd, (j + 1) * nb // nd

        def blocks():
            for b in range(lo, hi):
                yield gen.page_block(cfg, ctx.seed, b, dev)

        return reference.corpus_scores(blocks, Q.to(dev), qmask.to(dev),
                                       "quantized", levels)

    if len(_cards(devs)) > 1:
        with ThreadPoolExecutor(max_workers=nd) as pool:
            parts = list(pool.map(one, range(nd)))
    else:
        parts = [one(j) for j in range(nd)]
    return torch.cat([p.to(devs[0]) for p in parts], dim=1)


def _event_ms(fn, dev, reps: int = TIMING_REPS) -> float:
    """Median CUDA-event ms of fn() on ``dev``'s current stream."""
    ts = []
    with torch.cuda.device(dev):
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def mesh_timings(eng, Q, qmask, k: int, devs) -> dict:
    """The mesh's layers on one batch (traced runs): the slowest shard's
    scores and local top-k, each shard alone on its card; one whole
    ``sharded_topk`` call, every card synchronized; the merge of one
    call's shard outputs on the first card."""
    from evdr_tpu_torch.parallel import topk
    from evdr_tpu_torch.parallel.sharded_index import pad_queries

    ix = eng.index
    Qd = pad_queries(Q, ix)
    shards = topk.shard_queries(Qd, qmask, ix.mesh)
    sync_all(devs)
    alone = [_event_ms(lambda i=i, q=q, m=m: topk.shard_topk(
        q, m, ix, i, k, eng.impl), ix.mesh.devices[i])
        for i, (q, m) in enumerate(shards)]

    def whole():
        sync_all(devs)
        t = time.perf_counter()
        topk.sharded_topk(Qd, qmask, ix, k, eng.impl)
        sync_all(devs)
        return (time.perf_counter() - t) * 1e3

    call_ms = float(np.median([whole() for _ in range(TIMING_REPS)]))
    outs = [topk.shard_topk(q, m, ix, i, k, eng.impl)
            for i, (q, m) in enumerate(shards)]
    sync_all(devs)
    merge_ms = _event_ms(lambda: topk.merge_shard_topk(
        [o[0] for o in outs], [o[1] for o in outs], ix.mesh, k,
        int(Q.shape[0])), devs[0])
    return {"mesh_shard_ms": max(alone), "mesh_call_ms": call_ms,
            "mesh_merge_ms": merge_ms}


def _moved():
    """The program's bytes moved between devices so far, or None where
    the program does not count them."""
    from evdr_tpu_torch.parallel import mesh

    count = getattr(mesh, "transfer_bytes", None)
    return None if count is None else int(count())


def run(ctx) -> Outcome:
    Engine = program_engine()
    cfg, tr = ctx.config, ctx.traffic
    batch, n_b, k = int(tr["batch"]), int(tr["pool_batches"]), int(tr["k"])
    mesh = make_mesh(ctx)
    devs = list(mesh.devices)
    Q, qmask = make_queries(ctx, batch * n_b, devs)
    ctx.mark("inputs")
    eng = Engine(dtype=cfg["index_dtype"],
                 quantize_queries=bool(cfg["quantize_queries"]), mesh=mesh)
    with ctx.span("bench.build"):
        eng.build_blocks(BlockSource(cfg, ctx.seed, len(devs)),
                         int(cfg["n_pages"]), normalize=False)
    sync_all(devs)
    ctx.free()
    ctx.mark("build")

    def search(b):
        s = slice(b * batch, (b + 1) * batch)
        return eng.search_dense(Q[s], qmask[s], k=k)

    for b in range(min(2, n_b)):
        search(b)
    sync_all(devs)
    setup_peaks = peaks(devs)
    ctx.setup_done()
    ctx.setup_peak_bytes = max(setup_peaks, default=0)
    reset_peaks(devs)
    calls = []
    moved0 = _moved()
    with ctx.window() as w:
        i = 0
        while True:
            with ctx.span("bench.search_dense"):
                vals, idx = search(i % n_b)
            calls.append((i % n_b, vals, idx))
            i += 1
            if w.elapsed() >= ctx.seconds:
                break
        sync_all(devs)
    moved = _moved()
    window_peaks = peaks(devs)
    n = len(calls) * batch
    obs = {"window_s": w.seconds, "calls": len(calls), "queries": n}
    if moved0 is not None and moved is not None:
        obs["mesh_gather_bytes"] = moved - moved0
    for i, (a, b) in enumerate(zip(setup_peaks, window_peaks)):
        obs[f"setup_peak_bytes.card{i}"] = a
        obs[f"memory_peak_bytes.card{i}"] = b
    if ctx.trace and ctx.device != "cpu":
        obs.update(mesh_timings(eng, Q[:batch], qmask[:batch], k, devs))
    del eng
    ctx.free()
    pick = serving.sample(ctx, n, int(tr["check_queries"]))
    call, row = pick // batch, pick % batch
    vals, idx = serving.answers([(calls[c][1], calls[c][2], r)
                                 for c, r in zip(call, row)], k)
    qid = np.array([calls[c][0] * batch + r for c, r in zip(call, row)])
    uq, inv = np.unique(qid, return_inverse=True)
    sel = torch.as_tensor(uq, device=Q.device)
    ref = reference_scores(ctx, Q[sel], qmask[sel], devs)
    ref = ref[torch.as_tensor(inv, device=ref.device)]
    numbers = check.topk_gaps(vals, idx, ref, k, exact=True)
    return Outcome(e2e={"search_qps": n / w.seconds}, attempted=n, failed=0,
                   numbers=numbers,
                   memory_peak_bytes=max(window_peaks, default=0), obs=obs)
