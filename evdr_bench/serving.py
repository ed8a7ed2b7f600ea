"""What the search drivers share: the corpus and the engine built over it,
and the check of sampled answers against the reference.

The pages are made on the device (``gen.py``), the engine quantizes and
indexes them through ``RetrievalEngine.build`` (``normalize=False``: the
pages are unit tokens already, masked tokens zero), and the float pages
are dropped; after the window the reference makes them again block by
block.
"""

from __future__ import annotations

import numpy as np
import torch

from evdr_bench import check, gen, reference

# a tier's integer levels (codes in [-levels, levels])
LEVELS = {"int8": 127, "int4": 7}


def make_inputs(ctx, n_queries: int):
    """The cell's corpus (P, pmask) and ``n_queries`` queries (Q, qmask),
    each from a page drawn from the seed."""
    cfg, dev = ctx.config, ctx.device
    with ctx.span("bench.make_pages"):
        P, pmask = gen.make_pages(cfg, ctx.seed, dev)
    g = gen.generator(ctx.seed, "queries", device=dev)
    targets = torch.randint(0, int(cfg["n_pages"]), (n_queries,),
                            generator=g, device=dev)
    Q, qmask = gen.make_queries(cfg, P, pmask, targets, g)
    ctx.mark("inputs")
    return P, pmask, Q, qmask


def build(ctx, n_queries: int):
    """(engine, Q, qmask): the engine over the cell's corpus, and
    ``n_queries`` queries, each from a page drawn from the seed."""
    from evdr_tpu_torch.engine import RetrievalEngine

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    P, pmask, Q, qmask = make_inputs(ctx, n_queries)
    eng = RetrievalEngine(dtype=cfg["index_dtype"],
                          quantize_queries=bool(cfg["quantize_queries"]),
                          prune_centroids=int(tr.get("prune_centroids", 0)),
                          summary_dtype=tr.get("summary_dtype"), device=dev)
    with ctx.span("bench.build"):
        eng.build(P, pmask, normalize=False)
    del P, pmask
    ctx.free()
    ctx.mark("build")
    return eng, Q, qmask


def blocks(ctx):
    """The corpus again, block by block, as the reference reads it."""
    cfg = ctx.config
    for b in range(gen.n_blocks(cfg)):
        yield gen.page_block(cfg, ctx.seed, b, ctx.device)


def reference_scores(ctx, Q, qmask, levels_of=None, tf32=False):
    """The reference's (nq, N) scores of queries (Q, qmask): the search the
    configuration states (quantized, or the f32 rerank of pruned search)
    at the configuration's precision, or at ``levels_of``'s."""
    cfg, tr = ctx.config, ctx.traffic
    levels = LEVELS[levels_of or cfg["index_dtype"]]
    kind = "rerank" if tr.get("n_candidates") else "quantized"
    return reference.corpus_scores(lambda: blocks(ctx), Q, qmask, kind,
                                   levels, tf32=tf32)


def sample(ctx, n_answers: int, want: int) -> np.ndarray:
    """``want`` of ``n_answers`` answers (or all), drawn from the seed."""
    rng = np.random.default_rng(gen.seed_for(ctx.seed, "check"))
    if n_answers <= want:
        return np.arange(n_answers)
    return np.sort(rng.choice(n_answers, size=want, replace=False))


def answers(rows, k: int):
    """(vals, idx) (S, k) of the answers ``(vals, idx, row)`` picked from
    calls; a missing or malformed answer reads NaN / -1 (infinite gaps)."""
    vals = np.full((len(rows), k), np.nan, np.float32)
    idx = np.full((len(rows), k), -1, np.int64)
    for j, (v, i, r) in enumerate(rows):
        v, i = np.asarray(v), np.asarray(i)
        if (v.ndim == 2 and i.shape == v.shape and r < v.shape[0]
                and v.shape[1] == k):
            vals[j], idx[j] = v[r], i[r]
    return vals, idx


def compare(ctx, vals, idx, qid, Q, qmask) -> dict:
    """The compared numbers of answers (vals, idx) (S, k) to pool queries
    ``qid`` (S,) against the reference."""
    uq, inv = np.unique(qid, return_inverse=True)
    sel = torch.as_tensor(uq, device=Q.device)
    ref = reference_scores(ctx, Q[sel], qmask[sel])
    ref = ref[torch.as_tensor(inv, device=ref.device)]
    exact = not ctx.traffic.get("n_candidates")
    return check.topk_gaps(vals, idx, ref, int(ctx.traffic["k"]), exact)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings of fn() (ms), after one
    call."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def layer_timings(ctx, eng, Q, qmask) -> dict:
    """CUDA-event times of the layers under ``search_dense`` on one batch
    (traced runs): the full-index MaxSim and its bound, or pruned search's
    two stages."""
    from evdr_bench import cost
    from evdr_tpu_torch.ops import pruned
    from evdr_tpu_torch.parallel.sharded_index import pad_queries
    from evdr_tpu_torch.parallel.topk import _select_topk, sharded_maxsim

    ix, tr = eng.index, ctx.traffic
    Qd = pad_queries(Q, ix)
    out = {}
    nc = tr.get("n_candidates")
    if not nc:
        out["maxsim_ms"] = cuda_ms(
            lambda: sharded_maxsim(Qd, qmask, ix, impl=eng.impl))
        out["maxsim_bound_ms"], out["maxsim_bound_by"] = cost.maxsim_bound_ms(
            Q, qmask, ix.P[:ix.n_docs], ix.pmask[:ix.n_docs],
            None if ix.scales is None else ix.scales[:ix.n_docs],
            ctx.config["peak"])
        return out
    sx = eng.summary
    Qs = pad_queries(Q, sx)

    def stage1():
        sc = pruned.candidate_scores(Qs, qmask, sx.P, sx.pmask, eng.impl,
                                     sx.scales)
        return _select_topk(sc, min(int(nc), ix.n_docs))[1]

    cand = stage1()
    chunk = pruned.rerank_chunk_q(int(nc), ix.pmask.shape[-1], Qd.shape[-1])
    out["pruned_stage1_ms"] = cuda_ms(stage1)
    out["pruned_stage2_ms"] = cuda_ms(lambda: pruned.rerank_candidates(
        Qd, qmask, ix.P, ix.pmask, cand, k=int(tr["k"]), scales=ix.scales,
        chunk_q=chunk, pq_decode="take"))
    return out
