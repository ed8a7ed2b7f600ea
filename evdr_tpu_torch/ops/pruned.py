"""Two-stage pruned MaxSim retrieval (PLAID-style candidate generation).

Counterpart of ``evdr_tpu/ops/pruned.py``:

1. BUILD: each page's tokens are summarized by ``k_centroids`` per-page
   k-means centres (``ops/batched_kmeans.py``, on the device),
   L2-normalized, giving a summary index ~Lp / k_centroids times cheaper to
   score.
2. STAGE 1: fused MaxSim over the summary index (the port's kernels K1, K2
   or K4 at Lp = k_centroids, through ``parallel/topk._local_scores``) ->
   the top ``n_candidates`` pages per query.
3. STAGE 2: gather the candidates' full token sets and rerank them with
   exact masked MaxSim in f32 (a gather plus an einsum, as in the
   reference, which runs no Pallas kernel there).

Stage 1 selects exactly (``_select_topk``), where the reference takes
``lax.approx_max_k`` above 128 candidates. Stage 2 keeps the reference's
numerics: -1e4 for an invalid token, a candidate with no valid token at
-inf (it ranks last; exact top-k scores such a real doc 0), int8/int4
scales applied after the gather, PQ candidates decoded in f32 by a one-hot
product or by a gather of book rows (bit-identical in f32), and f32
products with TF32 off. Recall against exact search: :func:`pruned_recall`.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Tuple

import numpy as np
import torch

from evdr_tpu_torch.ops.batched_kmeans import batched_kmeans
from evdr_tpu_torch.ops.cuda_maxsim import unpack_int4_torch
from evdr_tpu_torch.ops.maxsim import NEG_FILL
from evdr_tpu_torch.parallel.topk import _local_scores, _select_topk


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def build_summary_tokens(P, pmask, k_centroids: int = 4, iters: int = 5,
                         seed: int = 0, chunk_pages: int = 16384,
                         device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-page k-means summaries: (N, Lp, D) -> (N, k, D) f32 + occupancy
    mask, tensors on ``device`` (default: ``P``'s; the CPU for a numpy
    array). A page with fewer valid tokens than k gets zero centres
    (masked out). Summaries are scored like tokens: L2-normalized."""
    S, smask = batched_kmeans(P, pmask, k=k_centroids, iters=iters,
                              seed=seed, chunk_pages=chunk_pages,
                              device=device)
    norms = torch.linalg.vector_norm(S, dim=-1, keepdim=True)
    S = torch.where(norms > 0, S / norms.clamp_min(1e-12), 0.0)
    return S, smask


def build_summary_tokens_from_pq(codes, books, pmask, k_centroids: int = 4,
                                 iters: int = 5, seed: int = 0,
                                 chunk_pages: int = 16384,
                                 expanded: bool = False, device=None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Summaries of a PQ-only index without its whole reconstruction:
    ``chunk_pages`` pages of codes at a time decoded on the host
    (``ops/pq.decode_pq``) and summarized (pages are independent, so the
    chunking is exact), chunk ``s`` seeded with ``seed + s``."""
    from evdr_tpu_torch.ops.pq import decode_pq

    books = _host(books)
    n = int(codes.shape[0])
    outs, masks = [], []
    for s in range(0, n, chunk_pages):
        e = min(s + chunk_pages, n)
        rec = decode_pq(_host(codes[s:e]), books, expanded=expanded)
        S, sm = build_summary_tokens(rec, _host(pmask[s:e]),
                                     k_centroids=k_centroids, iters=iters,
                                     seed=seed + s, chunk_pages=chunk_pages,
                                     device=device)
        outs.append(S)
        masks.append(sm)
    return torch.cat(outs), torch.cat(masks)


@contextlib.contextmanager
def _f32_products():
    """f32 matmuls at full precision (no TF32) inside the block."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _decode_pq(codes, books, d: int, pq_decode: str) -> torch.Tensor:
    """(..., M) uint8 codes -> (..., D') f32 tokens: compact (M, K, D/M)
    books concatenate their rows, expanded (M, K, D) OPQ books sum them.
    'onehot' resolves each code as a one-hot row times the book (the
    reference's TPU form), 'take' gathers the row; in f32 both are exact."""
    m, kk, _ = books.shape
    books = books.float()
    lead = codes.shape[:-1]
    if pq_decode == "onehot":
        codes2 = codes.reshape(-1, m).long()
        iota = torch.arange(kk, device=codes.device)
        rec = [(iota[None, :] == codes2[:, j:j + 1]).float() @ books[j]
               for j in range(m)]
    elif pq_decode == "take":
        if not (m > 1 and books.shape[-1] == d):
            # compact rows concatenate: one gather of all M rows a token
            flat = books.reshape(m * kk, -1)
            at = codes.long() + torch.arange(m, device=codes.device) * kk
            return flat.index_select(0, at.reshape(-1)).reshape(*lead, -1)
        rec = [books[j][codes[..., j].long()] for j in range(m)]
    else:
        raise ValueError(f"pq_decode must be 'onehot' or 'take', got "
                         f"{pq_decode!r}")
    if m > 1 and books.shape[-1] == d:
        full = functools.reduce(torch.add, rec)
    else:
        full = torch.cat(rec, dim=-1)
    return full.reshape(*lead, -1)


def _rerank_block(Q, qmask, P, pmask, cand_idx, k: int, scales=None,
                  books=None, pq_decode: str = "onehot"):
    """One query block of the exact candidate rerank (see
    :func:`rerank_candidates`)."""
    scores = _rerank_scores(Q, qmask, P, pmask, cand_idx, scales, books,
                            pq_decode)
    vals, pos = _select_topk(scores, min(k, scores.shape[-1]))
    return vals, torch.gather(cand_idx, 1, pos)


def _rerank_scores(Q, qmask, P, pmask, cand_idx, scales=None, books=None,
                   pq_decode: str = "onehot"):
    """(nq, C) exact f32 MaxSim of each query's candidates (rows
    ``cand_idx`` of ``P``); a candidate with no valid token at -inf."""
    Pg = P[cand_idx]                          # (nq, C, Lp, D) or PQ codes
    if books is not None:
        Pg = _decode_pq(Pg, books, Q.shape[-1], pq_decode)
    elif Pg.dtype == torch.uint8:
        # packed int4 (ops/int4.py): unpack only the gathered candidates
        Pg = unpack_int4_torch(Pg, pmask.shape[-1])
    if scales is not None:
        Pg = Pg.float().mul_(scales[cand_idx][..., None])
    pmg = pmask[cand_idx]                     # (nq, C, Lp)
    sim = torch.einsum("qnd,qcmd->qcnm", Q.float(), Pg.float())
    sim = sim.masked_fill(~pmg[:, :, None, :], NEG_FILL)
    mx = sim.amax(dim=-1)
    any_valid = pmg.any(dim=-1)               # (nq, C)
    mx = mx * any_valid[:, :, None].float()
    mx = mx * qmask.float()[:, None, :]
    scores = mx.sum(dim=-1)                   # (nq, C)
    # candidates with no valid token (index padding, empty docs) rank last
    return torch.where(any_valid, scores, -torch.inf)


def rerank_candidates(Q, qmask, P, pmask, cand_idx, k: int, scales=None,
                      chunk_q: int = 32, books=None,
                      pq_decode: str = "onehot"):
    """Exact masked MaxSim over per-query candidate sets.

    Q (nq, Lq, D); P (N, Lp, D) (int8 codes with ``scales``, packed int4
    uint8 with ``scales``, or PQ codes with ``books``); cand_idx (nq, C) ->
    top-k (values, GLOBAL doc indices) among the candidates, in blocks of
    ``chunk_q`` queries (the gathered candidates are f32 for the einsum)."""
    with _f32_products():
        blocks = [_rerank_block(Q[s:s + chunk_q], qmask[s:s + chunk_q], P,
                                pmask, cand_idx[s:s + chunk_q], k, scales,
                                books, pq_decode)
                  for s in range(0, Q.shape[0], chunk_q)]
    if len(blocks) == 1:
        return blocks[0]
    return (torch.cat([v for v, _ in blocks]),
            torch.cat([i for _, i in blocks]))


def candidate_scores(Q, qmask, S, smask, impl: str, sscales=None):
    """Stage 1: (nq, N_pad) scores of the queries against the summary index
    through the serving kernels, summary-invalid docs at -inf."""
    sc = _local_scores(Q, qmask, S, smask, impl, sscales)
    return torch.where(smask.any(dim=-1)[None, :], sc, -torch.inf)


def rerank_chunk_q(n_cand: int, lp: int, d: int, books=None,
                   pq_decode: str = "onehot") -> int:
    """The rerank's query block: the decoded candidates of a block,
    (chunk_q, n_cand, Lp, D) f32, held near 512 MB (the onehot decode's
    (rows, K) planes add K * 8 bytes a row), at most 32 queries."""
    row_bytes = lp * d * 4
    if pq_decode == "onehot" and books is not None:
        row_bytes += lp * books.shape[1] * 8
    return max(1, min(32, 512 * 1024 ** 2 // max(1, n_cand * row_bytes)))


def pruned_topk_fused(Q, qmask, P, pmask, S, smask, k: int, n_cand: int,
                      impl: str = "cuda", scales=None, sscales=None,
                      books=None, pq_decode: str = "onehot", Qs=None):
    """Both pruning stages, single device: stage 1 on the summary index
    (``S``, ``smask``, ``sscales`` for int8/int4 summaries) picks the top
    ``n_cand`` docs per query, stage 2 reranks them exactly over the full
    index (``P``, ``pmask``, ``scales`` / ``books``). ``Qs``: the queries
    at the summary's stored width, where it differs from the index's (a PQ
    index pads its queries per subspace); default ``Q``."""
    sc = candidate_scores(Q if Qs is None else Qs, qmask, S, smask, impl,
                          sscales)
    _, cand = _select_topk(sc, n_cand)
    chunk_q = rerank_chunk_q(n_cand, pmask.shape[-1], Q.shape[-1], books,
                             pq_decode)
    return rerank_candidates(Q, qmask, P, pmask, cand, k=k, scales=scales,
                             chunk_q=chunk_q, books=books,
                             pq_decode=pq_decode)


def pruned_recall(exact_idx, pruned_idx) -> float:
    """Fraction of exact top-k docs recovered by the pruned search."""
    hits, total = 0, 0
    for e, p in zip(_host(exact_idx), _host(pruned_idx)):
        hits += len(set(e.tolist()) & set(p.tolist()))
        total += len(e)
    return hits / max(total, 1)
