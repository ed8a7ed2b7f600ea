"""The plain reference of an int4 index searched by int8 queries (the
int4full mode): queries quantized per token at +-127, pages at +-7.

``reference.quantized_scores`` quantizes queries and pages at one number of
levels; this scores them at two. It imports nothing of the program and
takes nothing the program made: from the float pages and queries it works
out again the codes and scales (``reference.quantize``: ``amax / levels``,
round half to even, clipped), then, by definition, a similarity is (query
codes . page codes) times the page token's scale, an invalid page token
never wins the max, a page with no valid token scores 0, and each query
token's max is weighted by its mask times its scale. Products run in
float32 with TF32 off (``reference.precision``); codes of at most 8 bits
make them exact at D = 128.

The controls of a cell change the levels: pages at +-3 or +-127, queries
at +-7.
"""

from __future__ import annotations

from typing import Callable, Iterator

import torch

from evdr_bench.reference import (NEG_TOKEN, _pages_a_block, precision,
                                  quantize)

QUERY_LEVELS = 127
PAGE_LEVELS = 7


def scores(Q, qmask, P, pmask, query_levels: int = QUERY_LEVELS,
           page_levels: int = PAGE_LEVELS) -> torch.Tensor:
    """(nq, n) scores of queries quantized at ``query_levels`` against
    pages quantized at ``page_levels``."""
    nq, lq, d = Q.shape
    n, lp, _ = P.shape
    qc, qs = quantize(Q, query_levels)
    qw = qmask.float() * qs
    rows = qc.reshape(nq * lq, d)
    out = torch.empty((nq, n), dtype=torch.float32, device=Q.device)
    step = _pages_a_block(nq * lq, lp)
    for s in range(0, n, step):
        pc, ps = quantize(P[s:s + step], page_levels)
        c = pc.shape[0]
        sim = (rows @ pc.reshape(c * lp, d).T).view(nq * lq, c, lp)
        sim.mul_(ps[None])
        sim.masked_fill_(~pmask[s:s + step][None], NEG_TOKEN)
        mx = sim.amax(dim=-1)
        del sim
        mx = torch.where(mx > NEG_TOKEN / 10, mx, 0.0)
        out[:, s:s + c] = (mx.view(nq, lq, c) * qw[..., None]).sum(dim=1)
    return out


def corpus_scores(blocks: Callable[[], Iterator], Q, qmask,
                  query_levels: int = QUERY_LEVELS,
                  page_levels: int = PAGE_LEVELS) -> torch.Tensor:
    """(nq, N) scores over a corpus given as an iterator of (pages, mask)
    blocks, made again block by block."""
    parts = []
    with precision(False), torch.no_grad():
        for Pb, mb in blocks():
            parts.append(scores(Q, qmask, Pb, mb, query_levels,
                                page_levels))
            del Pb, mb
    return torch.cat(parts, dim=1)
