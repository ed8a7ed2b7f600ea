"""MaxSim scoring and top-k retrieval over a device or a doc mesh.

Counterpart of ``evdr_tpu/parallel/topk.py``. On one device (a mesh of
one, the same code path as before meshes existed):
``_local_scores`` routes a PQ index (codes + books) to K3, a packed int4
index (uint8 codes + scales) to K4, an int8 index to K2 and a float index
to K1, in the reference's order; '*_q8' engines take each kernel's 'full'
mode (queries quantized to int8 on the device). ``_single_device_topk``
masks padding columns and selects top-k;
``_single_device_merged_topk`` does the same over a main index and an
incremental tail, with deleted docs masked by a device-side alive mask.
The wrappers run their plain versions when the index lies on the CPU.

On a mesh of several shards (``parallel/mesh.py``) the queries are first
copied to every shard's device, then each shard (``shard_topk``) scores
its own rows through the same ``_local_scores`` on its device, masks the
columns past ``n_docs`` (padding, never an empty doc: that one keeps its
exact 0), takes a local top-``min(k, shard)`` and adds its row offset,
with no host sync, so the devices work at once; the candidates of every
shard come to the first device (or are all-gathered across processes)
and one stable sort merges them (``merge_shard_topk``), so ties go to
the lower global index, as ``lax.top_k`` orders the reference's gathered
candidates. On a ``dp x docs`` mesh each dp group takes its
slice of the queries. ``sharded_rerank`` is stage 2 of pruned search on
a mesh: each shard reranks the candidates it owns.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from evdr_tpu_torch.ops.cuda_maxsim import (maxsim_cuda, maxsim_cuda_int4,
                                            maxsim_cuda_int4full,
                                            maxsim_cuda_int8,
                                            maxsim_cuda_int8full,
                                            maxsim_cuda_pq,
                                            maxsim_cuda_pqfull)
from evdr_tpu_torch.parallel.mesh import (count_transfer, gather_blocks,
                                          same_device)
from evdr_tpu_torch.parallel.sharded_index import ShardedIndex
from evdr_tpu_torch.utils.timing import span


def _local_scores(Q, qmask, P, pmask, impl: str, scales=None, books=None):
    q8 = impl.endswith("_q8")
    with span("evdr.topk.score"):
        if books is not None:
            # product-quantized index: P holds (N, Lp, M) uint8 codes, books
            # the compact (M, K, D/M) or expanded OPQ (M, K, D) codebooks
            # (ops/pq.py)
            kernel = maxsim_cuda_pqfull if q8 else maxsim_cuda_pq
            return kernel(Q, P, qmask, pmask, books)
        if scales is not None and P.dtype == torch.uint8:
            # packed-int4 index (ops/int4.py): token-pair uint8 codes +
            # scales
            kernel = maxsim_cuda_int4full if q8 else maxsim_cuda_int4
            return kernel(Q, P, scales, qmask, pmask)
        if scales is not None:
            # int8-quantized index (ops/quantize.py)
            kernel = maxsim_cuda_int8full if q8 else maxsim_cuda_int8
            return kernel(Q, P, scales, qmask, pmask)
        return maxsim_cuda(Q, P, qmask, pmask)


def _select_topk(sc: torch.Tensor, k: int):
    """Exact top-k in ``lax.top_k``'s order: descending, and among equal
    scores the lower column first. A stable descending sort gives exactly
    that; ``torch.topk`` leaves the order of ties unspecified."""
    with span("evdr.topk.select"):
        vals, idx = torch.sort(sc, dim=1, descending=True, stable=True)
        return vals[:, :k], idx[:, :k]


def _single_device_topk(Q, qmask, P, pmask, k: int, impl: str, scales=None,
                        n_docs=None, books=None):
    sc = _local_scores(Q, qmask, P, pmask, impl, scales, books)
    # exclude only PADDING columns (index >= n_docs). A REAL doc with zero
    # valid tokens scores exactly 0 under MaxSim semantics and stays rankable.
    nd = int(pmask.shape[0])
    limit = nd if n_docs is None else int(n_docs)
    if limit < nd:
        sc[:, limit:] = -torch.inf
    return _select_topk(sc, k)


def _single_device_merged_topk(Q, qmask, P_m, pm_m, P_t, pm_t, alive, k: int,
                               impl: str, n_main: int, n_tail: int,
                               scales_m=None, scales_t=None, books=None):
    """Incremental-serving top-k: score the main index and the tail index
    (``P_t`` None: no tail), drop their padding columns, set every column
    whose ``alive`` entry (a (n_main + n_tail) bool tensor on the device)
    is False to -inf, and select top-k over the concatenation. The stable
    sort keeps ``lax.top_k``'s order, so among equal scores a main doc
    comes before a tail doc. ``books`` (a PQ index) serve both parts: the
    tail is encoded against the main index's books."""
    parts = [_local_scores(Q, qmask, P_m, pm_m, impl, scales_m,
                           books)[:, :n_main]]
    if P_t is not None:
        parts.append(_local_scores(Q, qmask, P_t, pm_t, impl, scales_t,
                                   books)[:, :n_tail])
    sc = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    sc = sc.masked_fill(~alive[None, :], -torch.inf)
    return _select_topk(sc, min(k, n_main + n_tail))


def _row_queries(Q, qmask, mesh):
    """The queries of each dp group: (rows a group, [(Q, qmask) per
    group]). A batch that does not split evenly is padded with masked
    rows (they score 0; the callers cut them off)."""
    nq, dp = int(Q.shape[0]), mesh.dp
    per = -(-nq // dp)
    if per * dp != nq:
        Q = torch.cat([Q, Q.new_zeros((per * dp - nq,) + Q.shape[1:])])
        qmask = torch.cat([qmask, qmask.new_zeros(
            (per * dp - nq,) + qmask.shape[1:])])
    return per, [(Q[r * per:(r + 1) * per], qmask[r * per:(r + 1) * per])
                 for r in range(dp)]


def _on(cache, key, dev, x):
    """``x`` on ``dev``, copied once per (key, device); a copy to another
    device runs in the span ``evdr.mesh.gather`` and its bytes count as
    ``queries`` (what a search sends out to the shards)."""
    if (key, dev) not in cache:
        if same_device(x.device, dev):
            cache[key, dev] = x.to(dev)
        else:
            with span("evdr.mesh.gather"):
                count_transfer("queries", x, x.device, dev)
                cache[key, dev] = x.to(dev)
    return cache[key, dev]


def shard_queries(Q, qmask, mesh, cache=None):
    """Each local shard's (Q, qmask) on its device, in
    ``mesh.local_shards()`` order. Every copy is issued before any shard's
    work: a copy between devices runs on its source device's stream, so a
    copy issued after a shard's kernels there would wait for them and
    serialize the shards."""
    _, groups = _row_queries(Q, qmask, mesh)
    cache = {} if cache is None else cache
    return [(_on(cache, ("q", r), dev, groups[r][0]),
             _on(cache, ("m", r), dev, groups[r][1]))
            for r, _, dev in mesh.local_shards()]


def _masked_scores(Q, qmask, part: ShardedIndex, col: int, rows: int,
                   n_docs: int, impl: str):
    """Doc shard ``col``'s (queries, rows) scores, the columns past
    ``n_docs`` at -inf."""
    sc = _local_scores(Q, qmask, part.P, part.pmask, impl, part.scales,
                       part.books)
    limit = n_docs - col * rows
    if limit < rows:
        sc[:, max(limit, 0):] = -torch.inf
    return sc


def _shard_scores(Q, qmask, index: ShardedIndex, impl: str):
    """Each local shard's doc column and its (rows a group, shard_rows)
    scores, the columns past ``n_docs`` at -inf."""
    mesh, rows = index.mesh, index.shard_rows
    return [(c, _masked_scores(Qr, qmr, part, c, rows, index.n_docs, impl))
            for part, (Qr, qmr), (_, c, _) in zip(
                index.parts, shard_queries(Q, qmask, mesh),
                mesh.local_shards())]


def _by_group(blocks: List[torch.Tensor], mesh, dim: int):
    """Global shard blocks -> one tensor per dp group, its doc shards'
    blocks concatenated along ``dim`` in column order."""
    d = mesh.n_doc_shards
    return [torch.cat(blocks[r * d:(r + 1) * d], dim=dim)
            for r in range(mesh.dp)]


def shard_topk(Q, qmask, index: ShardedIndex, i: int, k: int, impl: str,
               drop_empty: bool = False):
    """Local shard ``i``'s work of a mesh search (span
    ``evdr.mesh.shard``): its scores of queries (Q, qmask) already on its
    device, and their top-``min(k, shard_rows)`` as (values, global doc
    ids). ``drop_empty`` also drops docs with no valid token (pruned
    search's stage 1: such a summary is no candidate)."""
    part, rows = index.parts[i], index.shard_rows
    c = index.mesh.local_shards()[i][1]
    with span("evdr.mesh.shard"):
        sc = _masked_scores(Q, qmask, part, c, rows, index.n_docs, impl)
        if drop_empty:
            sc = torch.where(part.pmask.any(dim=-1)[None, :], sc,
                             -torch.inf)
        v, idx = _select_topk(sc, min(k, rows))
        return v, idx + c * rows


def merge_shard_topk(vals, gidx, mesh, k: int, nq: int):
    """The mesh's top-k from every local shard's (values, global ids) of
    :func:`shard_topk` (span ``evdr.mesh.merge``): the candidates come to
    the first device (or are all-gathered across processes) and one
    stable sort a dp group merges them, so ties go to the lower global
    index, as ``lax.top_k`` orders the reference's gathered candidates."""
    with span("evdr.mesh.merge"):
        dst = mesh.devices[0]
        vals = _by_group(gather_blocks(vals, mesh, dst, "candidates"),
                         mesh, 1)
        gidx = _by_group(gather_blocks(gidx, mesh, dst, "candidates"),
                         mesh, 1)
        out_v, out_i = [], []
        for v, g in zip(vals, gidx):
            mv, pos = _select_topk(v, min(k, v.shape[1]))
            out_v.append(mv)
            out_i.append(torch.gather(g, 1, pos))
        return torch.cat(out_v)[:nq], torch.cat(out_i)[:nq]


def _mesh_topk(Q, qmask, index: ShardedIndex, k: int, impl: str,
               drop_empty: bool = False):
    """sharded_topk on a mesh; ``drop_empty`` also drops docs with no
    valid token (pruned search's stage 1)."""
    vals, gidx = [], []
    for i, (Qr, qmr) in enumerate(shard_queries(Q, qmask, index.mesh)):
        v, g = shard_topk(Qr, qmr, index, i, k, impl, drop_empty)
        vals.append(v)
        gidx.append(g)
    return merge_shard_topk(vals, gidx, index.mesh, k, int(Q.shape[0]))


def sharded_rerank(Q, qmask, index: ShardedIndex, cand: torch.Tensor,
                   k: int, pq_decode: str = "take"):
    """Stage 2 of pruned search on a mesh: (nq, C) global candidate ids ->
    the exact top-k among them, as ``ops/pruned.rerank_candidates`` gives
    on one device. Each shard reranks only the candidates it owns (packed
    to the front of each query's row), the score blocks come to the first
    device (or are all-gathered) and every candidate takes its owner's
    score; one stable sort over the candidates in stage 1's order then
    breaks ties as the one-device rerank does."""
    from evdr_tpu_torch.ops.pruned import rerank_chunk_q, rerank_scores

    mesh, rows = index.mesh, index.shard_rows
    per = -(-int(Q.shape[0]) // mesh.dp)
    nq, C = int(Q.shape[0]), int(cand.shape[1])
    if per * mesh.dp != nq:
        cand = torch.cat([cand, cand.new_zeros((per * mesh.dp - nq, C))])
    # every copy, then every shard's count of its candidates (a host
    # sync), before any shard's rerank is queued: neither may wait on
    # another shard's work
    cache = {}
    shards = shard_queries(Q, qmask, mesh, cache)
    owns = []
    for r, c, dev in mesh.local_shards():
        local = _on(cache, ("c", r), dev,
                    cand[r * per:(r + 1) * per]) - c * rows
        owned = (local >= 0) & (local < rows)
        owns.append((local, owned,
                     int(owned.sum(dim=1).max()) if per else 0))
    blocks = []
    for part, (Qr, qmr), (local, owned, m), (_, _, dev) in zip(
            index.parts, shards, owns, mesh.local_shards()):
        full = torch.full((per, C), -torch.inf, device=dev)
        if m:
            # this shard's candidates first, in stage 1's order
            sel = torch.sort((~owned).to(torch.uint8), dim=1,
                             stable=True).indices[:, :m]
            lidx = torch.gather(local, 1, sel).clamp_(0, rows - 1)
            chunk = rerank_chunk_q(m, part.pmask.shape[-1], Qr.shape[-1],
                                   part.books, pq_decode)
            sc = rerank_scores(Qr, qmr, part.P, part.pmask, lidx,
                               part.scales, part.books, pq_decode, chunk)
            sc = torch.where(torch.gather(owned, 1, sel), sc, -torch.inf)
            full.scatter_(1, sel, sc)
        blocks.append(full)
    dst = mesh.devices[0]
    groups_sc = [torch.stack(b.split(C, dim=1)).amax(dim=0) for b in
                 _by_group(gather_blocks(blocks, mesh, dst, "candidates"),
                           mesh, 1)]
    cand = cand.to(dst)
    out_v, out_i = [], []
    for r, sc in enumerate(groups_sc):
        v, pos = _select_topk(sc, min(k, C))
        out_v.append(v)
        out_i.append(torch.gather(cand[r * per:(r + 1) * per], 1, pos))
    return torch.cat(out_v)[:nq], torch.cat(out_i)[:nq]


def sharded_maxsim(Q, qmask, index: ShardedIndex, impl: str) -> torch.Tensor:
    """Full (Q, n_docs) scores (on a mesh: every shard's score block on
    the first device, or all-gathered across processes)."""
    if index.parts is not None:
        mesh = index.mesh
        blocks = gather_blocks([sc for _, sc in _shard_scores(
            Q, qmask, index, impl)], mesh, mesh.devices[0], "scores")
        sc = torch.cat(_by_group(blocks, mesh, 1))
        return sc[:Q.shape[0], :index.n_docs]
    sc = _local_scores(Q, qmask, index.P, index.pmask, impl, index.scales,
                       index.books)
    return sc[:, :index.n_docs]


def sharded_topk(Q, qmask, index: ShardedIndex, k: int, impl: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k (values, doc indices) per query: (nq, min(k, n_pad)) on
    one device, (nq, min(k, shards x min(k, shard_rows))) on a mesh."""
    if index.parts is not None:
        return _mesh_topk(Q, qmask, index, k, impl)
    return _single_device_topk(Q, qmask, index.P, index.pmask,
                               min(k, index.n_pad), impl, index.scales,
                               n_docs=index.n_docs, books=index.books)
