"""MaxSim scoring and top-k retrieval over a single-device index.

Counterpart of the single-device half of ``evdr_tpu/parallel/topk.py``:
``_local_scores`` routes a PQ index (codes + books) to K3, a packed int4
index (uint8 codes + scales) to K4, an int8 index to K2 and a float index
to K1, in the reference's order; '*_q8' engines take each kernel's 'full'
mode (queries quantized to int8 on the device). ``_single_device_topk``
masks padding columns and selects top-k;
``_single_device_merged_topk`` does the same over a main index and an
incremental tail, with deleted docs masked by a device-side alive mask.
The wrappers run their plain versions when the index lies on the CPU.
Multi-GPU sharded top-k is a later slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from evdr_tpu_torch.ops.cuda_maxsim import (maxsim_cuda, maxsim_cuda_int4,
                                            maxsim_cuda_int4full,
                                            maxsim_cuda_int8,
                                            maxsim_cuda_int8full,
                                            maxsim_cuda_pq,
                                            maxsim_cuda_pqfull)
from evdr_tpu_torch.parallel.sharded_index import ShardedIndex


def _local_scores(Q, qmask, P, pmask, impl: str, scales=None, books=None):
    q8 = impl.endswith("_q8")
    if books is not None:
        # product-quantized index: P holds (N, Lp, M) uint8 codes, books the
        # compact (M, K, D/M) or expanded OPQ (M, K, D) codebooks (ops/pq.py)
        kernel = maxsim_cuda_pqfull if q8 else maxsim_cuda_pq
        return kernel(Q, P, qmask, pmask, books)
    if scales is not None and P.dtype == torch.uint8:
        # packed-int4 index (ops/int4.py): token-pair uint8 codes + scales
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


def sharded_maxsim(Q, qmask, index: ShardedIndex, impl: str) -> torch.Tensor:
    """Full (Q, n_docs) scores."""
    sc = _local_scores(Q, qmask, index.P, index.pmask, impl, index.scales,
                       index.books)
    return sc[:, :index.n_docs]


def sharded_topk(Q, qmask, index: ShardedIndex, k: int, impl: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k (values, doc indices) per query."""
    return _single_device_topk(Q, qmask, index.P, index.pmask,
                               min(k, index.n_pad), impl, index.scales,
                               n_docs=index.n_docs, books=index.books)
