"""MaxSim scoring and top-k retrieval over a single-device index.

Counterpart of the single-device half of ``evdr_tpu/parallel/topk.py``:
``_local_scores`` routes a float index to K1 and an int8 index to K2 (int8
or int8full mode), ``_single_device_topk`` masks padding columns and
selects top-k. The wrappers run their plain versions when the index lies on
the CPU. Multi-GPU sharded top-k is a later slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from evdr_tpu_torch.ops.cuda_maxsim import (maxsim_cuda, maxsim_cuda_int8,
                                            maxsim_cuda_int8full)
from evdr_tpu_torch.parallel.sharded_index import ShardedIndex


def _local_scores(Q, qmask, P, pmask, impl: str, scales=None):
    if scales is not None:
        # int8-quantized index (ops/quantize.py); '*_q8' engines quantize
        # the queries too and score int8 x int8
        if impl.endswith("_q8"):
            return maxsim_cuda_int8full(Q, P, scales, qmask, pmask)
        return maxsim_cuda_int8(Q, P, scales, qmask, pmask)
    return maxsim_cuda(Q, P, qmask, pmask)


def _select_topk(sc: torch.Tensor, k: int):
    """Exact top-k in ``lax.top_k``'s order: descending, and among equal
    scores the lower column first. A stable descending sort gives exactly
    that; ``torch.topk`` leaves the order of ties unspecified."""
    vals, idx = torch.sort(sc, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _single_device_topk(Q, qmask, P, pmask, k: int, impl: str, scales=None,
                        n_docs=None):
    sc = _local_scores(Q, qmask, P, pmask, impl, scales)
    # exclude only PADDING columns (index >= n_docs). A REAL doc with zero
    # valid tokens scores exactly 0 under MaxSim semantics and stays rankable.
    nd = int(pmask.shape[0])
    limit = nd if n_docs is None else int(n_docs)
    if limit < nd:
        sc[:, limit:] = -torch.inf
    return _select_topk(sc, k)


def sharded_maxsim(Q, qmask, index: ShardedIndex, impl: str) -> torch.Tensor:
    """Full (Q, n_docs) scores."""
    sc = _local_scores(Q, qmask, index.P, index.pmask, impl, index.scales)
    return sc[:, :index.n_docs]


def sharded_topk(Q, qmask, index: ShardedIndex, k: int, impl: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k (values, doc indices) per query."""
    return _single_device_topk(Q, qmask, index.P, index.pmask,
                               min(k, index.n_pad), impl, index.scales,
                               n_docs=index.n_docs)
