"""Matrix-direct retrieval metrics: (nq, nd) scores + index-space qrels.

Drives the C++ engine (``metrics.cpp``) when the native library builds, and a
vectorized numpy implementation otherwise. Semantics are identical to the
dict-based ``evdr_tpu_torch.eval.metrics.compute_retrieval_metrics`` (trec_eval
conventions; ties by docid descending; per-metric means rounded to 5 dp) —
property-tested for equality against it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from evdr_tpu_torch.native.build import load_library

K_VALUES_DEFAULT = (1, 3, 5, 10, 50, 70, 100)


def native_available() -> bool:
    return load_library() is not None


def build_fast_qrels(
    qrels: Mapping[str, Mapping[str, int]],
    row_query_keys: Sequence[str],
    docid_to_idx: Mapping[str, int],
):
    """Dict qrels -> (row_map, indptr, doc_idx, rel) in qrels iteration order.

    Mirrors the dict path's semantics exactly: the averaging unit is the
    QRELS entry; a judged query scores through its LAST matching score row
    (duplicate query keys overwrite in the dict path) or contributes zeros if
    it has no row. Judgments whose docid is not in the index are kept with
    doc=-1 so the relevant-doc count (metric denominators) matches.
    """
    row_of = {str(qk): i for i, qk in enumerate(row_query_keys)}  # last wins
    row_map = np.empty(len(qrels), dtype=np.int64)
    indptr = np.zeros(len(qrels) + 1, dtype=np.int64)
    docs: List[int] = []
    rels: List[int] = []
    for i, (qk, judgments) in enumerate(qrels.items()):
        row_map[i] = row_of.get(str(qk), -1)
        for docid, rel in (judgments or {}).items():
            docs.append(docid_to_idx.get(str(docid), -1))
            rels.append(int(rel))
        indptr[i + 1] = len(docs)
    return (row_map, indptr, np.asarray(docs, dtype=np.int32),
            np.asarray(rels, dtype=np.int32))


def tie_rank_from_docids(docids: Sequence[str]) -> np.ndarray:
    """Rank of each doc index under DESCENDING docid order (trec tie-break)."""
    order = np.argsort(np.asarray([str(d) for d in docids], dtype=object))[::-1]
    rank = np.empty(len(order), dtype=np.int32)
    rank[order] = np.arange(len(order), dtype=np.int32)
    return rank


def _numpy_engine(scores, tie_rank, row_map, indptr, qdoc, qrel, ks):
    nq = len(row_map)
    nd = scores.shape[1]
    kmax = min(int(max(ks)), nd)
    # sort by (-score, tie_rank): lexsort with primary last
    out = np.zeros((5, len(ks)), dtype=np.float64)
    disc = 1.0 / np.log2(np.arange(2, kmax + 2, dtype=np.float64))
    for q in range(nq):
        if row_map[q] < 0:
            order = np.empty(0, dtype=np.int64)
        else:
            row = scores[row_map[q]]
            order = np.lexsort((tie_rank, -row))[:kmax]
        rel_of = np.zeros(nd, dtype=np.int32)
        lo, hi = indptr[q], indptr[q + 1]
        d, r = qdoc[lo:hi], qrel[lo:hi]
        ok = d >= 0
        rel_of[d[ok]] = r[ok]
        pos_rels = np.sort(r[r > 0])[::-1]
        n_rel = pos_rels.size

        rels_at = rel_of[order].astype(np.float64)
        hit_at = (rels_at > 0).astype(np.float64)
        hits = np.cumsum(hit_at)
        dcg = np.cumsum(rels_at * disc[: len(order)])
        ap = np.cumsum(np.where(hit_at > 0, hits / np.arange(1, len(order) + 1), 0.0))
        ideal = np.zeros(kmax)
        ideal[: min(n_rel, kmax)] = pos_rels[:kmax]
        idcg = np.cumsum(ideal * disc)
        first = np.nonzero(hit_at)[0]
        first_rank = first[0] + 1 if first.size else 0

        for i, k in enumerate(ks):
            kk = min(int(k), len(order))
            if kk <= 0:
                continue
            out[0, i] += dcg[kk - 1] / idcg[kk - 1] if idcg[kk - 1] > 0 else 0.0
            out[1, i] += ap[kk - 1] / n_rel if n_rel else 0.0
            out[2, i] += hits[kk - 1] / n_rel if n_rel else 0.0
            out[3, i] += hits[kk - 1] / int(k)
            out[4, i] += 1.0 / first_rank if 0 < first_rank <= kk else 0.0
    return out


def compute_metrics_from_scores(
    scores: np.ndarray,
    fast_qrels,
    tie_rank: np.ndarray,
    k_values: Sequence[int] = K_VALUES_DEFAULT,
) -> Dict[str, Dict[str, float]]:
    """-> the evaluator's nested metrics dict (NDCG/mAP/Recall/Precision/mRR).

    ``fast_qrels`` is the (row_map, indptr, doc_idx, rel) tuple from
    ``build_fast_qrels``.
    """
    scores = np.ascontiguousarray(scores, dtype=np.float32)
    nd = scores.shape[1]
    row_map, indptr, qdoc, qrel = fast_qrels
    nq = len(row_map)
    ks = np.asarray(list(k_values), dtype=np.int32)
    tie_rank = np.ascontiguousarray(tie_rank, dtype=np.int32)

    lib = load_library()
    if lib is not None:
        out = np.zeros((5, len(ks)), dtype=np.float64)
        fn = lib.evdr_compute_metrics
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
        ]
        row_map = np.ascontiguousarray(row_map, dtype=np.int64)
        indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        qdoc = np.ascontiguousarray(qdoc, dtype=np.int32)
        qrel = np.ascontiguousarray(qrel, dtype=np.int32)
        fn(
            scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64(nq), ctypes.c_int64(nd),
            row_map.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            tie_rank.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            qdoc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            qrel.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(len(ks)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
    else:
        out = _numpy_engine(scores, tie_rank, row_map, indptr, qdoc, qrel, ks)

    out = out / max(nq, 1)
    names = ("NDCG", "mAP", "Recall", "Precision", "mRR")
    prefixes = ("NDCG", "MAP", "Recall", "P", "MRR")
    return {
        name: {f"{pre}@{k}": round(float(out[m, i]), 5)
               for i, k in enumerate(k_values)}
        for m, (name, pre) in enumerate(zip(names, prefixes))
    }
