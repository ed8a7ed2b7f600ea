"""Retrieval metrics: nDCG/mAP/Recall/Precision/MRR @ k — pure numpy.

Re-implements the metric conventions the reference gets from
``mteb.RetrievalEvaluator.evaluate`` (+``evaluate_custom`` for MRR), which are
the trec_eval / pytrec_eval conventions (reference ``evaluator/retrieval.py:220-255``):

- ndcg_cut@k : DCG = sum_{i<=k} rel_i / log2(i+1), IDCG over the query's own
  relevance judgments sorted descending; linear gains (trec_eval default).
- map_cut@k  : AP = sum_{i<=k, rel_i>0} P@i / R with R = total #relevant.
- recall@k   : |relevant in top-k| / R.
- P@k        : |relevant in top-k| / k.
- MRR@k      : 1/rank of the first relevant doc within top-k (beir/mteb custom).

Ties are broken by doc id in descending lexicographic order (trec_eval
convention). Per-metric averages are rounded to 5 decimals like mteb/beir.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np

Qrels = Mapping[str, Mapping[str, int]]
Results = Mapping[str, Mapping[str, float]]


def _ranked_docids(doc_scores: Mapping[str, float], depth: int) -> List[str]:
    # sort by score desc; ties by docid desc (trec_eval convention)
    items = sorted(doc_scores.items(), key=lambda kv: (-kv[1], _RevStr(kv[0])))
    return [d for d, _ in items[:depth]]


class _RevStr(str):
    """String with reversed ordering — descending-docid tie-break via sorted()."""

    def __lt__(self, other):  # type: ignore[override]
        return str.__gt__(self, other)


def ndcg_at_k(ranked: List[str], rels: Mapping[str, int], k: int) -> float:
    gains = np.array([rels.get(d, 0) for d in ranked[:k]], dtype=np.float64)
    discounts = 1.0 / np.log2(np.arange(2, gains.size + 2))
    dcg = float((gains * discounts).sum())
    ideal = np.sort(np.array([r for r in rels.values() if r > 0], dtype=np.float64))[::-1][:k]
    if ideal.size == 0:
        return 0.0
    idcg = float((ideal / np.log2(np.arange(2, ideal.size + 2))).sum())
    return dcg / idcg if idcg > 0 else 0.0


def recall_at_k(ranked: List[str], rels: Mapping[str, int], k: int) -> float:
    relevant = {d for d, r in rels.items() if r > 0}
    if not relevant:
        return 0.0
    hit = sum(1 for d in ranked[:k] if d in relevant)
    return hit / len(relevant)


def precision_at_k(ranked: List[str], rels: Mapping[str, int], k: int) -> float:
    relevant = {d for d, r in rels.items() if r > 0}
    hit = sum(1 for d in ranked[:k] if d in relevant)
    return hit / k


def average_precision_at_k(ranked: List[str], rels: Mapping[str, int], k: int) -> float:
    relevant = {d for d, r in rels.items() if r > 0}
    if not relevant:
        return 0.0
    hits, ap = 0, 0.0
    for i, d in enumerate(ranked[:k], start=1):
        if d in relevant:
            hits += 1
            ap += hits / i
    return ap / len(relevant)


def mrr_at_k(ranked: List[str], rels: Mapping[str, int], k: int) -> float:
    relevant = {d for d, r in rels.items() if r > 0}
    for i, d in enumerate(ranked[:k], start=1):
        if d in relevant:
            return 1.0 / i
    return 0.0


def compute_retrieval_metrics(
    qrels: Qrels,
    results: Results,
    k_values: List[int] = (1, 3, 5, 10, 50, 70, 100),
    ignore_identical_ids: bool = False,
) -> Dict[str, Dict[str, float]]:
    """Average metrics over the queries present in ``qrels``.

    Returns {"NDCG": {"NDCG@k": v}, "mAP": {"MAP@k": v}, "Recall": {...},
    "Precision": {"P@k": v}, "mRR": {"MRR@k": v}} — the exact nesting the
    reference builds from mteb (retrieval.py:248-253).
    """
    k_values = list(k_values)
    depth = max(k_values)
    acc = {
        "NDCG": {f"NDCG@{k}": 0.0 for k in k_values},
        "mAP": {f"MAP@{k}": 0.0 for k in k_values},
        "Recall": {f"Recall@{k}": 0.0 for k in k_values},
        "Precision": {f"P@{k}": 0.0 for k in k_values},
        "mRR": {f"MRR@{k}": 0.0 for k in k_values},
    }
    nq = len(qrels)
    if nq == 0:
        return acc
    for qid, rels in qrels.items():
        doc_scores = dict(results.get(qid, {}))
        if ignore_identical_ids:
            doc_scores.pop(qid, None)
        ranked = _ranked_docids(doc_scores, depth)
        for k in k_values:
            acc["NDCG"][f"NDCG@{k}"] += ndcg_at_k(ranked, rels, k)
            acc["mAP"][f"MAP@{k}"] += average_precision_at_k(ranked, rels, k)
            acc["Recall"][f"Recall@{k}"] += recall_at_k(ranked, rels, k)
            acc["Precision"][f"P@{k}"] += precision_at_k(ranked, rels, k)
            acc["mRR"][f"MRR@{k}"] += mrr_at_k(ranked, rels, k)
    for group in acc.values():
        for key in group:
            group[key] = round(group[key] / nq, 5)
    return acc
