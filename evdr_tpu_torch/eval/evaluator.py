"""Retrieval evaluator: score -> results dict -> metrics (+latency).

A port of ``evdr_tpu/eval/evaluator.py`` (API parity with the reference's
``CustomRetrievalEvaluator``, ``evaluator/retrieval.py:220-255``, and the
shared ``eval_retrieval`` path, ``mainv2_iter_listwise.py:299-322``): qrels
keyed by query string from ``qsidx_2_query``, results keyed by docid via
``docidx_2_docid``, latency measured as scoring wall-ms / n_queries.

Scoring is float32 through ``ops.maxsim.maxsim(impl=...)``: on CUDA tensors
with ``impl='auto'`` that is K1's float32 mode. The score matrix comes to the
host in one copy inside the timed region.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from evdr_tpu_torch.data.packing import l2_normalize
from evdr_tpu_torch.eval.metrics import compute_retrieval_metrics
from evdr_tpu_torch.ops.maxsim import maxsim


class CustomRetrievalEvaluator:
    """nDCG/mAP/Recall/Precision/MRR @ k_values over qrels/results dicts."""

    def __init__(self, k_values: List[int] = (1, 3, 5, 10, 50, 70, 100),
                 score_function: str = "cos_sim"):
        self.k_values = list(k_values)
        self.score_function = score_function

    def compute_mteb_metrics(
        self,
        relevant_docs: Mapping[str, Mapping[str, int]],
        results: Mapping[str, Mapping[str, float]],
        **kwargs,
    ) -> Dict[str, Any]:
        return compute_retrieval_metrics(
            relevant_docs,
            results,
            self.k_values,
            ignore_identical_ids=kwargs.get("ignore_identical_ids", False),
        )


def scores_to_results(
    scores: np.ndarray,
    qsidx_2_query: Optional[np.ndarray],
    docidx_2_docid: Mapping[str, str],
) -> Dict[str, Dict[str, float]]:
    """(Q, P) score matrix -> {query_key: {docid: score}} nested dict."""
    scores = np.asarray(scores, dtype=np.float64)
    nq, nd = scores.shape
    docids = [docidx_2_docid[str(di)] for di in range(nd)]
    results: Dict[str, Dict[str, float]] = {}
    for qi in range(nq):
        qkey = str(qsidx_2_query[qi]) if qsidx_2_query is not None else str(qi)
        results[qkey] = dict(zip(docids, scores[qi].tolist()))
    return results


# id()-keyed cache of CSR qrels. Each entry pins STRONG references to the
# keyed objects: CPython only reuses an id after the object is freed, so as
# long as the entry exists its key cannot alias a different object. Bounded
# (datasets per process are few); oldest entries evicted FIFO.
_FAST_CACHE: Dict[tuple, tuple] = {}
_FAST_CACHE_MAX = 64


def _fast_eval_inputs(relevant_docs, docidx_2_docid, qsidx_2_query, nq, nd):
    """Build (and cache) CSR qrels + docid tie-ranks for the native engine.

    Returns None when the corpus carries DUPLICATE docids: the dict path
    collapses duplicates while the fast engine would rank every column, so
    their metrics diverge — callers fall back to the dict path. The cache
    key includes cheap content fingerprints (judgment/corpus counts)."""
    fp = (len(relevant_docs),
          sum(len(v) for v in relevant_docs.values()),
          len(docidx_2_docid))
    key = (id(relevant_docs), id(docidx_2_docid), id(qsidx_2_query), nq, nd,
           fp)
    cached = _FAST_CACHE.get(key)
    if cached is not None:
        return cached[0]
    from evdr_tpu_torch.native.fast_metrics import (build_fast_qrels,
                                                    tie_rank_from_docids)

    docids = [docidx_2_docid[str(j)] for j in range(nd)]
    qkeys = [
        str(qsidx_2_query[i]) if qsidx_2_query is not None else str(i)
        for i in range(nq)
    ]
    if len(set(docids)) != len(docids):
        out = None
    else:
        fq = build_fast_qrels(relevant_docs, qkeys,
                              {str(d): j for j, d in enumerate(docids)})
        out = (fq, tie_rank_from_docids(docids))
    while len(_FAST_CACHE) >= _FAST_CACHE_MAX:
        _FAST_CACHE.pop(next(iter(_FAST_CACHE)))
    _FAST_CACHE[key] = (out, (relevant_docs, docidx_2_docid, qsidx_2_query))
    return out


def eval_retrieval(
    evaluator: CustomRetrievalEvaluator,
    Q_test_norm,
    qmask_test,
    student_param,
    pmask_student,
    relevant_docs_test: Mapping[str, Mapping[str, int]],
    docidx_2_docid_test: Mapping[str, str],
    qsidx_2_query_test=None,
    chunk_p: int = 128,
    impl: str = "auto",
    fast: bool = True,
    score_fn=None,
) -> Dict[str, Any]:
    """Retrieval metrics of the (masked+normalized) student index.

    Mirrors reference ``eval_retrieval`` (mainv2_iter_listwise.py:299-322):
    the student is re-masked and re-normalized before scoring; ``latency``
    is the per-query scoring wall time in ms. With ``fast=True`` metrics come
    from the matrix-direct native engine (identical values).

    ``score_fn`` overrides the scoring step entirely: it must return the
    full (n_queries, n_docs) score matrix for the CURRENT student; latency
    is timed around it. Scoring runs without autograd.
    """
    with torch.no_grad():
        if score_fn is not None:
            t0 = time.perf_counter()
            scores = score_fn()
            scores = (scores.cpu().numpy() if isinstance(scores, torch.Tensor)
                      else np.asarray(scores))
        else:
            # student re-normalization happens OUTSIDE the timed region: the
            # reference builds P_now before t0 and times only the scoring
            # call (mainv2_iter_listwise.py:306-310)
            P_now = l2_normalize(
                student_param * pmask_student[..., None].to(
                    student_param.dtype))
            if P_now.is_cuda:
                torch.cuda.synchronize(P_now.device)
            t0 = time.perf_counter()
            # fp32 accumulation: reported metrics must not depend on
            # bf16-rounded near-tie rankings (reference evaluates in fp32)
            scores = maxsim(Q_test_norm, P_now, qmask_test, pmask_student,
                            chunk_p=chunk_p, impl=impl,
                            compute_dtype=torch.float32)
            scores = scores.cpu().numpy()  # the host copy waits for the device
    latency_ms = (time.perf_counter() - t0) * 1000.0 / max(int(scores.shape[0]), 1)

    fast_inputs = None
    if fast and relevant_docs_test is not None and docidx_2_docid_test:
        fast_inputs = _fast_eval_inputs(
            relevant_docs_test, docidx_2_docid_test, qsidx_2_query_test,
            scores.shape[0], scores.shape[1])
    if fast_inputs is not None:
        from evdr_tpu_torch.native.fast_metrics import (
            compute_metrics_from_scores)

        fq, tie_rank = fast_inputs
        metrics = compute_metrics_from_scores(scores, fq, tie_rank,
                                              evaluator.k_values)
    else:
        results = scores_to_results(scores, qsidx_2_query_test,
                                    docidx_2_docid_test)
        metrics = evaluator.compute_mteb_metrics(relevant_docs_test, results)
    metrics["latency"] = float(latency_ms)
    return metrics
