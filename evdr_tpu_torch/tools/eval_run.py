"""evdr-eval — score a retrieval run against qrels (trec_eval equivalent).

The torch port's copy of ``evdr_tpu/tools/eval_run.py``, on the port's
``convert_packed``, ``search.trec_qid`` and ``eval/metrics``. Console
script: ``evdr-eval-torch``.

Closes the offline serving loop: ``evdr-search-torch`` writes a TREC run file;
this tool evaluates it with the same metric conventions as the training
harness (eval/metrics.py: trec_eval-style nDCG/mAP/Recall/Precision/MRR @
{1,3,5,10,50,70,100}, docid-descending tie-break — the nesting the reference
builds from mteb in evaluator/retrieval.py:220-255).

    python -m evdr_tpu_torch.tools.eval_run --run run.trec --qrels qrels.txt
    python -m evdr_tpu_torch.tools.eval_run --run run.trec --qrels features.npz \
        [--queries features.npz]

Qrels sources: a TREC qrels file (``qid 0 docid rel`` per line) or any
feature npz carrying ``relevant_docs`` (interchange or packed format).

Key alignment: npz qrels follow the reference convention of being keyed by
QUERY STRING (``qsidx_2_query``), while TREC run files are keyed by ``qid``
(query strings contain whitespace). Pass ``--queries`` (the query feature
npz, usually the same file) to remap run qids onto qrels keys via its
``qid``/``qsidx_2_query`` arrays. Prints one JSON object with the metric
dicts plus query counts.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict


def read_trec_run(path) -> Dict[str, Dict[str, float]]:
    """TREC run lines ``qid Q0 docid rank score tag`` -> results dict."""
    results: Dict[str, Dict[str, float]] = {}
    with open(path) as fh:
        for ln, line in enumerate(fh, 1):
            parts = line.split()
            if not parts:
                continue
            if len(parts) < 6:
                raise ValueError(f"{path}:{ln}: expected 6 fields, got {len(parts)}")
            qid, _, docid, _, score, _ = parts[:6]
            results.setdefault(qid, {})[docid] = float(score)
    return results


def read_trec_qrels(path) -> Dict[str, Dict[str, int]]:
    """TREC qrels lines ``qid 0 docid rel`` -> qrels dict."""
    qrels: Dict[str, Dict[str, int]] = {}
    with open(path) as fh:
        for ln, line in enumerate(fh, 1):
            parts = line.split()
            if not parts:
                continue
            if len(parts) < 4:
                raise ValueError(f"{path}:{ln}: expected 4 fields, got {len(parts)}")
            qid, _, docid, rel = parts[:4]
            qrels.setdefault(qid, {})[docid] = int(rel)
    return qrels


def load_qrels(path) -> Dict[str, Dict[str, int]]:
    """Qrels from a TREC file or a feature npz's ``relevant_docs``."""
    if str(path).endswith(".npz"):
        from evdr_tpu_torch.data.npz_io import load_payload
        from evdr_tpu_torch.tools.convert_packed import is_packed, load_packed_payload

        payload = (load_packed_payload(path) if is_packed(path)
                   else load_payload(path))
        rel = payload.get("relevant_docs")
        if rel is None:
            raise ValueError(f"{path} has no relevant_docs")
        return {str(q): {str(d): int(r) for d, r in docs.items()}
                for q, docs in rel.items()}
    return read_trec_qrels(path)


def _qid_to_qkey(queries_npz) -> Dict[str, str]:
    """qid -> query-string key map from a query feature npz."""
    from evdr_tpu_torch.data.npz_io import load_payload
    from evdr_tpu_torch.tools.convert_packed import is_packed, load_packed_payload

    payload = (load_packed_payload(queries_npz) if is_packed(queries_npz)
               else load_payload(queries_npz))
    qid, qs = payload.get("qid"), payload.get("qsidx_2_query")
    if qid is None or qs is None:
        return {}
    # run files carry trec_qid-sanitized qids (whitespace -> '_'); key the
    # remap the same way so question-string qids round-trip losslessly
    from evdr_tpu_torch.tools.search import trec_qid

    return {trec_qid(i): str(s) for i, s in zip(qid, qs)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run", required=True, help="TREC run file (evdr-search-torch)")
    p.add_argument("--qrels", required=True,
                   help="TREC qrels file or feature npz with relevant_docs")
    p.add_argument("--queries", default=None,
                   help="query feature npz for qid -> query-string remapping")
    p.add_argument("--k", type=int, nargs="+",
                   default=[1, 3, 5, 10, 50, 70, 100])
    a = p.parse_args(argv)

    from evdr_tpu_torch.eval.metrics import compute_retrieval_metrics

    results = read_trec_run(a.run)
    qrels = load_qrels(a.qrels)
    if a.queries:
        remap = _qid_to_qkey(a.queries)
        remapped: Dict[str, Dict[str, float]] = {}
        for q, docs in results.items():
            key = remap.get(q, q) if q not in qrels else q
            if key in remapped:
                # two run qids collapsing onto one qrels key would silently
                # drop one query's results — refuse rather than under-report
                raise SystemExit(
                    f"error: run qids collide on qrels key {key!r} "
                    "(duplicate qid->query mapping in --queries?)")
            remapped[key] = docs
        results = remapped
    missing = [q for q in qrels if q not in results]
    if missing and len(missing) == len(qrels):
        print("warning: NO run query matches any qrels key — metrics will be "
              "~0. npz qrels are keyed by query string; pass --queries to "
              "remap run qids.", file=sys.stderr)
    metrics = compute_retrieval_metrics(qrels, results, k_values=list(a.k))
    out = dict(metrics)
    out["n_queries"] = len(qrels)
    out["n_queries_missing_from_run"] = len(missing)
    json.dump(out, sys.stdout, indent=1)
    sys.stdout.write("\n")


if __name__ == "__main__":
    main()
