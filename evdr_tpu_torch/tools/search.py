"""evdr-search-torch — batch top-k retrieval CLI over a saved index, on a GPU.

Load a page-embedding index npz (the reference's pickled-object interchange
format, or the packed format of tools/convert_packed.py in any storage
dtype), load a query feature npz, and write per-query top-k results as a
TREC run file or JSON — the offline equivalent of
``RetrievalEngine.search``.

    python -m evdr_tpu_torch.tools.search --index dump_all.npz \
        --queries q.npz --k 10 --out run.trec [--format trec|json] \
        [--dtype bfloat16|int8|int4|pq [--quantize_queries]] [--device cpu]
        [--prune_centroids 4 --n_candidates 512 [--summary_dtype int8]]
        [--mesh_docs 4]

``--mesh_docs N`` shards the index over the first N GPUs
(``parallel/mesh.make_mesh``). Runs on the GPU unless ``--device cpu`` is given, and fails when there is
none. Prints one JSON summary line (n_queries, n_docs, per-query latency ms)
to stderr on completion.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _load_queries(path):
    """Query npz (interchange or packed) -> (Q_norm, qmask, query keys)."""
    from evdr_tpu_torch.data.npz_io import load_query_payload
    from evdr_tpu_torch.data.packing import preprocess_queries
    from evdr_tpu_torch.tools.convert_packed import (is_packed,
                                                     load_packed_payload)

    if is_packed(path):
        payload = load_packed_payload(path)
        Q, qmask = np.asarray(payload["Q_norm"]), np.asarray(payload["qmask"])
    else:
        payload = load_query_payload(path)
        Q, qmask = preprocess_queries(payload["query"],
                                      payload.get("query_attnmask"))
    qkeys = payload.get("qid")
    if qkeys is None:
        qkeys = payload.get("qsidx_2_query")
    if qkeys is None:
        qkeys = [str(i) for i in range(Q.shape[0])]
    return Q, qmask, [str(k) for k in qkeys]


def trec_qid(key) -> str:
    """Collapse whitespace runs in a query key to '_' so TREC run lines stay
    parseable (queries may be keyed by their question string)."""
    return "_".join(str(key).split()) or "_"


def write_trec_run(fh, qkeys, docids, scores, tag: str = "evdr_tpu") -> None:
    """Standard TREC run lines: ``qid Q0 docid rank score tag``."""
    for qk, ids, vals in zip(qkeys, docids, scores):
        for rank, (d, v) in enumerate(zip(ids, vals), start=1):
            fh.write(f"{trec_qid(qk)} Q0 {d} {rank} {float(v):.6f} {tag}\n")


def run_search(index_path, queries_path, k: int = 10, dtype: str = "bfloat16",
               impl: str = "auto", quantize_queries: bool = False,
               device=None, prune_centroids: int = 0, n_candidates: int = 0,
               summary_dtype=None, mesh_docs: int = 1):
    """Returns (qkeys, per-query docid lists, scores (nq, k), summary dict).
    ``prune_centroids`` with ``n_candidates``: two-stage pruned search;
    ``mesh_docs > 1``: the index sharded over that many GPUs."""
    import torch

    from evdr_tpu_torch.engine import RetrievalEngine
    from evdr_tpu_torch.parallel.mesh import make_mesh

    mesh = (make_mesh(mesh_docs, device=device or "cuda")
            if mesh_docs > 1 else None)
    # on a mesh the packed file is mapped and each shard's rows stream to
    # its device: the host never holds the whole index
    eng = RetrievalEngine.from_npz(index_path, mmap=mesh is not None,
                                   dtype=dtype, impl=impl,
                                   quantize_queries=quantize_queries,
                                   prune_centroids=prune_centroids,
                                   summary_dtype=summary_dtype,
                                   device=None if mesh else device,
                                   mesh=mesh)
    Q, qmask, qkeys = _load_queries(queries_path)
    kk = min(k, eng.n_docs)
    nc = n_candidates or None
    # warm-up: the first call builds and loads the kernels
    eng.search_dense(np.roll(Q, 1, axis=0), qmask, k=kk, n_candidates=nc)
    t0 = time.perf_counter()
    vals, idx = eng.search_dense(Q, qmask, k=kk, n_candidates=nc)
    latency_ms = (time.perf_counter() - t0) * 1000.0 / max(1, Q.shape[0])
    summary = {"n_queries": int(Q.shape[0]), "n_docs": int(eng.n_docs),
               "k": int(vals.shape[1]),
               "latency_ms_per_query": round(latency_ms, 4), "dtype": dtype,
               "impl": eng.impl, "device": str(eng.device),
               "pruned": bool(n_candidates and prune_centroids),
               "shards": int(mesh_docs)}
    if eng.device.type == "cuda":
        summary["device_name"] = torch.cuda.get_device_name(eng.device)
    return qkeys, eng.ids_for(idx), np.asarray(vals), summary


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--index", required=True, help="doc feature npz")
    p.add_argument("--queries", required=True, help="query feature npz")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--out", default="-", help="output path ('-' = stdout)")
    p.add_argument("--format", choices=("trec", "json"), default="trec")
    p.add_argument("--dtype",
                   choices=("float32", "bfloat16", "int8", "int4", "pq"),
                   default="bfloat16")
    p.add_argument("--impl", default="auto")
    p.add_argument("--prune_centroids", type=int, default=0)
    p.add_argument("--summary_dtype", default=None,
                   choices=("bfloat16", "int8", "int4"),
                   help="storage tier of the stage-1 pruning summaries "
                        "(default: engine dtype; bf16 for pq)")
    p.add_argument("--n_candidates", type=int, default=0)
    p.add_argument("--quantize_queries", action="store_true")
    p.add_argument("--device", default=None,
                   help="'cuda' (default) or 'cpu' for the plain path")
    p.add_argument("--mesh_docs", type=int, default=1,
                   help="shard the index over this many GPUs")
    p.add_argument("--tag", default="evdr_tpu")
    a = p.parse_args(argv)

    qkeys, ids, vals, summary = run_search(
        a.index, a.queries, k=a.k, dtype=a.dtype, impl=a.impl,
        quantize_queries=a.quantize_queries, device=a.device,
        prune_centroids=a.prune_centroids, n_candidates=a.n_candidates,
        summary_dtype=a.summary_dtype, mesh_docs=a.mesh_docs)

    fh = sys.stdout if a.out == "-" else open(a.out, "w")
    try:
        if a.format == "trec":
            write_trec_run(fh, qkeys, ids, vals, tag=a.tag)
        else:
            json.dump({qk: {d: float(v) for d, v in zip(row, vrow)}
                       for qk, row, vrow in zip(qkeys, ids, vals)}, fh)
            fh.write("\n")
    finally:
        if fh is not sys.stdout:
            fh.close()
    print(json.dumps(summary), file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
