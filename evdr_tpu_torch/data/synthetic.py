"""Synthetic corpus generator — tiny random teacher indexes with learnable qrels.

A numpy copy of ``evdr_tpu/data/synthetic.py``: the same seed gives the same
bytes, and ``write_dataset_fixture`` registers into this package's own
``DATASETMAP``.

The reference repo consumes externally produced ColQwen features; for testing,
benchmarking, and the 1M-page scale config we synthesize compatible payloads:

- documents: per-page ragged ``(Li, D)`` unit-norm patch embeddings;
- queries: per-query ragged token sets built from noisy copies of tokens of the
  query's relevant page (so MaxSim retrieval is solvable, not random);
- relevant_docs / docidx_2_docid / qsidx_2_query with reference key conventions;
- a pooled init index (mean-pool every ``mf`` consecutive tokens) emulating the
  reference's S3E init (token count reduced ~mf×).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from evdr_tpu_torch.data.npz_io import save_compressed_npz


def make_synthetic_corpus(
    n_docs: int = 24,
    n_queries: int = 16,
    dim: int = 128,
    doc_len_range=(40, 90),
    query_len_range=(6, 14),
    noise: float = 0.25,
    seed: int = 0,
    queries_per_doc: Optional[int] = None,
    tokens_per_center: int = 6,
    intra_noise: float = 0.15,
) -> Dict:
    """Build an in-memory payload dict with the reference npz schema.

    Doc tokens are drawn from per-page cluster centers (+``intra_noise``
    jitter), mimicking the low-rank/cluster structure of real patch embeddings
    — this is what makes mf-× index compression learnable. Set
    ``tokens_per_center=1`` for fully incompressible i.i.d. tokens.
    """
    rng = np.random.default_rng(seed)

    def unit(x):
        return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)

    docs = np.empty(n_docs, dtype=object)
    attn = np.empty(n_docs, dtype=object)
    img = np.empty(n_docs, dtype=object)
    docid = np.empty(n_docs, dtype=object)
    for i in range(n_docs):
        li = int(rng.integers(doc_len_range[0], doc_len_range[1] + 1))
        n_centers = max(1, li // max(1, tokens_per_center))
        centers = unit(rng.normal(size=(n_centers, dim)))
        assign = rng.integers(0, n_centers, size=li)
        toks = centers[assign] + intra_noise * rng.normal(size=(li, dim))
        docs[i] = unit(toks).astype(np.float32)
        a = np.ones(li, dtype=bool)
        # sprinkle some invalid tokens to exercise masking
        a[rng.random(li) < 0.08] = False
        attn[i] = a
        m = np.ones(li, dtype=bool)
        m[rng.random(li) < 0.05] = False
        img[i] = m
        docid[i] = f"page_{i:05d}.jpg"

    queries = np.empty(n_queries, dtype=object)
    q_attn = np.empty(n_queries, dtype=object)
    qsidx_2_query = np.empty(n_queries, dtype=object)
    qid = np.empty(n_queries, dtype=object)
    relevant: Dict[str, Dict[str, int]] = {}
    for q in range(n_queries):
        tgt = q % n_docs if queries_per_doc is None else q // queries_per_doc
        tgt = int(tgt) % n_docs
        lq = int(rng.integers(query_len_range[0], query_len_range[1] + 1))
        src = docs[tgt]
        take = rng.integers(0, src.shape[0], size=lq)
        # RELATIVE noise (perturbation norm ~= noise * token norm) so query
        # difficulty is dim-independent
        g = rng.normal(size=(lq, dim)) / np.sqrt(dim)
        qtok = src[take] + noise * g
        queries[q] = unit(qtok).astype(np.float32)
        a = np.ones(lq, dtype=bool)
        a[rng.random(lq) < 0.1] = False
        a[0] = True
        q_attn[q] = a
        # single-token key: it doubles as the qid (gt-docs convention) and
        # TREC-run qids must be whitespace-free
        qkey = f"what-is-on-{docid[tgt]}-v{q}"
        qsidx_2_query[q] = qkey
        # qid IS the question string, mirroring the reference's real data:
        # its gt-docs datasets look up relevant_docs[str(qid)]
        # (Qdatasets/query_tensor_dataset.py:48) while eval qrels key by the
        # qsidx_2_query string — both only work because they coincide.
        qid[q] = qkey
        relevant[qkey] = {docid[tgt]: 1}

    docidx_2_docid = {str(i): docid[i] for i in range(n_docs)}
    return {
        "docid": docid,
        "documents": docs,
        "doc_attnmask": attn,
        "doc_imgmask": img,
        "query": queries,
        "qid": qid,
        "query_attnmask": q_attn,
        "relevant_docs": relevant,
        "docidx_2_docid": docidx_2_docid,
        "qsidx_2_query": qsidx_2_query,
    }


def make_queries_for_corpus(payload: Dict, n_queries: int, seed: int = 0,
                            noise: float = 0.25, query_len_range=(6, 14)) -> Dict:
    """Build a pseudo-query payload grounded in an existing corpus's pages
    (the ProxyQ analogue: queries answerable from specific pages)."""
    rng = np.random.default_rng(seed)
    docs = payload["documents"]
    docid = payload["docid"]
    n_docs = len(docs)

    def unit(x):
        return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)

    queries = np.empty(n_queries, dtype=object)
    q_attn = np.empty(n_queries, dtype=object)
    qsidx_2_query = np.empty(n_queries, dtype=object)
    qid = np.empty(n_queries, dtype=object)
    relevant: Dict[str, Dict[str, int]] = {}
    for q in range(n_queries):
        tgt = q % n_docs
        src = np.asarray(docs[tgt])
        lq = int(rng.integers(query_len_range[0], query_len_range[1] + 1))
        take = rng.integers(0, src.shape[0], size=lq)
        g = rng.normal(size=(lq, src.shape[1])) / np.sqrt(src.shape[1])
        qtok = src[take] + noise * g  # relative noise, dim-independent
        queries[q] = unit(qtok).astype(np.float32)
        a = np.ones(lq, dtype=bool)
        a[rng.random(lq) < 0.1] = False
        a[0] = True
        q_attn[q] = a
        qkey = f"pseudoq{q:06d}-about-{docid[tgt]}"  # single token (TREC qid)
        qsidx_2_query[q] = qkey
        qid[q] = qkey  # = question string (see make_synthetic_corpus note)
        relevant[qkey] = {str(docid[tgt]): 1}
    return {
        "query": queries,
        "qid": qid,
        "query_attnmask": q_attn,
        "qsidx_2_query": qsidx_2_query,
        "relevant_docs": relevant,
    }


def pooled_init_index(payload: Dict, mf: int, seed: int = 0,
                      init_noise: float = 0.0) -> Dict:
    """Mean-pool every ``mf`` consecutive valid tokens -> student init payload.

    Emulates the reference's externally produced "S3E_init" pooled index
    (token count reduced ~mf×), docids shuffled to exercise align_by_docid.
    ``init_noise`` degrades the init (useful to give distillation headroom in
    fixtures).
    """
    rng = np.random.default_rng(seed + 1)
    docs = payload["documents"]
    attn = payload["doc_attnmask"]
    img = payload["doc_imgmask"]
    n = len(docs)
    out_docs = np.empty(n, dtype=object)
    out_attn = np.empty(n, dtype=object)
    out_img = np.empty(n, dtype=object)
    for i in range(n):
        valid = np.asarray(attn[i], dtype=bool) & np.asarray(img[i], dtype=bool)
        toks = np.asarray(docs[i])[valid]
        if toks.shape[0] == 0:
            # all tokens masked: a zeros row instead of np.mean of an empty
            # slice (NaN), mirroring tools/pool_index.py's guard — a NaN
            # init row silently poisons the whole student
            toks = np.zeros((1, np.asarray(docs[i]).shape[1]), np.float32)
        li = max(1, toks.shape[0] // mf)
        pooled = np.stack(
            [np.mean(chunk, axis=0) for chunk in np.array_split(toks, li)]
        ).astype(np.float32)
        if init_noise > 0:
            # RELATIVE noise: perturbation norm ~= init_noise * token norm,
            # independent of dim (absolute per-component noise at high dim
            # would drown unit-norm embeddings entirely)
            g = rng.normal(size=pooled.shape).astype(np.float32)
            g *= 1.0 / np.sqrt(pooled.shape[-1])
            norms = np.linalg.norm(pooled, axis=-1, keepdims=True)
            pooled = pooled + init_noise * norms * g
        out_docs[i] = pooled
        out_attn[i] = np.ones(pooled.shape[0], dtype=bool)
        out_img[i] = np.ones(pooled.shape[0], dtype=bool)
    perm = rng.permutation(n)
    init = {
        "docid": payload["docid"][perm].copy(),
        "documents": out_docs[perm].copy(),
        "doc_attnmask": out_attn[perm].copy(),
        "doc_imgmask": out_img[perm].copy(),
    }
    return init


def save_synthetic_npz(path, payload: Dict) -> None:
    """Write a payload dict as a reference-schema pickled-object npz."""
    arrs = {}
    for k, v in payload.items():
        if isinstance(v, dict):
            arrs[k] = np.array(v, dtype=object)
        else:
            arrs[k] = np.asarray(v, dtype=object)
    np.savez_compressed(str(path), **arrs)


def save_init_npz(path, init: Dict) -> None:
    save_compressed_npz(
        path,
        docid=init["docid"],
        documents_obj=init["documents"],
        doc_attnmask_obj=init["doc_attnmask"],
        doc_imgmask_obj=init["doc_imgmask"],
        meta={"kind": "synthetic pooled init"},
    )


def write_dataset_fixture(
    root,
    key: str = "synth",
    n_docs: int = 16,
    n_test_queries: int = 12,
    n_train_queries: int = 64,
    dim: int = 64,
    mfs=(5, 10),
    seed: int = 0,
    init_noise: float = 0.0,
    **corpus_kw,
) -> str:
    """Write a full synthetic dataset in the registry's on-disk convention.

    Creates under ``root``: ``<stem>_dump_all.npz`` (teacher + test queries +
    qrels), ``<stem>_query.npz`` (pseudo-query pool), and
    ``S3E_init/mf{mf}/<stem>.npz`` pooled init indexes, and registers ``key``
    in ``DATASETMAP``. Returns the stem.
    """
    from pathlib import Path

    from evdr_tpu_torch.data.registry import register_dataset

    root = Path(root)
    stem = f"{key}_test"
    register_dataset(key, stem, mfs=tuple(mfs))

    teacher = make_synthetic_corpus(
        n_docs=n_docs, n_queries=n_test_queries, dim=dim, seed=seed, **corpus_kw)
    save_synthetic_npz(root / f"{stem}_dump_all.npz", teacher)

    # pseudo-query pool grounded in the SAME teacher pages (fresh noise draws)
    qp = make_queries_for_corpus(
        teacher, n_queries=n_train_queries, seed=seed + 123,
        noise=corpus_kw.get("noise", 0.25))
    save_synthetic_npz(root / f"{stem}_query.npz", qp)

    for mf in mfs:
        init = pooled_init_index(teacher, mf=mf, seed=seed, init_noise=init_noise)
        save_init_npz(root / "S3E_init" / f"mf{mf}" / f"{stem}.npz", init)
    return stem
