"""Token-pooling index builder: teacher dump -> mf-x compressed init index.

The torch port's copy of ``evdr_tpu/tools/pool_index.py`` (numpy only). Console script: ``evdr-pool-torch``.

The reference consumes externally produced "S3E_init" pooled indexes
(utils/mapping.py mf5/10/25/50 entries) — the pooling itself happens outside
the repo. This tool closes that gap: given any teacher feature npz it builds
an mf-times-smaller init index by pooling valid tokens, ready for
distillation training.

Methods:
- ``mean``:    mean-pool consecutive valid tokens in groups of ~mf;
- ``kmeans``:  k-means cluster centers over each page's valid tokens
  (k = ceil(Li/mf), kmeans++-style init, a few Lloyd iterations) — matches
  the cluster structure of patch embeddings better than positional pooling.

    python -m evdr_tpu_torch.tools.pool_index --in_npz dump_all.npz \
        --out_root S3E_init --mfs 5 10 25 50 --method kmeans
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from evdr_tpu_torch.data.npz_io import load_payload, save_compressed_npz


def _mean_pool(tokens: np.ndarray, mf: int) -> np.ndarray:
    k = max(1, int(round(tokens.shape[0] / mf)))
    return np.stack([c.mean(axis=0) for c in np.array_split(tokens, k)])


def _kmeans_pool(tokens: np.ndarray, mf: int, iters: int = 8,
                 seed: int = 0) -> np.ndarray:
    n = tokens.shape[0]
    k = max(1, int(round(n / mf)))
    if k >= n:
        return tokens.copy()
    rng = np.random.default_rng(seed)

    # kmeans++ seeding
    centers = [tokens[rng.integers(n)]]
    d2 = np.full(n, np.inf)
    for _ in range(1, k):
        d2 = np.minimum(d2, ((tokens - centers[-1]) ** 2).sum(-1))
        total = d2.sum()
        if total <= 0.0:
            # every remaining token coincides with a center (pages with
            # repeated patch embeddings, e.g. uniform backgrounds): any
            # choice is equivalent — uniform instead of rng.choice crashing
            # on an all-zero probability vector
            centers.append(tokens[rng.integers(n)])
            continue
        centers.append(tokens[rng.choice(n, p=d2 / total)])
    centers = np.stack(centers)

    for _ in range(iters):
        # assign to nearest center, recompute means
        d = ((tokens[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        assign = d.argmin(axis=1)
        for c in range(k):
            members = tokens[assign == c]
            if len(members):
                centers[c] = members.mean(axis=0)
    return centers


def pool_payload(payload: dict, mf: int, method: str = "mean",
                 seed: int = 0) -> dict:
    """Pool every doc's VALID tokens; returns an init-payload dict."""
    docs = payload["documents"]
    attn = payload.get("doc_attnmask")
    img = payload.get("doc_imgmask")
    n = len(docs)
    out_docs = np.empty(n, dtype=object)
    out_attn = np.empty(n, dtype=object)
    out_img = np.empty(n, dtype=object)
    for i in range(n):
        toks = np.asarray(docs[i], dtype=np.float32)
        valid = np.ones(toks.shape[0], dtype=bool)
        if attn is not None and attn[i] is not None:
            valid &= np.asarray(attn[i], dtype=bool)[: len(valid)]
        if img is not None and img[i] is not None:
            valid &= np.asarray(img[i], dtype=bool)[: len(valid)]
        toks = toks[valid]
        if toks.shape[0] == 0:
            toks = np.zeros((1, np.asarray(docs[i]).shape[1]), np.float32)
        pooled = (_kmeans_pool(toks, mf, seed=seed + i) if method == "kmeans"
                  else _mean_pool(toks, mf)).astype(np.float32)
        out_docs[i] = pooled
        out_attn[i] = np.ones(pooled.shape[0], dtype=bool)
        out_img[i] = np.ones(pooled.shape[0], dtype=bool)
    return {
        "docid": payload["docid"],
        "documents": out_docs,
        "doc_attnmask": out_attn,
        "doc_imgmask": out_img,
    }


def build_pooled_index(in_npz, out_npz, mf: int, method: str = "mean",
                       seed: int = 0) -> None:
    payload = load_payload(in_npz)
    init = pool_payload(payload, mf, method=method, seed=seed)
    save_compressed_npz(
        out_npz,
        docid=init["docid"],
        documents_obj=init["documents"],
        doc_attnmask_obj=init["doc_attnmask"],
        doc_imgmask_obj=init["doc_imgmask"],
        meta={"kind": "pooled init", "mf": mf, "method": method,
              "source": str(in_npz)},
    )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--in_npz", required=True)
    p.add_argument("--out_root", required=True,
                   help="writes <out_root>/mf<k>/<stem>.npz (registry layout)")
    p.add_argument("--mfs", type=int, nargs="+", default=[5, 10, 25, 50])
    p.add_argument("--method", choices=("mean", "kmeans"), default="mean")
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    stem = Path(a.in_npz).stem.replace("_dump_all", "")
    for mf in a.mfs:
        out = Path(a.out_root) / f"mf{mf}" / f"{stem}.npz"
        build_pooled_index(a.in_npz, out, mf, method=a.method, seed=a.seed)
        print(f"[pool] mf{mf} -> {out}")


if __name__ == "__main__":
    main()
