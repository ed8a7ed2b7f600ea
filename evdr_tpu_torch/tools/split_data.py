"""Query-axis train/test splitter for full-dump feature npz files.

The torch port's copy of ``evdr_tpu/tools/split_data.py`` (numpy only). Console script: ``evdr-split-torch``.

Behavior parity with reference ``preprocess/split_data.py:15-140``: documents
are duplicated into both splits; query-axis arrays (query, query_attnmask,
qid, qsidx_2_query) are sliced; relevant_docs is filtered to each split's qid
subset; split indices are recorded in a ``_split_idx`` npz for reproducibility.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Tuple

import numpy as np

QUERY_KEYS = ("query", "query_attnmask", "qid", "qsidx_2_query")
REQUIRED_KEYS = (
    "documents", "doc_attnmask", "doc_imgmask", "query", "query_attnmask",
    "docid", "qid", "relevant_docs", "docidx_2_docid", "qsidx_2_query",
)


def _relevant_docs(z) -> dict:
    v = z["relevant_docs"]
    if isinstance(v, np.ndarray) and v.shape == ():
        return v.item()
    return v if isinstance(v, dict) else v.item()


def split_query_npz(
    in_npz,
    out_dir,
    test_ratio: float = 0.2,
    shuffle: bool = False,
    seed: int = 42,
) -> Tuple[str, str, str]:
    in_npz = Path(in_npz)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    z = np.load(in_npz, allow_pickle=True)
    missing = [k for k in REQUIRED_KEYS if k not in z.files]
    if missing:
        raise KeyError(f"missing keys {missing}; available: {z.files}")

    qid = z["qid"]
    nq = len(qid)
    if len(z["query"]) != nq or len(z["query_attnmask"]) != nq:
        raise ValueError("query/qid/query_attnmask length mismatch")

    n_test = int(nq * test_ratio)
    if not 0 < n_test < nq:
        raise ValueError(f"bad test_ratio={test_ratio} for Nq={nq}")

    idx = np.arange(nq, dtype=np.int64)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    test_idx, train_idx = idx[:n_test], idx[n_test:]

    rel_all = _relevant_docs(z)
    doc_side = {
        k: z[k] for k in
        ("documents", "doc_attnmask", "doc_imgmask", "docid", "docidx_2_docid")
    }
    # carry through any extra metadata keys untouched (task/model/attention...)
    extras = {
        k: z[k] for k in z.files
        if k not in doc_side and k not in QUERY_KEYS and k != "relevant_docs"
    }

    def pack(indices):
        out = dict(doc_side)
        out.update(extras)
        for k in QUERY_KEYS:
            out[k] = z[k][indices]
        # relevant_docs may be keyed by qid (reference split tool) or by the
        # query string from qsidx_2_query (the eval path's keying) — keep
        # whichever key resolves, preserving the original key
        rel = {}
        for i in indices:
            for key in (str(z["qid"][i]), str(z["qsidx_2_query"][i])):
                if key in rel_all:
                    rel[key] = rel_all[key]
                    break
        out["relevant_docs"] = np.array(rel, dtype=object)
        out["qsidx"] = indices
        return out

    stem = in_npz.stem.replace("_dump_all", "").replace("_dump_new", "")
    paths = (
        out_dir / f"{stem}_train.npz",
        out_dir / f"{stem}_test.npz",
        out_dir / f"{stem}_split_idx.npz",
    )
    np.savez_compressed(paths[0], **pack(train_idx))
    np.savez_compressed(paths[1], **pack(test_idx))
    np.savez_compressed(
        paths[2], train_idx=train_idx, test_idx=test_idx, shuffle=shuffle,
        seed=seed, test_ratio=test_ratio, in_npz=str(in_npz), Nq=nq)
    return tuple(str(p) for p in paths)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--in_npz", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--test_ratio", type=float, default=0.2)
    p.add_argument("--shuffle", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    a = p.parse_args(argv)
    paths = split_query_npz(a.in_npz, a.out_dir, a.test_ratio, a.shuffle, a.seed)
    for tag, path in zip(("train", "test", "idx"), paths):
        print(f"  {tag}: {path}")


if __name__ == "__main__":
    main()
