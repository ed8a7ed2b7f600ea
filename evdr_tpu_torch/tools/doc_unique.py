"""Document dedup: keep the first occurrence of each docid.

The torch port's copy of ``evdr_tpu/tools/doc_unique.py`` (numpy only). Console script: ``evdr-dedup-torch``.

Behavior parity with reference ``preprocess/doc_unique.py``: builds stable
first-occurrence keep indices on the raw full dump, slices every doc-axis key,
rebuilds ``docidx_2_docid``, and can apply the SAME keep indices to a second
npz (e.g. a pooled init index sharing the raw full's doc order). Includes the
``--sanity`` data-integrity check.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

DEFAULT_DOC_AXIS_KEYS = ("docid", "documents", "doc_attnmask", "doc_imgmask",
                         "attention")


def _to_str(x) -> str:
    return x.decode("utf-8", errors="ignore") if isinstance(x, bytes) else str(x)


def first_occurrence_keep(docids) -> np.ndarray:
    seen = set()
    keep = []
    for i, d in enumerate(docids):
        if d not in seen:
            seen.add(d)
            keep.append(i)
    return np.asarray(keep, dtype=np.int64)


def _slice_doc_axis(z, keep: np.ndarray, n_full: int,
                    doc_axis_keys) -> Dict:
    keys = set(doc_axis_keys)
    out = {}
    for k in z.files:
        arr = z[k]
        if k in keys and getattr(arr, "ndim", 0) > 0 and arr.shape[0] == n_full:
            out[k] = arr[keep]
        else:
            out[k] = arr
    return out


def dedup_npz(raw_full_npz, raw_unique_out,
              doc_axis_keys=DEFAULT_DOC_AXIS_KEYS) -> Tuple[np.ndarray, np.ndarray]:
    """Write the deduplicated npz; returns (keep indices, unique docids)."""
    z = np.load(raw_full_npz, allow_pickle=True)
    if "docid" not in z.files:
        raise ValueError(f"no 'docid' in {raw_full_npz}")
    docid_full = np.array([_to_str(x) for x in z["docid"]], dtype=object)
    keep = first_occurrence_keep(docid_full)

    out = _slice_doc_axis(z, keep, len(docid_full), doc_axis_keys)
    docid_unique = docid_full[keep]
    out["docid"] = docid_unique
    out["docidx_2_docid"] = np.array(
        {str(i): _to_str(docid_unique[i]) for i in range(len(docid_unique))},
        dtype=object)

    Path(raw_unique_out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(raw_unique_out, **out)
    return keep, docid_unique


def dedup_companion_npz(in_npz, out_npz, keep: np.ndarray,
                        docid_unique: np.ndarray, n_full: int,
                        doc_axis_keys=DEFAULT_DOC_AXIS_KEYS) -> None:
    """Apply the SAME keep indices to a companion npz (init index etc.)."""
    z = np.load(in_npz, allow_pickle=True)
    if "documents" not in z.files:
        raise ValueError(f"no 'documents' in {in_npz}")
    if z["documents"].shape[0] != n_full:
        raise ValueError(
            f"doc count mismatch: companion={z['documents'].shape[0]} vs "
            f"raw_full={n_full} — keep indices are not applicable")
    out = _slice_doc_axis(z, keep, n_full, doc_axis_keys)
    out["docid"] = docid_unique
    out["docidx_2_docid"] = np.array(
        {str(i): _to_str(docid_unique[i]) for i in range(len(docid_unique))},
        dtype=object)
    Path(out_npz).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out_npz, **out)


def sanity_check_unique(npz_path) -> Dict:
    z = np.load(npz_path, allow_pickle=True)
    n_docid = len(z["docid"]) if "docid" in z.files else None
    n_docs = z["documents"].shape[0] if "documents" in z.files else None
    m = z["docidx_2_docid"].item() if "docidx_2_docid" in z.files else None
    info = {
        "docid": n_docid,
        "documents": n_docs,
        "map": len(m) if isinstance(m, dict) else None,
        "ex0": m.get("0") if isinstance(m, dict) else None,
    }
    print(f"[CHECK] {npz_path}: {info}")
    return info


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--raw_full", required=True)
    p.add_argument("--raw_unique_out", required=True)
    p.add_argument("--in_npz", default=None)
    p.add_argument("--out_npz", default=None)
    p.add_argument("--doc_axis_keys", default=",".join(DEFAULT_DOC_AXIS_KEYS))
    p.add_argument("--sanity", action="store_true")
    a = p.parse_args(argv)
    keys = [x.strip() for x in a.doc_axis_keys.split(",") if x.strip()]

    if (a.in_npz is None) ^ (a.out_npz is None):
        # validate BEFORE dedup_npz: a rejected invocation must not leave a
        # half-done primary output on disk
        raise ValueError("--in_npz and --out_npz must be given together")
    keep, docid_unique = dedup_npz(a.raw_full, a.raw_unique_out, keys)
    if a.in_npz is not None:
        # the companion must align to the FULL (pre-dedup) doc count
        n_full = len(np.load(a.raw_full, allow_pickle=True)["docid"])
        dedup_companion_npz(a.in_npz, a.out_npz, keep, docid_unique, n_full, keys)
    if a.sanity:
        sanity_check_unique(a.raw_unique_out)
        if a.out_npz:
            sanity_check_unique(a.out_npz)


if __name__ == "__main__":
    main()
