"""npz payload I/O with the reference feature-file schema.

The interchange format is a pickled-object ``.npz`` holding per-item ragged
token arrays (parity with reference ``utils/preprocess_data.py:129-208``):

- ``docid``            object (N,) document ids (image paths / hashes)
- ``documents``        object (N,), each ``(Li, D)`` float — page patch embeddings
- ``doc_attnmask``     object (N,), each ``(Li,)`` bool-like (optional)
- ``doc_imgmask``      object (N,), each ``(Li,)`` bool-like (optional)
- ``query``            object (Q,), each ``(Lqi, D)`` float — query token embeddings
- ``qid``              object (Q,) query ids (pseudo-query payloads)
- ``query_attnmask``   object (Q,), each ``(Lqi,)`` bool-like (optional)
- ``relevant_docs``    0-d object: dict[qkey][docid] -> rel
- ``docidx_2_docid``   0-d object: dict[str(idx)] -> docid
- ``qsidx_2_query``    object (Q,) query-index -> query-string key

The dense *packed* format (no object dtype) is read by
``load_packed_npz`` through ``tools/convert_packed.py``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def load_npz(path) -> Any:
    return np.load(str(path), allow_pickle=True)


def _item_or_none(z, key: str):
    if key not in z.files:
        return None
    v = z[key]
    if isinstance(v, np.ndarray) and v.shape == ():
        return v.item()
    return v


def _arr_or_none(z, key: str):
    return z[key] if key in z.files else None


def load_payload(npz_path) -> Dict[str, Any]:
    """Generic payload loader (reference ``load_payload``, preprocess_data.py:185-208)."""
    with load_npz(npz_path) as z:
        return {
            "docid": _arr_or_none(z, "docid"),
            "documents": _arr_or_none(z, "documents"),
            "doc_attnmask": _arr_or_none(z, "doc_attnmask"),
            "doc_imgmask": _arr_or_none(z, "doc_imgmask"),
            "query": _arr_or_none(z, "query"),
            "qid": _arr_or_none(z, "qid"),
            "query_attnmask": _arr_or_none(z, "query_attnmask"),
            "relevant_docs": _item_or_none(z, "relevant_docs"),
            "docidx_2_docid": _item_or_none(z, "docidx_2_docid"),
            "qsidx_2_query": _arr_or_none(z, "qsidx_2_query"),
        }


def load_query_payload(npz_path) -> Dict[str, Any]:
    """Pseudo-query payload (reference ``load_query_payload``, preprocess_data.py:175-183)."""
    with load_npz(npz_path) as z:
        return {
            "query": z["query"],
            "qid": _arr_or_none(z, "qid"),
            "query_attnmask": _arr_or_none(z, "query_attnmask"),
            "qsidx_2_query": _arr_or_none(z, "qsidx_2_query"),
            "relevant_docs": _item_or_none(z, "relevant_docs"),
        }


def load_packed_npz(path) -> Dict[str, Any]:
    """Load a packed file (``tools/convert_packed.py`` format) without
    pickling; decodes the optional JSON meta sidecar key."""
    import json as _json

    from evdr_tpu_torch.tools.convert_packed import load_packed_payload

    out = load_packed_payload(path)
    with np.load(str(path)) as z:
        if "meta_json" in z.files:
            out["meta"] = _json.loads(str(z["meta_json"]))
    return out
