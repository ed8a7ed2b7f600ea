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

from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from evdr_tpu_torch.data.packing import _as_object_array


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
            # a QAT-pq student's codebooks (written by the JAX trainer);
            # engine.from_npz serves with them
            "qat_books": _arr_or_none(z, "qat_books"),
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


def load_init_payload(npz_path) -> Dict[str, Any]:
    """Student-init payload (reference ``load_init_payload``, preprocess_data.py:166-173)."""
    z = load_npz(npz_path)
    return {
        "docid": _arr_or_none(z, "docid"),
        "documents": z["documents"],
        "doc_attnmask": _arr_or_none(z, "doc_attnmask"),
        "doc_imgmask": _arr_or_none(z, "doc_imgmask"),
    }


def tokens_to_object(P_pad: np.ndarray, pmask: np.ndarray) -> np.ndarray:
    """Dense ``(N, L, D)`` + bool mask -> object array of per-doc ``(Li, D)`` float32.

    Parity with reference ``utils/utils.py:11-17`` (gathers only masked-True rows,
    preserving their order).
    """
    n = P_pad.shape[0]
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = np.asarray(P_pad[i][np.asarray(pmask[i], dtype=bool)], dtype=np.float32)
    return out


def save_compressed_npz(
    save_path,
    docid: np.ndarray,
    documents_obj: np.ndarray,
    doc_attnmask_obj: Optional[np.ndarray],
    doc_imgmask_obj: Optional[np.ndarray],
    meta: Dict[str, Any],
    extra: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    """Write a compressed student index npz (reference ``utils/utils.py:83-103``).

    ``extra``: additional dense arrays stored verbatim."""
    save_path = Path(save_path)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "docid": _as_object_array(docid),
        "documents": _as_object_array(documents_obj),
        "meta": np.array(meta, dtype=object),
    }
    if doc_attnmask_obj is not None:
        payload["doc_attnmask"] = _as_object_array(doc_attnmask_obj)
    if doc_imgmask_obj is not None:
        payload["doc_imgmask"] = _as_object_array(doc_imgmask_obj)
    if extra:
        payload.update({k: np.asarray(v) for k, v in extra.items()})
    np.savez_compressed(str(save_path), **payload)


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
