"""Ragged -> dense packing with static shapes and mask composition.

Semantics parity with the reference (``utils/preprocess_data.py``):

- zero-pad token arrays to the batch max length; ``valid`` marks real tokens
  (:37-56);
- attn / img masks pad to False, default to ``valid`` when absent (:59-77);
- doc mask  = valid & attn & img      (:101)
- query mask = valid & attn           (:121)
- queries are L2-normalized at load (:124) with ``x / (||x|| + 1e-12)`` (:8-9);
  documents are normalized at use sites as ``l2_normalize(P * mask)``.

Padded lengths can be rounded up to a multiple (``length_multiple``);
padding is inert by construction because the masks zero it out.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def l2_normalize(x, eps: float = 1e-12):
    """Row-normalize the last dim: ``x / (||x|| + eps)`` (reference
    preprocess_data.py:8-9). Takes a numpy array or a torch tensor and
    returns the same kind; an all-zero row stays zero."""
    if isinstance(x, torch.Tensor):
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)
    x = np.asarray(x)
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / (n + eps)


def _as_object_array(x) -> np.ndarray:
    if isinstance(x, np.ndarray) and x.dtype == object:
        return x
    if isinstance(x, np.ndarray):
        return x.astype(object)
    out = np.empty(len(x), dtype=object)
    for i, v in enumerate(x):
        out[i] = v
    return out


def _to_bool_1d(arr) -> Optional[np.ndarray]:
    if arr is None:
        return None
    a = np.asarray(arr)
    if a.dtype == object:
        a = np.asarray(a.tolist())
    a = a.astype(bool)
    if a.ndim == 2 and a.shape[-1] == 1:
        a = a.squeeze(-1)
    return a


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_tokens_object(
    tok_list: np.ndarray, length_multiple: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """Object array (N,) of (Li, D) -> ``(N, L, D)`` float32 + ``(N, L)`` bool valid.

    ``L = roundup(max Li, length_multiple)`` — the reference pads to the exact
    max (preprocess_data.py:37-56); rounding up is optional.
    """
    tok_list = _as_object_array(tok_list)
    n = len(tok_list)
    lens = np.array([int(np.asarray(tok_list[i]).shape[0]) for i in range(n)],
                    dtype=np.int64)
    d = int(np.asarray(tok_list[0]).shape[1])
    L = round_up(int(lens.max()), length_multiple)

    pad = np.zeros((n, L, d), dtype=np.float32)
    valid = np.zeros((n, L), dtype=bool)
    for i in range(n):
        li = int(lens[i])
        pad[i, :li] = np.asarray(tok_list[i], dtype=np.float32)
        valid[i, :li] = True
    return pad, valid


def pad_mask_object(
    mask_list: Optional[np.ndarray], L: int, N: int, valid: np.ndarray
) -> np.ndarray:
    """Object array of per-item bool masks -> ``(N, L)`` bool padded False.

    Absent mask (None) defaults to ``valid`` (reference preprocess_data.py:59-77).
    """
    if mask_list is None:
        return valid.copy()
    mask_list = _as_object_array(mask_list)
    out = np.zeros((N, L), dtype=bool)
    for i in range(N):
        mi = _to_bool_1d(mask_list[i])
        if mi is None:
            out[i] = valid[i]
        else:
            li = min(L, mi.shape[0])
            out[i, :li] = mi[:li]
    return out


def preprocess_docs(
    documents_obj: np.ndarray,
    doc_attnmask_obj: Optional[np.ndarray] = None,
    doc_imgmask_obj: Optional[np.ndarray] = None,
    length_multiple: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack docs: returns ``(P_raw (N,L,D) f32, pmask (N,L) bool, valid (N,L) bool)``.

    ``pmask = valid & attn & img`` (reference preprocess_data.py:80-105). P_raw
    is NOT normalized — normalization happens at use sites as
    ``l2_normalize(P*mask)``.
    """
    P_pad, valid = pad_tokens_object(documents_obj, length_multiple)
    n, L, _ = P_pad.shape
    am = pad_mask_object(doc_attnmask_obj, L=L, N=n, valid=valid)
    im = pad_mask_object(doc_imgmask_obj, L=L, N=n, valid=valid)
    pmask = valid & am & im
    return P_pad, pmask, valid


def preprocess_queries(
    query_obj: np.ndarray,
    query_attnmask_obj: Optional[np.ndarray] = None,
    length_multiple: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack queries: returns ``(Q_norm (Q,Lq,D) f32 L2-normalized, qmask (Q,Lq) bool)``.

    ``qmask = valid & attn`` (reference preprocess_data.py:108-126). Note the
    reference normalizes *all* rows incl. padding (zeros stay zeros with +eps).
    """
    Q_pad, valid = pad_tokens_object(query_obj, length_multiple)
    qn, lq, _ = Q_pad.shape
    qm = pad_mask_object(query_attnmask_obj, L=lq, N=qn, valid=valid)
    qmask = valid & qm
    Q = l2_normalize(Q_pad)
    return Q.astype(np.float32), qmask


def pad_axis_to_multiple(x: np.ndarray, axis: int, multiple: int, fill=0):
    """Pad one axis of a dense array up to a multiple (masks make padding inert)."""
    size = x.shape[axis]
    target = round_up(size, multiple)
    if target == size:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - size)
    return np.pad(x, widths, constant_values=fill)
