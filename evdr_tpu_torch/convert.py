"""Carry an index built by the JAX package over to the port, bit for bit,
and a training state (student parameter + Adam moments) so that a JAX
checkpoint resumes in the port (:func:`train_state_from_numpy`).

The state a retrieval deployment carries is its index: the padded token
arrays (or codes), the mask, the int8/int4 scales, the PQ codebooks and
the doc ids. Taken from a JAX ``ShardedIndex`` as numpy arrays
(``np.asarray(eng.index.P)`` etc.; a bf16 index arrives as an ml_dtypes
bf16 array and is reinterpreted, not converted), :func:`index_from_numpy`
places the same bytes on the port's device, so both packages score the
same stored index.

    idx = jax_engine.index
    eng = RetrievalEngine.from_index(
        np.asarray(idx.P), np.asarray(idx.pmask), idx.n_docs,
        scales=None if idx.scales is None else np.asarray(idx.scales),
        books=None if idx.books is None else np.asarray(idx.books),
        books_expanded=idx.books_expanded, docids=idx.docids,
        dtype=jax_engine.dtype)
"""

from __future__ import annotations

import numpy as np
import torch

from evdr_tpu_torch.parallel.mesh import DeviceMesh
from evdr_tpu_torch.parallel.sharded_index import (ShardedIndex, _pad_docs,
                                                   as_tensor, shard_range)


def index_from_numpy(P, pmask, n_docs: int, scales=None, docids=None,
                     books=None, books_expanded: bool = False,
                     device="cuda") -> ShardedIndex:
    """Arrays (or tensors) of an existing padded index -> a ShardedIndex on
    ``device`` with the same element types and values. ``P`` is float32 or
    bfloat16 tokens; int8 codes or (N, ceil(Lp/2), D) token-pair packed
    uint8 int4 codes, then with ``scales``, their per-token f32 scales; or
    (N, Lp, M) uint8 PQ codes, then with ``books``, their f32 codebooks
    (``books_expanded`` for full-width OPQ books).

    ``device`` may be a ``DeviceMesh`` of several shards: each shard this
    process owns takes its rows of the first ``n_docs`` (padding to the
    mesh layout of ``build_sharded_index``, 64 rows a shard at a time)."""
    if isinstance(device, DeviceMesh) and device.size > 1:
        return _index_on_mesh(P, pmask, n_docs, scales, docids, books,
                              books_expanded, device)
    P = as_tensor(P, device)
    if P.dtype not in (torch.float32, torch.bfloat16, torch.int8,
                       torch.uint8):
        raise TypeError(f"unsupported index element type {P.dtype}")
    if scales is not None and books is not None:
        raise ValueError("an index carries scales or books, not both")
    if (P.dtype in (torch.int8, torch.uint8)) != (scales is not None
                                                  or books is not None):
        raise ValueError("int8/int4 codes come with scales, PQ codes with "
                         "books, float tokens with neither")
    if books is not None and P.dtype != torch.uint8:
        raise TypeError(f"PQ codes are uint8, got {P.dtype}")
    if not 0 <= int(n_docs) <= P.shape[0]:
        raise ValueError(f"n_docs={n_docs} outside [0, {P.shape[0]}]")
    return ShardedIndex(
        P=P.contiguous(),
        pmask=as_tensor(pmask, device, torch.bool).contiguous(),
        n_docs=int(n_docs),
        docids=None if docids is None else np.asarray(docids, dtype=object),
        scales=(None if scales is None
                else as_tensor(scales, device, torch.float32).contiguous()),
        books=(None if books is None
               else as_tensor(books, device, torch.float32).contiguous()),
        books_expanded=bool(books_expanded),
    )


def train_state_from_numpy(param, mu, nu, count, device="cuda"):
    """A JAX student parameter and its optax ``ScaleByAdamState`` (``mu``,
    ``nu``, ``count``, as numpy) -> (the port's parameter, a leaf f32 tensor
    on ``device`` that requires grad; its ``torch.optim.AdamW`` per-parameter
    state ``{"step", "exp_avg", "exp_avg_sq"}``). optax's moments are
    torch's ``exp_avg`` / ``exp_avg_sq`` under the same update rule, and its
    count is the step; the step stays a CPU f32 tensor, as AdamW keeps it.
    Load the state with ``opt.load_state_dict({"state": {0: state},
    "param_groups": opt.state_dict()["param_groups"]})``."""
    p = torch.tensor(np.asarray(param, dtype=np.float32), device=device)
    shape = tuple(p.shape)
    mu = np.asarray(mu, dtype=np.float32)
    nu = np.asarray(nu, dtype=np.float32)
    if mu.shape != shape or nu.shape != shape:
        raise ValueError(f"moments {mu.shape} / {nu.shape} do not match the "
                         f"parameter {shape}")
    state = {
        "step": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
        "exp_avg": torch.tensor(mu, device=device),
        "exp_avg_sq": torch.tensor(nu, device=device),
    }
    return p.requires_grad_(True), state


def _index_on_mesh(P, pmask, n_docs, scales, docids, books, books_expanded,
                   mesh) -> ShardedIndex:
    n = int(n_docs)
    if not 0 <= n <= P.shape[0]:
        raise ValueError(f"n_docs={n_docs} outside [0, {P.shape[0]}]")
    quantum = mesh.n_doc_shards * 64
    rows = -(-n // quantum) * quantum // mesh.n_doc_shards
    parts = []
    for _, col, dev in mesh.local_shards():
        lo, hi = shard_range(rows, col, n)
        part = index_from_numpy(
            P[lo:hi], pmask[lo:hi], hi - lo,
            scales=None if scales is None else scales[lo:hi], books=books,
            books_expanded=books_expanded, device=dev)
        part.P, part.pmask = _pad_docs(part.P, rows), _pad_docs(part.pmask,
                                                                rows)
        if part.scales is not None:
            part.scales = _pad_docs(part.scales, rows)
        parts.append(part)
    return ShardedIndex(
        P=None, pmask=None, n_docs=n,
        docids=None if docids is None else np.asarray(docids, dtype=object),
        books=parts[0].books, books_expanded=bool(books_expanded),
        mesh=mesh, parts=parts)
