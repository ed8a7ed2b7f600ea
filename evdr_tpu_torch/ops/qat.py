"""Quantization-aware distillation: train the student against its SERVING
representation (the port of ``evdr_tpu/ops/qat.py``).

The storage tiers (int8 / int4 / PQ: ``ops/quantize.py``, ``ops/int4.py``,
``ops/pq.py``) are normally applied after a student was distilled in f32.
Here the quantizer sits inside the train step behind a straight-through
estimator (STE): the forward pass scores the exact quantize -> dequantize
reconstruction the serving index will hold, the gradient flows through the
identity, so the optimizer learns embeddings that survive their own
storage type.

Numerics: each ``qdq_*`` reproduces ``dequantize(quantize_tokens_*(x))`` of
the serving quantizers bit for bit (``torch.round`` rounds half to even,
as ``np.rint`` and ``jnp.round`` do), and equals the JAX package's
``qdq_*`` on the same inputs; ``tests/test_torch_qat.py`` holds both.
"""

from __future__ import annotations

import torch

# tokens per chunk of the PQ assignment: its (tokens, M, K) distance table
# stays near 1 GB at M = 16, K = 256
_PQ_CHUNK_TOKENS = 65_536


def ste(x, q):
    """Straight-through estimator: forward ``x + (q - x)`` (the JAX form
    ``x + stop_gradient(q - x)``, so the rounding matches), gradient the
    identity on ``x``."""
    return x + (q - x).detach()


def _qdq_symmetric(x, levels: float):
    """Per-token symmetric quantize -> dequantize on the last axis, as
    ``quantize_tokens_int8`` (levels 127) and ``quantize_tokens_int4``
    (levels 7): s = amax / levels per token, code = clip(round(x / s)); a
    token that is all zero reconstructs to exact 0."""
    scale = x.abs().amax(dim=-1, keepdim=True) / levels
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe), -levels, levels)
    return torch.where(scale > 0, q * safe, torch.zeros_like(q))


def qdq_int8(x):
    return _qdq_symmetric(x, 127.0)


def qdq_int4(x):
    return _qdq_symmetric(x, 7.0)


def _pq_assign(x, books, expanded: bool):
    """(n, D) tokens -> (n, M) nearest-centroid codes, by the ||c||^2 -
    2<x, c> expansion the serving encoder uses; ties take the first index
    (``torch.argmin``, as ``jnp.argmin``). Expanded (M, K, D) books score
    full-D dots (the rotation is orthogonal, as ``encode_with_books``)."""
    m, k, w = books.shape
    c2 = (books * books).sum(dim=-1)                      # (M, K)
    out = torch.empty((x.shape[0], m), dtype=torch.long, device=x.device)
    for lo in range(0, x.shape[0], _PQ_CHUNK_TOKENS):
        xc = x[lo:lo + _PQ_CHUNK_TOKENS]
        if expanded:
            dots = torch.einsum("nd,mkd->nmk", xc, books)
        else:
            dots = torch.einsum("nmd,mkd->nmk", xc.reshape(-1, m, w), books)
        out[lo:lo + xc.shape[0]] = torch.argmin(c2 - 2.0 * dots, dim=-1)
    return out


def qdq_pq(x, books, pmask=None):
    """Nearest-centroid PQ reconstruction of ``x`` (..., D).

    Compact (M, K, D/M) books (``ops/pq.py``): ``x`` splits into M
    subvectors and the winning centroids CONCATENATE. Expanded OPQ (M, K, D)
    books (``ops/pq.expand_books``): the winning full-width vectors SUM, in
    subspace order. A masked token reconstructs to 0: with ``pmask`` the
    mask decides (a LIVE all-zero token keeps the nearest centroid to 0, as
    the serving encoder gives it); without it, an all-zero token counts as
    masked."""
    books = torch.as_tensor(books, device=x.device).float()
    m, k, w = books.shape
    d = x.shape[-1]
    lead = x.shape[:-1]
    expanded = m > 1 and w == d
    assign = _pq_assign(x.reshape(-1, d), books, expanded)
    rows = books[torch.arange(m, device=x.device), assign]  # (n, M, w)
    if expanded:
        rec = rows[:, 0]
        for j in range(1, m):
            rec = rec + rows[:, j]
    else:
        rec = rows.reshape(-1, m * w)
    rec = rec.reshape(*lead, -1)
    if pmask is not None:
        alive = torch.as_tensor(pmask, device=x.device).bool()[..., None]
    else:
        alive = (x != 0).any(dim=-1, keepdim=True)
    return torch.where(alive, rec, torch.zeros_like(rec))


def qat_apply(Ps, cfg_qat: str, books=None, pmask=None):
    """Serving-form STE pass over the normalized student ``Ps``.

    ``cfg_qat``: 'none' (identity), 'int8', 'int4', 'pq' or 'opq' (the last
    two need the codebooks fit on the current student: compact for 'pq',
    expanded for 'opq'; see the harness's ``_fit_qat_books``). The
    reconstruction is computed without autograd; the STE carries the
    gradient."""
    if cfg_qat == "none":
        return Ps
    if cfg_qat in ("pq", "opq") and books is None:
        raise ValueError(f"qat={cfg_qat!r} needs trained codebooks")
    with torch.no_grad():
        if cfg_qat == "int8":
            q = qdq_int8(Ps)
        elif cfg_qat == "int4":
            q = qdq_int4(Ps)
        elif cfg_qat in ("pq", "opq"):
            q = qdq_pq(Ps, books, pmask=pmask)
        else:
            raise ValueError(f"unknown qat tier {cfg_qat!r}")
    return ste(Ps, q)
