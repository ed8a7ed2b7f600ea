"""Product-quantized (PQ) multi-vector indexes: the 8-32x compression tier.

Counterpart of ``evdr_tpu/ops/pq.py``. Each D-dim token splits into ``M``
subvectors of ``D/M`` dims and stores only the uint8 id of the nearest
centroid in a per-subspace ``K <= 256``-entry codebook: M bytes per token,
8x below int8 at D=128, M=16.

Codebook training (:func:`train_pq`, :func:`train_opq`) and the host
encoders are numpy, copied from the JAX package, so the same seed gives the
same books bit for bit. :func:`encode_pq_device` encodes a corpus on the
GPU (one batched product per chunk). Scoring is asymmetric: queries stay
float, and ``sim(q, d) = <q, decode(d)>``; :func:`maxsim_pq` is the plain
f32 lookup-table oracle, the K3 kernel (``ops/cuda_maxsim.maxsim_cuda_pq``)
the serving path. OPQ rotations are folded into full-width "expanded"
books (:func:`expand_books`), whose per-subspace vectors SUM to the
reconstruction, so no scorer needs the rotation.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np
import torch

from evdr_tpu_torch.ops.maxsim import NEG_FILL


def _kmeans_np(X: np.ndarray, k: int, iters: int, rng,
               init: np.ndarray | None = None) -> np.ndarray:
    """Plain-numpy Lloyd with kmeans++ seeding (host-side, training-time).

    Small by construction: X is a <=``sample``-row slice of one subspace
    (ds = D/M dims). Empty clusters re-seed from the farthest points.
    ``init`` warm-starts Lloyd from existing centers (OPQ's alternating
    refits), skipping the kmeans++ pass.
    """
    n = X.shape[0]
    if n <= k:
        # fewer vectors than centroids: every vector is its own centroid,
        # the rest duplicate row 0 (harmless — never the argmin winner)
        reps = np.concatenate([X, np.repeat(X[:1], k - n, axis=0)], axis=0)
        return reps.astype(np.float32)
    centers = (np.array(init, np.float32, copy=True) if init is not None
               else _seed_np(X, k, rng))
    return _lloyd_np(X, centers, iters)


def _seed_np(X: np.ndarray, k: int, rng) -> np.ndarray:
    """kmeans++ seeding of ``k`` centers (the only draws from ``rng``)."""
    n = X.shape[0]
    centers = np.empty((k, X.shape[1]), np.float32)
    centers[0] = X[rng.integers(n)]
    d2 = np.full(n, np.inf, np.float32)
    for j in range(1, k):
        d2 = np.minimum(d2, ((X - centers[j - 1]) ** 2).sum(-1))
        tot = float(d2.sum())
        if tot <= 0.0:  # all remaining points coincide with a center
            centers[j:] = centers[j - 1]
            break
        centers[j] = X[rng.choice(n, p=d2 / tot)]
    return centers


def _lloyd_np(X: np.ndarray, centers: np.ndarray, iters: int) -> np.ndarray:
    """``iters`` Lloyd steps from ``centers`` (updated in place)."""
    k = centers.shape[0]
    for _ in range(iters):
        # assignment via the dot trick: ||x-c||^2 = ||x||^2 - 2x.c + ||c||^2
        dist = (centers * centers).sum(-1)[None, :] - 2.0 * (X @ centers.T)
        assign = np.argmin(dist, axis=1)
        # each cluster's members as one contiguous slice, in index order (a
        # stable sort): the rows of X[assign == j] in the same order, so
        # every mean is bit for bit the JAX package's, without k passes of
        # a boolean mask over X
        order = np.argsort(assign, kind="stable")
        bounds = np.searchsorted(assign[order], np.arange(k + 1))
        Xs = X[order]
        far = None
        for j in range(k):
            if bounds[j + 1] > bounds[j]:
                centers[j] = Xs[bounds[j]:bounds[j + 1]].mean(axis=0)
            else:  # re-seed empty cluster from the current farthest point
                if far is None:
                    far = X[np.argmax(np.min(dist, axis=1))]
                centers[j] = far
    return centers


def _pooled_tokens(P, pmask, m: int, sample: int, rng) -> np.ndarray:
    """Pool valid tokens across docs + uniform-subsample: (n_tok, D) f32.

    ``P`` may be a tensor on any device: the same rows are picked where it
    lies and only the sample comes to the host."""
    if isinstance(P, torch.Tensor):
        return _pooled_tokens_torch(P, pmask, m, sample, rng)
    P = np.asarray(P, dtype=np.float32)
    n, lp, d = P.shape
    if d % m:
        raise ValueError(f"dim {d} must divide into m={m} subspaces")
    toks = P.reshape(n * lp, d)
    if pmask is not None:
        toks = toks[np.asarray(pmask, bool).reshape(-1)]
    if toks.shape[0] == 0:
        raise ValueError("no valid tokens to train PQ on")
    if toks.shape[0] > sample:
        toks = toks[rng.choice(toks.shape[0], sample, replace=False)]
    return toks


def _pooled_tokens_torch(P, pmask, m: int, sample: int, rng) -> np.ndarray:
    n, lp, d = P.shape
    if d % m:
        raise ValueError(f"dim {d} must divide into m={m} subspaces")
    rows = torch.arange(n * lp, device=P.device)
    if pmask is not None:
        rows = rows[torch.as_tensor(pmask, device=P.device).bool()
                    .reshape(-1)]
    if rows.numel() == 0:
        raise ValueError("no valid tokens to train PQ on")
    if rows.numel() > sample:
        rows = rows[torch.as_tensor(
            rng.choice(rows.numel(), sample, replace=False),
            device=P.device)]
    return P.reshape(n * lp, d)[rows].float().cpu().numpy()


def _fit_books(toks: np.ndarray, m: int, k: int, iters: int, rng,
               init: np.ndarray | None = None) -> np.ndarray:
    """Per-subspace kmeans over pooled tokens: (M, K, D/M) f32.

    The same books as :func:`_kmeans_np` subspace after subspace: the
    seeds draw from ``rng`` in that order, and Lloyd's steps, which draw
    nothing, then run for all subspaces at once in threads (numpy releases
    the GIL inside its array operations)."""
    ds = toks.shape[1] // m
    sub = toks.reshape(-1, m, ds)
    xs = [np.ascontiguousarray(sub[:, j]) for j in range(m)]
    if xs[0].shape[0] <= k:
        return np.stack([_kmeans_np(x, k, iters, rng) for x in xs])
    seeds = [np.array(init[j], np.float32, copy=True) if init is not None
             else _seed_np(x, k, rng) for j, x in enumerate(xs)]
    with ThreadPoolExecutor(max(1, min(m, os.cpu_count() or 1))) as ex:
        books = list(ex.map(lambda xc: _lloyd_np(xc[0], xc[1], iters),
                            zip(xs, seeds)))
    return np.stack(books).astype(np.float32)


def _encode_tokens(toks: np.ndarray, books: np.ndarray) -> np.ndarray:
    """(n_tok, D) float -> (n_tok, M) uint8 nearest-centroid codes."""
    m, k, ds = books.shape
    sub = toks.reshape(-1, m, ds)
    codes = np.empty((toks.shape[0], m), np.uint8)
    cnorm = (books * books).sum(-1)  # (M, K)
    for j in range(m):
        x = sub[:, j]
        dist = cnorm[j][None, :] - 2.0 * (x @ books[j].T)
        codes[:, j] = np.argmin(dist, axis=1).astype(np.uint8)
    return codes


def train_pq(P, pmask=None, m: int = 16, k: int = 256, iters: int = 10,
             sample: int = 65536, seed: int = 0) -> np.ndarray:
    """Fit per-subspace codebooks on the valid tokens: (M, K, D/M) f32.

    Tokens are pooled across docs (masked ones dropped); at most ``sample``
    tokens train each subspace (uniform subsample)."""
    rng = np.random.default_rng(seed)
    toks = _pooled_tokens(P, pmask, m, sample, rng)
    return _fit_books(toks, m, k, iters, rng)


def train_opq(P, pmask=None, m: int = 16, k: int = 256, iters: int = 10,
              opq_iters: int = 8, sample: int = 65536, seed: int = 0
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Optimized PQ (OPQ-NP): learn an orthogonal rotation R that the
    codebooks quantize better, by alternating a codebook refit on the
    rotated tokens and the orthogonal-Procrustes solve (SVD of X^T X̂).

    Returns ``(books, rot)``: (M, K, D/M) codebooks in the ROTATED space
    and the (D, D) rotation. Encode with ``encode_pq(P, books, rot=rot)``;
    serve with ``expand_books(books, rot)``.
    """
    rng = np.random.default_rng(seed)
    X = _pooled_tokens(P, pmask, m, sample, rng)
    d = X.shape[1]
    R = np.eye(d, dtype=np.float32)
    books = None
    for _ in range(opq_iters):
        Y = X @ R.T
        # few Lloyd iters per outer step, warm-started: OPQ converges on
        # the alternation, not on per-step kmeans accuracy
        books = _fit_books(Y, m, k, max(2, iters // 3), rng, init=books)
        Yhat = _decode_tokens(_encode_tokens(Y, books), books)
        # orthogonal Procrustes: max_R tr(R X^T Yhat) -> R = V U^T
        U, _, Vt = np.linalg.svd(X.T.astype(np.float64)
                                 @ Yhat.astype(np.float64))
        R = (U @ Vt).T.astype(np.float32)
    # final full-strength codebook fit under the converged rotation
    books = _fit_books(X @ R.T, m, k, iters, rng, init=books)
    return books, R


def expand_books(books: np.ndarray, rot: np.ndarray) -> np.ndarray:
    """Fold an OPQ rotation into the codebooks: (M, K, D/M) + (D, D) ->
    (M, K, D) full-width codebooks in the ORIGINAL (un-rotated) space,
    E[m,k,:] = R[m-block rows]^T @ C[m,k]; reconstruction = sum_m
    E[m, code_m] (sum, not concat)."""
    m, k, ds = books.shape
    rot = np.asarray(rot, np.float32)
    d = rot.shape[0]
    if d != m * ds:
        raise ValueError(f"rotation dim {d} != m*ds = {m * ds}")
    # E[m,k,j] = Σ_s C[m,k,s] * R[m*ds+s, j]
    return np.einsum("mks,msj->mkj", books.astype(np.float32),
                     rot.reshape(m, ds, d)).astype(np.float32)


def books_expanded(books, d: int) -> bool:
    """True if ``books`` are full-width (M, K, D) expanded codebooks for
    token dim ``d`` (sum-decode), False for compact (M, K, D/M) (concat-
    decode)."""
    return int(books.shape[-1]) == int(d)


def encode_pq(P, books: np.ndarray, pmask=None, rot=None) -> np.ndarray:
    """(N, Lp, D) float -> (N, Lp, M) uint8 nearest-centroid codes.

    Masked tokens encode as code 0. ``rot`` (from :func:`train_opq`)
    rotates tokens into the codebooks' space before encoding; ``books``
    must then be the COMPACT rotated-space codebooks, not expanded ones."""
    P = np.asarray(P, dtype=np.float32)
    n, lp, d = P.shape
    m, k, ds = books.shape
    if m * ds != d:
        raise ValueError(
            f"encode_pq needs compact (M, K, D/M) books; got {books.shape} "
            f"for token dim {d} (expanded books cannot encode)")
    toks = P.reshape(n * lp, d)
    if rot is not None:
        toks = toks @ np.asarray(rot, np.float32).T
    codes = _encode_tokens(toks, books).reshape(n, lp, m)
    if pmask is not None:
        codes = np.where(np.asarray(pmask, bool)[..., None], codes,
                         np.uint8(0))
    return codes


def _encode_chunk_dev(toks, books, cn, rot):
    """One device chunk of nearest-centroid encoding: (c, D) f32 -> (c, M)
    uint8, the distance argmin as ONE batched product
    (||x-c||^2 = ||c||^2 - 2<x,c> + const-in-k)."""
    if rot is not None:
        toks = toks @ rot.T
    m, k, ds = books.shape
    sub = toks.reshape(-1, m, ds)
    prod = torch.einsum("cms,mks->cmk", sub, books)
    return torch.argmin(cn[None] - 2.0 * prod, dim=-1).to(torch.uint8)


def encode_pq_device(P, books, pmask=None, rot=None,
                     chunk_tokens: int = 262_144, device=None):
    """Corpus-scale PQ encoding on the GPU: same contract as
    :func:`encode_pq`, computed chunk by chunk with torch.

    ``P`` is a numpy array (codes come back as numpy) or a tensor (codes
    stay on its device, so a large index never visits the host).
    ``device`` places numpy input; None means the GPU (``device='cpu'``
    runs the same code on the host). Ties in the argmin may resolve
    differently from numpy's (another summation order); both pick a true
    nearest centroid."""
    from evdr_tpu_torch.engine import resolve_device

    as_numpy = not isinstance(P, torch.Tensor)
    dev = resolve_device(device) if as_numpy else P.device
    n, lp, d = P.shape
    m, k, ds = books.shape
    if m * ds != d:
        raise ValueError(
            f"encode_pq_device needs compact (M, K, D/M) books; got "
            f"{tuple(books.shape)} for token dim {d}")
    books_d = torch.as_tensor(np.asarray(books, np.float32), device=dev)
    cn = (books_d * books_d).sum(-1)                        # (M, K)
    rot_d = (None if rot is None
             else torch.as_tensor(np.asarray(rot, np.float32), device=dev))
    out = torch.empty((n * lp, m), dtype=torch.uint8, device=dev)
    for lo in range(0, n * lp, chunk_tokens):
        hi = min(lo + chunk_tokens, n * lp)
        # tokens are flattened chunk by chunk: a tensor index is never
        # copied whole
        t0, t1 = lo // lp, -(-hi // lp)
        sl = torch.as_tensor(P[t0:t1], device=dev).float().reshape(-1, d)
        sl = sl[lo - t0 * lp: hi - t0 * lp]
        out[lo:hi] = _encode_chunk_dev(sl, books_d, cn, rot_d)
    codes = out.reshape(n, lp, m)
    if pmask is not None:
        codes = codes * torch.as_tensor(np.asarray(pmask, bool) if as_numpy
                                        else pmask, device=dev
                                        ).bool()[..., None]
    return codes.cpu().numpy() if as_numpy else codes


def encode_corpus(P, books, pmask=None, rot=None, device=None):
    """Encode an index where the JAX package does: on the device for a
    tensor or past 2M tokens (:func:`encode_pq_device`; ``device`` places
    numpy input, None means the GPU), else by the host encoder
    :func:`encode_pq`, which takes minutes at a million pages. Argmin ties
    may resolve differently; both pick a nearest centroid."""
    if isinstance(P, torch.Tensor) or P.shape[0] * P.shape[1] > 2_000_000:
        return encode_pq_device(P, books, pmask, rot=rot, device=device)
    return encode_pq(P, books, pmask, rot=rot)


def build_pq_index(P, pmask=None, m: int = 16, opq: bool = False,
                   device=None) -> Tuple:
    """(N, Lp, D) tokens -> ((N, Lp, M) uint8 codes, books), as the JAX
    engine and ``convert_packed`` make them: books trained on the host from
    a token sample (a tensor index sends only the sample there), codes by
    :func:`encode_corpus`. ``opq=True`` learns a rotation and returns it
    folded into expanded (M, K, D) books."""
    if opq:
        books, rot = train_opq(P, pmask, m=m)
        return (encode_corpus(P, books, pmask, rot=rot, device=device),
                expand_books(books, rot))
    books = train_pq(P, pmask, m=m)
    return encode_corpus(P, books, pmask, device=device), books


def encode_with_books(P, books, pmask=None, rot=None) -> np.ndarray:
    """Encode tokens against EITHER codebook layout.

    Compact (M, K, D/M) books (+ optional ``rot``) use the standard
    subspace encoder. Expanded (M, K, D) OPQ books encode WITHOUT the
    rotation matrix: because R is orthogonal,
    ``argmin_k ||(Rx)[m] - C[m,k]||^2 = argmin_k (||E[m,k]||^2 - 2<x, E[m,k]>)``."""
    P = np.asarray(P, dtype=np.float32)
    n, lp, d = P.shape
    m, k, w = books.shape
    if not (m > 1 and w == d):                  # compact layout
        return encode_pq(P, books, pmask, rot=rot)
    if rot is not None:
        raise ValueError("expanded books already carry the rotation")
    toks = P.reshape(n * lp, d)
    books = np.asarray(books, np.float32)
    cn = (books * books).sum(-1)                # (M, K)
    codes = np.empty((n * lp, m), np.uint8)
    for j in range(m):
        dist = cn[j][None, :] - 2.0 * (toks @ books[j].T)
        codes[:, j] = np.argmin(dist, axis=1).astype(np.uint8)
    codes = codes.reshape(n, lp, m)
    if pmask is not None:
        codes = np.where(np.asarray(pmask, bool)[..., None], codes,
                         np.uint8(0))
    return codes


def _decode_tokens(codes: np.ndarray, books: np.ndarray) -> np.ndarray:
    """(n_tok, M) codes -> (n_tok, M*ds) reconstructions (compact books)."""
    m = books.shape[0]
    rec = books[np.arange(m)[None, :], codes.astype(np.int64)]
    return rec.reshape(codes.shape[0], -1)


def decode_pq(codes, books, expanded: bool = False) -> np.ndarray:
    """Reconstruct (N, Lp, D) f32 from codes — the scoring oracle.

    ``expanded=False``: compact (M, K, D/M) books, subspace centroids
    CONCATENATE. ``expanded=True``: full-width (M, K, D) OPQ books
    (:func:`expand_books`), per-subspace vectors SUM."""
    codes = np.asarray(codes)
    books = np.asarray(books, np.float32)
    m, k, w = books.shape
    if codes.shape[-1] != m:
        raise ValueError(f"codes last dim {codes.shape[-1]} != M={m}")
    gathered = books[np.arange(m)[None, None, :], codes.astype(np.int64)]
    if expanded:
        return gathered.sum(axis=2)                       # (N, Lp, D)
    return gathered.reshape(*codes.shape[:2], m * w)      # concat subspaces


def _pq_chunk(lut, qmask_f, codes_c, pmc):
    """Score one doc chunk from the LUT: (B,Lq,M,K) x (C,Lp,M) -> (B,C),
    sim[b,l,c,p] = sum_m lut[b,l,m,codes[c,p,m]], accumulated in f32."""
    b, lq, m, k = lut.shape
    c, lp = pmc.shape
    flat = codes_c.reshape(c * lp, m).long()
    sim = torch.zeros((b, lq, c * lp), dtype=torch.float32,
                      device=lut.device)
    for j in range(m):
        sim = sim + lut[:, :, j].index_select(-1, flat[:, j])
    sim = sim.view(b, lq, c, lp).masked_fill(~pmc[None, None], NEG_FILL)
    mx = sim.amax(dim=-1)                                      # (B, Lq, C)
    mx = mx * pmc.any(dim=-1)[None, None, :].to(mx.dtype)
    mx = mx * qmask_f[:, :, None]
    return mx.sum(dim=1)


def maxsim_pq(Q, codes, qmask, pmask, books, chunk_p: int = 128
              ) -> torch.Tensor:
    """Masked MaxSim over a PQ index in f32: (B, N) scores, from a per-
    (query token, subspace) lookup table; the counterpart of the JAX
    oracle ``maxsim_pq_xla`` (-1e4 fill, a doc with no valid token scores
    0). ``books``: compact (M, K, D/M) or expanded OPQ (M, K, D)."""
    Q = Q.float()
    qmask_f = qmask.float()
    pmask = pmask.bool()
    books = torch.as_tensor(books, device=Q.device).float()
    m, k, w = books.shape
    b, lq, d = Q.shape
    if w == d and m > 1:   # expanded OPQ books: LUT over the full D
        lut = torch.einsum("bld,mkd->blmk", Q, books)
    else:
        lut = torch.einsum("blms,mks->blmk", Q.reshape(b, lq, m, w), books)
    chunk_p = max(1, min(chunk_p, codes.shape[0]))
    return torch.cat([
        _pq_chunk(lut, qmask_f, codes[i:i + chunk_p], pmask[i:i + chunk_p])
        for i in range(0, codes.shape[0], chunk_p)], dim=1)
