"""Masked MaxSim late-interaction scoring: chunked torch oracle + numpy oracle.

Scoring semantics (parity with reference ``evaluator/retrieval.py:166-213``):

    score[q, p] = sum_n qmask[q, n] * max_m sim[q, p, n, m]

where ``sim = Q . P^T`` per token pair, invalid doc tokens are filled with
``-1e4`` before the max, documents with **no** valid token score 0, and
invalid query tokens are zeroed by multiplying with the float qmask.
Everything is computed in float32.

``maxsim_torch`` chunks the doc axis so the (Q, C, Lq, Lp) similarity
tensor never exceeds one chunk; it is differentiable through autograd.
The fused kernels live in ``evdr_tpu_torch.ops.cuda_maxsim`` (forward) and
``evdr_tpu_torch.ops.cuda_maxsim_train`` (the differentiable op); the
dispatcher :func:`maxsim` picks between them and ``maxsim_torch``.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from evdr_tpu_torch.ops.cuda_maxsim import maxsim_cuda
from evdr_tpu_torch.ops.cuda_maxsim_train import MaxSimFn

NEG_FILL = -1e4  # reference uses -1e4, not -inf (retrieval.py:185)


def maxsim_numpy(Q, P, qmask, pmask) -> np.ndarray:
    """Pure-numpy brute-force oracle. O(Q*P*Lq*Lp*D) — tests only."""
    Q = np.asarray(Q, dtype=np.float32)
    P = np.asarray(P, dtype=np.float32)
    qmask = np.asarray(qmask, dtype=bool)
    pmask = np.asarray(pmask, dtype=bool)
    sim = np.einsum("qnd,cmd->qcnm", Q, P)
    sim = np.where(pmask[None, :, None, :], sim, NEG_FILL)
    mx = sim.max(axis=-1)
    mx = mx * pmask.any(axis=-1)[None, :, None].astype(np.float32)
    mx = mx * qmask[:, None, :].astype(np.float32)
    return mx.sum(axis=-1)


def _maxsim_chunk(Q, qmask_f, Pc, pmc):
    """Score one doc chunk: (Q,Lq,D) x (C,Lp,D) -> (Q,C)."""
    sim = torch.einsum("qnd,cmd->qcnm", Q, Pc)
    sim = sim.masked_fill(~pmc[None, :, None, :], NEG_FILL)
    mx = sim.amax(dim=-1)
    mx = mx * pmc.any(dim=-1)[None, :, None].to(mx.dtype)
    mx = mx * qmask_f[:, None, :]
    return mx.sum(dim=-1)


def maxsim_torch(Q, P, qmask, pmask, chunk_p: int = 128) -> torch.Tensor:
    """Differentiable chunked MaxSim in plain torch.

    Args:
      Q:     (Qn, Lq, D) float tensor
      P:     (Pn, Lp, D) float tensor
      qmask: (Qn, Lq) bool
      pmask: (Pn, Lp) bool
      chunk_p: doc-axis chunk size.
    Returns:
      (Qn, Pn) float32 scores on Q's device.
    """
    Q = Q.float()
    P = P.float()
    qmask_f = qmask.float()
    pmask = pmask.bool()
    chunk_p = max(1, min(chunk_p, P.shape[0]))
    parts = [_maxsim_chunk(Q, qmask_f, P[i:i + chunk_p], pmask[i:i + chunk_p])
             for i in range(0, P.shape[0], chunk_p)]
    return torch.cat(parts, dim=1)


def maxsim(Q, P, qmask, pmask, chunk_p: int = 128, impl: str = "auto",
           compute_dtype=None) -> torch.Tensor:
    """Dispatching MaxSim scorer (the JAX package's ``ops.maxsim.maxsim``).

    impl: ``'xla'`` -> :func:`maxsim_torch` (the name is the JAX
    package's); ``'pallas'`` -> the fused kernel op
    (``cuda_maxsim_train.MaxSimFn``: K1, or K5/K6 under autograd; on CPU
    tensors their plain versions); ``'auto'`` -> the kernel op on CUDA
    tensors and ``maxsim_torch`` on CPU ones, as JAX picks Pallas on the
    accelerator and XLA elsewhere. compute_dtype: the kernels' compute
    dtype; None keeps their default, bfloat16. Metric-bearing paths
    (evaluation, teacher precompute) pass torch.float32.
    """
    if impl not in ("xla", "pallas", "auto"):
        raise ValueError(f"impl must be 'xla', 'pallas' or 'auto', got "
                         f"{impl!r}")
    if impl == "xla" or (impl == "auto" and not Q.is_cuda):
        return maxsim_torch(Q, P, qmask, pmask, chunk_p=chunk_p)
    cd = torch.bfloat16 if compute_dtype is None else compute_dtype
    if torch.is_grad_enabled() and (Q.requires_grad or P.requires_grad):
        return MaxSimFn.apply(Q, P, qmask, pmask, cd)
    # no gradient can flow (grad mode off, or constant inputs): the primal,
    # K1, as JAX runs maxsim_pallas's primal outside differentiation
    return maxsim_cuda(Q, P, qmask, pmask, compute_dtype=cd)


# ---------------------------------------------------------------------------
# Legacy list-based APIs (parity with BaseVisualRetrieverProcessor,
# evaluator/retrieval.py:78-150): ragged python lists in, dense scores out.
# ---------------------------------------------------------------------------

def score_single_vector(qs: Sequence, ps: Sequence,
                        device="cuda") -> np.ndarray:
    """Single-vector dot-product scores (reference retrieval.py:78-99)."""
    if len(qs) == 0:
        raise ValueError("No queries provided")
    if len(ps) == 0:
        raise ValueError("No passages provided")
    q = torch.as_tensor(np.stack([np.asarray(x) for x in qs]),
                        dtype=torch.float32, device=device)
    p = torch.as_tensor(np.stack([np.asarray(x) for x in ps]),
                        dtype=torch.float32, device=device)
    return (q @ p.T).cpu().numpy()


def score_multi_vector(
    qs: Sequence,
    ps: Sequence,
    batch_size: int = 128,
    chunk_p: int = 128,
    impl: str = "auto",
    timing: Optional[list] = None,
    device="cuda",
) -> np.ndarray:
    """Ragged list-of-(Li,D) scorer (reference retrieval.py:101-150),
    each batch pair scored through :func:`maxsim` with ``impl``.

    The reference left-pads with zeros and does NOT mask them — a zero token's
    dot product is 0 which can exceed true max sims only if all sims < 0; we
    reproduce exact semantics by padding with zeros and treating all positions
    as valid (mask all-True), matching its einsum/max/sum behaviour.
    """
    if len(qs) == 0:
        raise ValueError("No queries provided")
    if len(ps) == 0:
        raise ValueError("No passages provided")

    def pad_left(seqs):
        seqs = [np.asarray(s, dtype=np.float32) for s in seqs]
        seqs = [s[None, :] if s.ndim == 1 else s for s in seqs]
        L = max(s.shape[0] for s in seqs)
        d = seqs[0].shape[-1]
        out = np.zeros((len(seqs), L, d), dtype=np.float32)
        for i, s in enumerate(seqs):
            # left padding (reference left_padding, retrieval.py:30-45);
            # position is irrelevant to max/sum but kept for parity.
            out[i, L - s.shape[0]:] = s
        return torch.as_tensor(out, device=device)

    rows = []
    for i in range(0, len(qs), batch_size):
        qb = pad_left(qs[i: i + batch_size])
        qm = torch.ones(qb.shape[:2], dtype=torch.bool, device=device)
        cols = []
        for j in range(0, len(ps), batch_size):
            pb = pad_left(ps[j: j + batch_size])
            pm = torch.ones(pb.shape[:2], dtype=torch.bool, device=device)
            # unmasked semantics: zero pad tokens participate in the max,
            # exactly like the reference's unmasked einsum (:136)
            t0 = time.perf_counter()
            sc = maxsim(qb, pb, qm, pm, chunk_p=chunk_p,
                        impl=impl).cpu().numpy()
            if timing is not None:
                # per-batch-pair wall time, host fetch included
                # (reference retrieval.py:135-145)
                timing.append(time.perf_counter() - t0)
            cols.append(sc)
        rows.append(np.concatenate(cols, axis=1))
    scores = np.concatenate(rows, axis=0)
    return scores.astype(np.float32)
