"""The differentiable MaxSim op: K5 (forward for training) and K6
(backward) on the GPU, their plain PyTorch versions, and ``MaxSimFn``.

Counterpart of ``maxsim_pallas``'s ``custom_vjp``
(``evdr_tpu/ops/pallas_maxsim.py:597-641`` with the fused backward of
``evdr_tpu/ops/pallas_maxsim_bwd.py``):

- ``maxsim_cuda_fwd_train`` (K5, ``csrc/maxsim_train.cu``): K1's scores
  plus M, each query-token row's max over each doc's tokens, (nq * Lq, nd)
  f32, the residual the backward compares against.
- ``maxsim_cuda_bwd`` (K6, ``csrc/maxsim_train.cu``): recomputes every
  similarity bit for bit as K5 did, E = (sim == M) * W with W = g * qmask *
  doc_has_token rounded to the compute dtype, dQ = sum E * P and dP = sum
  E * Q. The gradient is SUMMED over tied argmax tokens, as on the TPU
  (``pallas_maxsim_bwd.py:18-20``); ``torch.amax``'s autograd splits it
  evenly, so the plain version is written in the indicator form, not as
  autograd of ``maxsim_torch``.
- ``compute_dtype=torch.float32`` (the TPU kernels at Precision.HIGHEST)
  hands both to their float32 modes, ``maxsim_cuda_fwd_train_f32`` (K1's
  float32 tile with the M store) and ``maxsim_cuda_bwd_f32`` (3xTF32
  gradient products, E kept in f32), each with its own launch count.
- ``MaxSimFn``: forward K5 when Q or P needs a gradient, else K1 (with
  ``compute_dtype`` float32 K1's float32 mode); backward K6; the gradients
  come back in Q's and P's dtypes (``pallas_maxsim.py:635``).

Routing as in ``cuda_maxsim``: CUDA tensors launch the kernel or raise,
CPU tensors take the plain version.
"""

from __future__ import annotations

import torch

from evdr_tpu_torch.ops.cuda_maxsim import (F32_MAX_D, _check_shapes,
                                            _on_cuda, _plain_core,
                                            call_kernel, mask_sentinel,
                                            maxsim_cuda, plain_sims)

# Above this many 128-row query blocks the backward chunks the query axis,
# so the per-query-block dP partials stay under 8 x |dP| (as the TPU's
# _MAX_QB_BLOCKS, pallas_maxsim_bwd.py:213)
MAX_QB_BLOCKS = 8
K6_MAX_D = 128
_ROWS = 128  # query-token rows per CTA (maxsim_tile.cuh kRows)
_TARGET_CTAS = 264  # two waves of the H100's 132 SMs


# ----------------------------------------------------------------- plain


def maxsim_fwd_train_plain(Q, P, qmask, pmask, compute=torch.bfloat16):
    """Plain version of K5: (scores (nq, nd) f32, M (nq * Lq, nd) f32)."""
    return _plain_core(Q.to(compute).float(), qmask.float(), P, compute,
                       mask_sentinel(pmask), want_m=True)


def maxsim_bwd_plain(Q, P, qmask, pmask, M, g, compute=torch.bfloat16):
    """Plain version of K6 in the indicator form: (dQ (nq, Lq, D) f32,
    dP (nd, Lp, D) f32). ``M`` must come from :func:`maxsim_fwd_train_plain`
    on the same inputs (its similarities are recomputed bit for bit)."""
    Qf = Q.to(compute).float()
    nq, lq, d = Qf.shape
    nd, lp, _ = P.shape
    rows = Qf.reshape(nq * lq, d)
    has = pmask.bool().any(dim=-1).float()
    W = ((g.float() * has[None, :])[:, None, :]
         * qmask.float()[:, :, None]).reshape(nq * lq, nd)
    dQ = torch.zeros_like(rows)
    dP = torch.empty((nd, lp, d), dtype=torch.float32, device=Qf.device)
    for i, Pc, sim in plain_sims(Qf, P, compute, mask_sentinel(pmask)):
        c = Pc.shape[0]
        E = torch.where(sim == M[:, i:i + c, None], W[:, i:i + c, None], 0.0)
        E = E.to(compute).float().reshape(nq * lq, c * lp)
        dQ += E @ Pc.reshape(c * lp, d)
        dP[i:i + c] = (E.T @ rows).view(c, lp, d)
    return dQ.view(nq, lq, d), dP


# --------------------------------------------------------------- kernels


def _check_compute(compute_dtype):
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K5/K6 compute in bfloat16 or float32, got "
                        f"{compute_dtype}")


def _fwd_train(func, dtype, Q, P, qmask, pmask):
    _check_shapes(Q, P, qmask, pmask)
    nq, lq, d = Q.shape
    nd, lp, _ = P.shape
    q = Q.to(dtype).contiguous()
    p = P.to(dtype).contiguous()
    out = torch.empty((nq, nd), dtype=torch.float32, device=Q.device)
    M = torch.empty((nq * lq, nd), dtype=torch.float32, device=Q.device)
    call_kernel("maxsim_train", func,
                (q, qmask.float().contiguous(), p, pmask, out, M),
                nq, lq, nd, lp, d, aligned=(q, p))
    return out, M


def maxsim_cuda_fwd_train(Q, P, qmask, pmask, compute_dtype=torch.bfloat16):
    """K5: (scores (nq, nd) f32, M (nq * Lq, nd) f32). ``compute_dtype``
    torch.float32 runs its float32 mode (:func:`maxsim_cuda_fwd_train_f32`)."""
    _check_compute(compute_dtype)
    if compute_dtype == torch.float32:
        return maxsim_cuda_fwd_train_f32(Q, P, qmask, pmask)
    if not _on_cuda(Q, P, qmask, pmask):
        return maxsim_fwd_train_plain(Q, P, qmask, pmask, torch.bfloat16)
    out, M = _fwd_train("evdr_maxsim_fwd_train", torch.bfloat16, Q, P, qmask,
                        pmask)
    maxsim_cuda_fwd_train.launches += 1
    return out, M


def maxsim_cuda_fwd_train_f32(Q, P, qmask, pmask):
    """K5 in float32 mode: K1's float32 scores (split-TF32 products, bit for
    bit) and M from the same similarities."""
    if not _on_cuda(Q, P, qmask, pmask):
        return maxsim_fwd_train_plain(Q, P, qmask, pmask, torch.float32)
    if Q.shape[-1] > F32_MAX_D:
        raise ValueError(f"K5's float32 mode takes D <= {F32_MAX_D}, got "
                         f"{Q.shape[-1]}")
    out, M = _fwd_train("evdr_maxsim_fwd_train_f32", torch.float32, Q, P,
                        qmask, pmask)
    maxsim_cuda_fwd_train_f32.launches += 1
    return out, M


def maxsim_cuda_bwd(Q, P, qmask, pmask, M, g, compute_dtype=torch.bfloat16):
    """K6: (dQ (nq, Lq, D) f32, dP (nd, Lp, D) f32) for the upstream
    gradient ``g`` (nq, nd) and K5's ``M``. ``compute_dtype`` torch.float32
    runs its float32 mode (:func:`maxsim_cuda_bwd_f32`)."""
    _check_compute(compute_dtype)
    if compute_dtype == torch.float32:
        return maxsim_cuda_bwd_f32(Q, P, qmask, pmask, M, g)
    if not _on_cuda(Q, P, qmask, pmask, M, g):
        return maxsim_bwd_plain(Q, P, qmask, pmask, M, g, torch.bfloat16)
    return _bwd(maxsim_cuda_bwd, "evdr_maxsim_bwd", torch.bfloat16, Q, P,
                qmask, pmask, M, g)


def maxsim_cuda_bwd_f32(Q, P, qmask, pmask, M, g):
    """K6 in float32 mode: E in f32, dQ and dP in 3xTF32 against the M of
    :func:`maxsim_cuda_fwd_train_f32`."""
    if not _on_cuda(Q, P, qmask, pmask, M, g):
        return maxsim_bwd_plain(Q, P, qmask, pmask, M, g, torch.float32)
    return _bwd(maxsim_cuda_bwd_f32, "evdr_maxsim_bwd_f32", torch.float32, Q,
                P, qmask, pmask, M, g)


def _bwd(wrapper, func, dtype, Q, P, qmask, pmask, M, g):
    """K6's host side for either mode: checks, the query-axis chunking, the
    partial buffers, the launch (counted on ``wrapper``), the partials'
    sums."""
    _check_shapes(Q, P, qmask, pmask)
    nq, lq, d = Q.shape
    nd, lp, _ = P.shape
    if d % 32 or d > K6_MAX_D:
        raise ValueError(f"K6 takes D a multiple of 32 up to {K6_MAX_D}, "
                         f"got {d}")
    if tuple(M.shape) != (nq * lq, nd) or tuple(g.shape) != (nq, nd):
        raise ValueError("M or g does not match Q / P")
    qb = _ROWS // lq
    n_qb = -(-nq // qb)
    if n_qb > MAX_QB_BLOCKS:
        step = MAX_QB_BLOCKS * qb
        dQs, dP = [], None
        for s in range(0, nq, step):
            e = min(s + step, nq)
            dq_c, dp_c = wrapper(Q[s:e], P, qmask[s:e], pmask,
                                 M[s * lq:e * lq], g[s:e])
            dQs.append(dq_c)
            dP = dp_c if dP is None else dP + dp_c
        return torch.cat(dQs), dP
    q = Q.to(dtype).contiguous()
    p = P.to(dtype).contiguous()
    has = pmask.any(dim=-1).float()
    g2 = (g.float() * has[None, :]).contiguous()
    n_slices = max(1, min(nd, -(-_TARGET_CTAS // n_qb)))
    db = -(-nd // n_slices)
    n_slices = -(-nd // db)
    dq_part = torch.empty((n_slices, nq * lq, d), dtype=torch.float32,
                          device=Q.device)
    dp_part = torch.empty((n_qb, nd, lp, d), dtype=torch.float32,
                          device=Q.device)
    call_kernel("maxsim_train", func,
                (q, qmask.float().contiguous(), p, pmask,
                 M.float().contiguous(), g2, dq_part, dp_part),
                nq, lq, nd, lp, d, db, aligned=(q, p))
    wrapper.launches += 1
    # the partials' sums, in a fixed order (no atomics)
    dQ = dq_part.sum(dim=0) if n_slices > 1 else dq_part[0]
    dP = dp_part.sum(dim=0) if n_qb > 1 else dp_part[0]
    return dQ.view(nq, lq, d), dP


class MaxSimFn(torch.autograd.Function):
    """Differentiable fused MaxSim: ``MaxSimFn.apply(Q, P, qmask, pmask,
    compute_dtype)`` -> (nq, nd) f32 scores."""

    @staticmethod
    def forward(ctx, Q, P, qmask, pmask, compute_dtype=torch.bfloat16):
        ctx.compute_dtype = compute_dtype
        if any(ctx.needs_input_grad[:2]):
            out, M = maxsim_cuda_fwd_train(Q, P, qmask, pmask, compute_dtype)
            ctx.save_for_backward(Q, P, qmask, pmask, M)
            return out
        return maxsim_cuda(Q, P, qmask, pmask, compute_dtype=compute_dtype)

    @staticmethod
    def backward(ctx, g):
        Q, P, qmask, pmask, M = ctx.saved_tensors
        dQ, dP = maxsim_cuda_bwd(Q, P, qmask, pmask, M, g, ctx.compute_dtype)
        return dQ.to(Q.dtype), dP.to(P.dtype), None, None, None


KERNEL_WRAPPERS = (maxsim_cuda_fwd_train, maxsim_cuda_fwd_train_f32,
                   maxsim_cuda_bwd, maxsim_cuda_bwd_f32)
for _w in KERNEL_WRAPPERS:
    _w.launches = 0
