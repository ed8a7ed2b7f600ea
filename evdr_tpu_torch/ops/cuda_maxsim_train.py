"""The differentiable MaxSim op: K5 (forward for training) and K6
(backward) on the GPU, their plain PyTorch versions, and ``MaxSimFn``.

Counterpart of ``maxsim_pallas``'s ``custom_vjp``
(``evdr_tpu/ops/pallas_maxsim.py:597-641`` with the fused backward of
``evdr_tpu/ops/pallas_maxsim_bwd.py``):

- ``maxsim_cuda_fwd_train`` (K5, ``csrc/maxsim_bf16.cu``): K1's kernel
  with an M store, so K1's scores bit for bit plus M, each query-token
  row's max over each doc's tokens, (nq * Lq, nd) f32, the residual the
  backward compares against. It runs 64-token page tiles at every D, the
  tiles K6 recomputes.
- ``maxsim_cuda_bwd`` (K6, ``csrc/maxsim_train.cu``): recomputes every
  similarity bit for bit as K5 did (bf16: K5's wgmma products), E = (sim
  == M) * W with W = g * qmask * doc_has_token rounded to the compute
  dtype, dQ = sum E * P and dP = sum E * Q, over E's nonzeros only (the
  hits), a chunk's query blocks in one thread-block cluster that sums each
  tile's dP once. The gradient is
  SUMMED over tied argmax tokens, as on the TPU
  (``pallas_maxsim_bwd.py:18-20``); ``torch.amax``'s autograd splits it
  evenly, so the plain version is written in the indicator form, not as
  autograd of ``maxsim_torch``.
- ``compute_dtype=torch.float32`` (the TPU kernels at Precision.HIGHEST)
  hands both to their float32 modes, ``maxsim_cuda_fwd_train_f32`` (K1's
  float32 kernel with the M store, ``csrc/maxsim_f32.cu``) and
  ``maxsim_cuda_bwd_f32`` (E kept in f32, exact f32 products of the hits),
  each with its own launch count.
- Every D: above K1's fast bound (256; float32 192) K5 and K6 run their
  wide functions (``*_wide``): K5 the D-chunked loop of
  ``csrc/maxsim_wide.cuh`` with the M store (the wide K1's scores bit for
  bit), K6 a recompute with the same products in D chunks, then dQ and dP
  walked over D in chunks of 256 columns (``csrc/maxsim_train.cu``).
- ``MaxSimFn``: forward K5 when Q or P needs a gradient, else K1 (with
  ``compute_dtype`` float32 K1's float32 mode); backward K6; the gradients
  come back in Q's and P's dtypes (``pallas_maxsim.py:635``).

Routing as in ``cuda_maxsim``: CUDA tensors launch the kernel or raise,
CPU tensors take the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from evdr_tpu_torch.ops import _cuda_build
from evdr_tpu_torch.ops.cuda_maxsim import (ROW_CAP, _check_shapes, _count,
                                            _on_cuda, _plain_core,
                                            call_kernel, is_wide, kernel_dim,
                                            kernel_func, mask_sentinel,
                                            maxsim_cuda, pad_dim, plain_sims,
                                            row_cap, split_queries)

# Above this many query blocks the backward chunks the query axis (as the
# TPU's _MAX_QB_BLOCKS, pallas_maxsim_bwd.py:213); a chunk's query blocks
# form one thread-block cluster of K6 (8: the portable cluster size), which
# writes each dP once
MAX_QB_BLOCKS = 8
_ROWS = ROW_CAP["maxsim_train"]  # K6's query-token rows per CTA


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


def _fwd_train(wrapper, lib, func, dtype, Q, P, qmask, pmask):
    """K5's host side, K1's slicing (so its scores stay K1's bit for bit):
    D zero-padded to the granule, one launch per slice of at most
    ``row_cap(lib, D)`` query tokens, each with its own rows of M; the
    slices' scores add up. Above K1's fast bound, the wide function."""
    _check_shapes(Q, P, qmask, pmask)
    nq, lq, d = Q.shape
    nd, lp, _ = P.shape
    dk = kernel_dim(d)
    func = kernel_func(func, dk)
    q = pad_dim(Q.to(dtype), dk)
    p = pad_dim(P.to(dtype), dk).contiguous()
    Ms = []

    def one(qs, qws):
        qs, ls = qs.contiguous(), qs.shape[1]
        out = torch.empty((nq, nd), dtype=torch.float32, device=Q.device)
        M = torch.empty((nq * ls, nd), dtype=torch.float32, device=Q.device)
        call_kernel(lib, func, (qs, qws.contiguous(), p, pmask, out, M),
                    nq, ls, nd, lp, dk, aligned=(qs, p))
        _count(wrapper, func, nq, ls, nd, lp)
        Ms.append(M.view(nq, ls, nd))
        return out

    out = split_queries(one, q, qmask.float(), row_cap(lib, dk))
    M = Ms[0] if len(Ms) == 1 else torch.cat(Ms, dim=1)
    return out, M.reshape(nq * lq, nd)


def maxsim_cuda_fwd_train(Q, P, qmask, pmask, compute_dtype=torch.bfloat16):
    """K5: (scores (nq, nd) f32, M (nq * Lq, nd) f32). ``compute_dtype``
    torch.float32 runs its float32 mode (:func:`maxsim_cuda_fwd_train_f32`)."""
    _check_compute(compute_dtype)
    if compute_dtype == torch.float32:
        return maxsim_cuda_fwd_train_f32(Q, P, qmask, pmask)
    if not _on_cuda(Q, P, qmask, pmask):
        return maxsim_fwd_train_plain(Q, P, qmask, pmask, torch.bfloat16)
    return _fwd_train(maxsim_cuda_fwd_train, "maxsim_bf16",
                      "evdr_maxsim_fwd_train", torch.bfloat16, Q, P, qmask,
                      pmask)


def maxsim_cuda_fwd_train_f32(Q, P, qmask, pmask):
    """K5 in float32 mode: K1's float32 scores (split-TF32 products, bit for
    bit) and M from the same similarities."""
    if not _on_cuda(Q, P, qmask, pmask):
        return maxsim_fwd_train_plain(Q, P, qmask, pmask, torch.float32)
    return _fwd_train(maxsim_cuda_fwd_train_f32, "maxsim_f32",
                      "evdr_maxsim_fwd_train_f32", torch.float32, Q, P, qmask,
                      pmask)


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
    """K6 in float32 mode: E in f32, the hits' products in f32, against the
    M of :func:`maxsim_cuda_fwd_train_f32`."""
    if not _on_cuda(Q, P, qmask, pmask, M, g):
        return maxsim_bwd_plain(Q, P, qmask, pmask, M, g, torch.float32)
    return _bwd(maxsim_cuda_bwd_f32, "evdr_maxsim_bwd_f32", torch.float32, Q,
                P, qmask, pmask, M, g)


def bwd_cluster(n_qb: int) -> int:
    """K6's cluster size for a chunk of ``n_qb`` (<= MAX_QB_BLOCKS) query
    blocks: the smallest power of two that holds them (the launcher pads
    grid x with CTAs that have no rows)."""
    c = 1
    while c < n_qb:
        c *= 2
    return c


_bwd_configs: dict = {}


def bwd_config(dtype, d: int, cluster: int) -> dict:
    """The configuration K6 runs at kernel width ``d`` in clusters of
    ``cluster`` CTAs, on the current GPU: CTAs per SM, clusters the card
    holds at once, ring stages, shared bytes, page tiles a cluster
    barrier."""
    key = (dtype, d, cluster, torch.cuda.current_device())
    if key not in _bwd_configs:
        out = (ctypes.c_int * 5)()
        rc = _cuda_build.kernel("maxsim_train", "evdr_bwd_config")(
            int(dtype == torch.float32), d, cluster, ctypes.addressof(out))
        if rc != 0:
            raise RuntimeError(f"evdr_bwd_config failed: cudaError {rc}")
        _bwd_configs[key] = dict(zip(("ctas_per_sm", "clusters", "stages",
                                      "smem_bytes", "tiles_a_barrier"), out))
    return _bwd_configs[key]


def _bwd(wrapper, func, dtype, Q, P, qmask, pmask, M, g):
    """K6's host side for either mode: checks; D zero-padded to the granule
    (the pad columns of dQ and dP dropped at the end); above K5's fast
    bound :func:`_bwd_wide`; else queries longer than _ROWS tokens in
    slices, each with its rows of M, their dQ slices concatenated and their
    dP summed; then :func:`_bwd_launch`."""
    _check_shapes(Q, P, qmask, pmask)
    nq, lq, d = Q.shape
    nd = P.shape[0]
    dk = kernel_dim(d)
    if tuple(M.shape) != (nq * lq, nd) or tuple(g.shape) != (nq, nd):
        raise ValueError("M or g does not match Q / P")
    Qk, Pk = pad_dim(Q, dk), pad_dim(P, dk).contiguous()
    if is_wide(func, dk):
        dQ, dP = _bwd_wide(wrapper, func + "_wide", dtype, Qk, Pk, qmask,
                           pmask, M, g)
        return dQ[..., :d], dP[..., :d]
    M3 = M.view(nq, lq, nd)
    dQs, dP = [], None
    for s in range(0, lq, _ROWS):
        e = min(s + _ROWS, lq)
        dq_s, dp_s = _bwd_launch(wrapper, func, dtype, Qk[:, s:e], Pk,
                                 qmask[:, s:e], pmask,
                                 M3[:, s:e].reshape(nq * (e - s), nd), g)
        dQs.append(dq_s)
        dP = dp_s if dP is None else dP + dp_s
    dQ = dQs[0] if len(dQs) == 1 else torch.cat(dQs, dim=1)
    return dQ[..., :d], dP[..., :d]


def _bwd_launch(wrapper, func, dtype, Q, P, qmask, pmask, M, g):
    """One K6 pass at Lq <= _ROWS and D at the kernel's width: the
    query-axis chunking (MAX_QB_BLOCKS blocks a launch, their dP added
    here), the cluster size, the doc slices (one wave of clusters on the
    card, from :func:`bwd_config`), the launch (counted on ``wrapper``),
    the dQ partials' sum."""
    nq, lq, d = Q.shape
    nd, lp, _ = P.shape
    qb = _ROWS // lq
    n_qb = -(-nq // qb)
    if n_qb > MAX_QB_BLOCKS:
        step = MAX_QB_BLOCKS * qb
        dQs, dP = [], None
        for s in range(0, nq, step):
            e = min(s + step, nq)
            dq_c, dp_c = _bwd_launch(wrapper, func, dtype, Q[s:e], P,
                                     qmask[s:e], pmask, M[s * lq:e * lq],
                                     g[s:e])
            dQs.append(dq_c)
            dP = dp_c if dP is None else dP + dp_c
        return torch.cat(dQs), dP
    q = Q.to(dtype).contiguous()
    p = P.to(dtype).contiguous()
    has = pmask.any(dim=-1).float()
    g2 = (g.float() * has[None, :]).contiguous()
    cluster = bwd_cluster(n_qb)
    n_groups = -(-n_qb // cluster)
    # doc slices: one wave of the clusters the card holds at once
    per_group = bwd_config(dtype, d, cluster)["clusters"] // n_groups
    db = -(-nd // max(1, min(nd, per_group)))
    n_slices = -(-nd // db)
    dq_part = torch.empty((n_slices, nq * lq, d), dtype=torch.float32,
                          device=Q.device)
    dp = torch.empty((n_groups, nd, lp, d), dtype=torch.float32,
                     device=Q.device)
    call_kernel("maxsim_train", func,
                (q, qmask.float().contiguous(), p, pmask,
                 M.float().contiguous(), g2, dq_part, dp),
                nq, lq, nd, lp, d, db, cluster, aligned=(q, p))
    _count(wrapper, func, nq, lq, nd, lp)
    # the partials' sums, in a fixed order (no atomics)
    dQ = dq_part.sum(dim=0) if n_slices > 1 else dq_part[0]
    dP = dp.sum(dim=0) if n_groups > 1 else dp[0]
    return dQ.view(nq, lq, d), dP


def _bwd_wide(wrapper, func, dtype, Q, P, qmask, pmask, M, g):
    """The wide K6, one launch for every query token at once: its hit
    masks (rowbits, colbits: every word written by the kernel), then dQ
    and dP, each element summed by one thread in a fixed order."""
    nq, lq, d = Q.shape
    nd, lp, _ = P.shape
    nrows = nq * lq
    q = Q.to(dtype).contiguous()
    p = P.to(dtype).contiguous()
    has = pmask.any(dim=-1).float()
    g2 = (g.float() * has[None, :]).contiguous()
    dev = Q.device
    rowbits = torch.empty((nrows, nd, -(-lp // 64), 2), dtype=torch.int32,
                          device=dev)
    colbits = torch.empty((nd * lp, -(-nrows // 32)), dtype=torch.int32,
                          device=dev)
    dq = torch.empty((nrows, d), dtype=torch.float32, device=dev)
    dp = torch.empty((nd, lp, d), dtype=torch.float32, device=dev)
    call_kernel("maxsim_train", func,
                (q, qmask.float().contiguous(), p, pmask,
                 M.float().contiguous(), g2, rowbits, colbits, dq, dp),
                nq, lq, nd, lp, d, aligned=(q, p))
    _count(wrapper, func, nq, lq, nd, lp)
    return dq.view(nq, lq, d), dp


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
