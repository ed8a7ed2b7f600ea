"""Fused masked MaxSim on the GPU: wrappers of the hand-written Hopper
kernels (``csrc/maxsim_bf16.cu``, ``csrc/maxsim_f32.cu``,
``csrc/maxsim_int8.cu``) and, beside each, its plain PyTorch version.

Counterpart of ``evdr_tpu/ops/pallas_maxsim.py``'s forward kernels:

- ``maxsim_cuda`` (K1): float/bf16 index, scored in bf16 with f32
  accumulation (a float32 index is cast to bf16 per call, as the TPU
  kernel's driver does); ``compute_dtype=torch.float32`` hands the call to
  ``maxsim_cuda_f32``.
- ``maxsim_cuda_f32`` (K1, float32 mode, the TPU kernel's
  ``compute_dtype=float32``): split-TF32 products with f32 accumulation,
  the scorer of the trainer's evaluation and teacher precompute.
- ``maxsim_cuda_int8`` (K2, int8 mode): bf16 queries x int8 codes.
- ``maxsim_cuda_int8full`` (K2, int8full mode): queries quantized per token
  on the device (``quantize_queries_int8``), int8 x int8 -> int32.

Routing: a wrapper given CUDA tensors launches its kernel or raises; given
CPU tensors it returns its plain version. There is no other fallback.
Each wrapper counts its launches in a plain integer attribute
(``maxsim_cuda.launches`` ...), raised by one exactly where it launches.

The plain versions reproduce the kernels' numerics: bf16 casts of the
inputs, f32 sums, the -1e30 fill of an invalid doc token, the rule that a
doc whose max stayed below -1e29 (no valid token) scores 0, the -1 scale
sentinel (a valid token with scale 0 scores 0 and is not masked) and the
same query quantization. They differ from the kernels only in summation
order. On a GPU they need full-precision f32 matmuls (no TF32).
"""

from __future__ import annotations

import torch

from evdr_tpu_torch.ops import _cuda_build

NEG_INIT = -1e30   # an invalid doc token's similarity
NEG_THRESH = -1e29  # a running max below this: the doc had no valid token

# rows x columns of the similarity block one plain chunk materializes
_PLAIN_CHUNK_ELEMS = 1 << 27


def quantize_queries_int8(Q: torch.Tensor, qmask: torch.Tensor):
    """Per-query-token symmetric int8 quantization, as
    ``maxsim_pallas_int8full`` does on the TPU: s = amax/127, codes =
    round-half-even(Q / s) clipped to +-127. Returns (codes int8, the
    post-max weight qmask * s as f32)."""
    Qf = Q.float()
    sq = Qf.abs().amax(dim=-1) / 127.0
    safe = torch.where(sq > 0, sq, torch.ones_like(sq))
    codes = torch.round(Qf / safe[..., None]).clamp_(-127, 127).to(torch.int8)
    return codes, qmask.float() * sq


# ----------------------------------------------------------------- plain


def plain_sims(Qf, P, p_dtype, tok_scale):
    """Yield ``(i, Pc, sim)`` over doc chunks: Pc = ``P[i:i+c]`` seen as
    ``.to(p_dtype).float()``; sim (nq * Lq, c, Lp) f32, the masked, scaled
    similarities (-1e30 at an invalid token). Qf (nq, Lq, D) f32 holds the
    values the kernel multiplies; tok_scale (nd, Lp): a scale >= 0
    multiplies the similarity, -1 marks an invalid token. The chunking
    depends only on the shapes, so two calls on the same inputs give
    bit-identical similarities (the plain K5/K6 pair relies on it)."""
    if Qf.is_cuda and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("the plain MaxSim versions need full-precision "
                           "f32 matmuls; set torch.set_float32_matmul_"
                           "precision('highest')")
    nq, lq, d = Qf.shape
    nd, lp, _ = P.shape
    rows = Qf.reshape(nq * lq, d)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // (nq * lq * lp))
    for i in range(0, nd, chunk):
        Pc = P[i:i + chunk].to(p_dtype).float()
        c = Pc.shape[0]
        sim = (rows @ Pc.reshape(c * lp, d).T).view(nq * lq, c, lp)
        sc = tok_scale[i:i + chunk]
        yield i, Pc, torch.where(sc >= 0, sim * sc, NEG_INIT)


def _plain_core(Qf, qw, P, p_dtype, tok_scale, want_m=False):
    """Chunked masked MaxSim -> (nq, nd) f32 (see :func:`plain_sims`);
    qw (nq, Lq) post-max weights. ``want_m`` also returns M (nq * Lq, nd),
    each row's raw max before the no-valid-token rule (K5's residual)."""
    nq, lq, _ = Qf.shape
    nd = P.shape[0]
    out = torch.empty((nq, nd), dtype=torch.float32, device=Qf.device)
    M = (torch.empty((nq * lq, nd), dtype=torch.float32, device=Qf.device)
         if want_m else None)
    for i, Pc, sim in plain_sims(Qf, P, p_dtype, tok_scale):
        c = Pc.shape[0]
        mx = sim.amax(dim=-1)
        if want_m:
            M[:, i:i + c] = mx
        mx = torch.where(mx > NEG_THRESH, mx, 0.0)
        out[:, i:i + c] = (mx.view(nq, lq, c) * qw[..., None]).sum(dim=1)
    return (out, M) if want_m else out


def mask_sentinel(pmask, scales=None):
    valid = pmask.bool()
    s = torch.ones_like(valid, dtype=torch.float32) if scales is None \
        else scales.float()
    return torch.where(valid, s, -1.0)


def maxsim_plain(Q, P, qmask, pmask, compute=torch.bfloat16):
    """Plain version of K1: (nq, nd) f32. ``compute=torch.float32`` scores
    at full precision (the TPU kernel's ``compute_dtype=float32``)."""
    return _plain_core(Q.to(compute).float(), qmask.float(), P, compute,
                       mask_sentinel(pmask))


def maxsim_int8_plain(Q, P_i8, scales, qmask, pmask,
                      compute=torch.bfloat16):
    """Plain version of K2 in int8 mode: queries in ``compute``, codes
    exact, page scale applied before the max."""
    return _plain_core(Q.to(compute).float(), qmask.float(), P_i8,
                       torch.float32, mask_sentinel(pmask, scales))


def maxsim_int8full_plain(Q, P_i8, scales, qmask, pmask):
    """Plain version of K2 in int8full mode. The int8 x int8 dot products
    are exact in f32 (|sum| <= 127 * 127 * D < 2**24 for D <= 1040)."""
    Q_i8, qw = quantize_queries_int8(Q, qmask)
    return _plain_core(Q_i8.float(), qw, P_i8, torch.float32,
                       mask_sentinel(pmask, scales))


# --------------------------------------------------------------- kernels


def _on_cuda(*tensors) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"MaxSim inputs must share one device, got "
                     f"{sorted(str(t.device) for t in tensors)}")


def _check_shapes(Q, P, qmask, pmask, scales=None):
    if Q.dim() != 3 or P.dim() != 3:
        raise ValueError(f"Q and P must be 3-D, got {tuple(Q.shape)} and "
                         f"{tuple(P.shape)}")
    nq, lq, d = Q.shape
    nd, lp, dp = P.shape
    if dp != d:
        raise ValueError(f"query dim {d} != page dim {dp}")
    if tuple(qmask.shape) != (nq, lq) or tuple(pmask.shape) != (nd, lp):
        raise ValueError("mask shapes do not match Q / P")
    if scales is not None and tuple(scales.shape) != (nd, lp):
        raise ValueError(f"scales shape {tuple(scales.shape)} != {(nd, lp)}")
    if pmask.dtype != torch.bool:
        raise TypeError(f"pmask must be bool, got {pmask.dtype}")
    if lq > 128:
        raise ValueError(f"the kernels take at most 128 tokens per query, "
                         f"got {lq}")
    if d % 16 or not 16 <= d <= 256:
        raise ValueError(f"the kernels take D a multiple of 16 in [16, 256], "
                         f"got {d}")
    for name, t in (("P", P), ("pmask", pmask), ("scales", scales)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nq == 0 or nd == 0 or lp == 0:
        raise ValueError("empty MaxSim input")


def call_kernel(lib, func, operands, *args, aligned=()):
    """Launch ``func`` of library ``lib`` on the current stream of the
    operands' device: ``operands`` are tensors passed as pointers (None
    entries are skipped), then the ints ``args``. The tensors in
    ``aligned`` (those the kernel reads 16 bytes at a time) must be 16-byte
    aligned. Raises if the launch is refused."""
    for t in aligned:
        if t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")
    fn = _cuda_build.kernel(lib, func)
    dev = operands[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in operands if t is not None), *args,
                stream)
    if rc != 0:
        raise RuntimeError(f"{func} launch failed: cudaError {rc}")


def _launch(lib, func, q, qw, P, scales, pmask, nq, lq, nd, lp, d):
    out = torch.empty((nq, nd), dtype=torch.float32, device=q.device)
    call_kernel(lib, func, (q, qw, P, scales, pmask, out), nq, lq, nd, lp, d,
                aligned=(q, P))
    return out


def maxsim_cuda(Q, P, qmask, pmask, compute_dtype=torch.bfloat16):
    """K1: fused MaxSim of (nq, Lq, D) queries against a bf16 (or float32,
    cast per call) (nd, Lp, D) index -> (nq, nd) f32. ``compute_dtype``
    torch.float32 scores at float32 precision (``maxsim_cuda_f32``)."""
    if compute_dtype == torch.float32:
        return maxsim_cuda_f32(Q, P, qmask, pmask)
    if compute_dtype != torch.bfloat16:
        raise TypeError(f"K1 computes in bfloat16 or float32, got "
                        f"{compute_dtype}")
    if not _on_cuda(Q, P, qmask, pmask):
        return maxsim_plain(Q, P, qmask, pmask)
    _check_shapes(Q, P, qmask, pmask)
    if P.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K1 takes a bf16 or f32 index, got {P.dtype}")
    nq, lq, d = Q.shape
    nd, lp, _ = P.shape
    out = _launch("maxsim_bf16", "evdr_maxsim_bf16",
                  Q.to(torch.bfloat16).contiguous(),
                  qmask.float().contiguous(), P.to(torch.bfloat16), None,
                  pmask, nq, lq, nd, lp, d)
    maxsim_cuda.launches += 1
    return out


F32_MAX_D = 192  # the f32 query block and two page tiles in shared memory


def maxsim_cuda_f32(Q, P, qmask, pmask):
    """K1 in float32 mode (split-TF32 products, f32 sums): (nq, Lq, D)
    queries against a float32 or bf16 (upcast exactly) (nd, Lp, D) index
    -> (nq, nd) f32."""
    if not _on_cuda(Q, P, qmask, pmask):
        return maxsim_plain(Q, P, qmask, pmask, compute=torch.float32)
    _check_shapes(Q, P, qmask, pmask)
    if P.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K1 takes a bf16 or f32 index, got {P.dtype}")
    nq, lq, d = Q.shape
    nd, lp, _ = P.shape
    if d > F32_MAX_D:
        raise ValueError(f"K1's float32 mode takes D <= {F32_MAX_D}, got {d}")
    out = _launch("maxsim_f32", "evdr_maxsim_f32", Q.float().contiguous(),
                  qmask.float().contiguous(), P.float().contiguous(), None,
                  pmask, nq, lq, nd, lp, d)
    maxsim_cuda_f32.launches += 1
    return out


def _check_int8(P_i8, scales):
    if P_i8.dtype != torch.int8:
        raise TypeError(f"K2 takes int8 codes, got {P_i8.dtype}")
    if scales.dtype != torch.float32:
        raise TypeError(f"K2 takes f32 scales, got {scales.dtype}")


def maxsim_cuda_int8(Q, P_i8, scales, qmask, pmask):
    """K2, int8 mode: bf16 queries x int8 codes with per-token scales."""
    if not _on_cuda(Q, P_i8, scales, qmask, pmask):
        return maxsim_int8_plain(Q, P_i8, scales, qmask, pmask)
    _check_shapes(Q, P_i8, qmask, pmask, scales)
    _check_int8(P_i8, scales)
    nq, lq, d = Q.shape
    nd, lp, _ = P_i8.shape
    out = _launch("maxsim_int8", "evdr_maxsim_int8",
                  Q.to(torch.bfloat16).contiguous(),
                  qmask.float().contiguous(), P_i8, scales, pmask,
                  nq, lq, nd, lp, d)
    maxsim_cuda_int8.launches += 1
    return out


def maxsim_cuda_int8full(Q, P_i8, scales, qmask, pmask):
    """K2, int8full mode: queries quantized per token on the device, then
    int8 x int8 -> int32 on the tensor cores."""
    if not _on_cuda(Q, P_i8, scales, qmask, pmask):
        return maxsim_int8full_plain(Q, P_i8, scales, qmask, pmask)
    _check_shapes(Q, P_i8, qmask, pmask, scales)
    _check_int8(P_i8, scales)
    nq, lq, d = Q.shape
    nd, lp, _ = P_i8.shape
    Q_i8, qw = quantize_queries_int8(Q, qmask)
    out = _launch("maxsim_int8", "evdr_maxsim_int8full", Q_i8.contiguous(),
                  qw.contiguous(), P_i8, scales, pmask, nq, lq, nd, lp, d)
    maxsim_cuda_int8full.launches += 1
    return out


KERNEL_WRAPPERS = (maxsim_cuda, maxsim_cuda_f32, maxsim_cuda_int8,
                   maxsim_cuda_int8full)
for _w in KERNEL_WRAPPERS:
    _w.launches = 0


def reset_launch_counts() -> None:
    """Zero the launch counts of every kernel wrapper of the port (this
    module's and ``cuda_maxsim_train``'s)."""
    for w in all_wrappers():
        w.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in all_wrappers()}


def all_wrappers() -> tuple:
    from evdr_tpu_torch.ops import cuda_maxsim_train

    return KERNEL_WRAPPERS + cuda_maxsim_train.KERNEL_WRAPPERS
