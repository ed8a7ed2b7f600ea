"""Per-token symmetric int4 quantization: the half-of-int8 storage tier.

Counterpart of ``evdr_tpu/ops/int4.py``. Two 4-bit two's-complement codes
pack per byte, with one f32 scale per token exactly like int8: ``sim =
(codes @ Q^T) * scale``, applied after the product and before the max and
the masking.

Packing is TOKEN-PAIR: byte ``[n, t, d]`` holds dim ``d`` of token ``2t``
(low nibble) and of token ``2t+1`` (high nibble), so packed codes are
``(N, ceil(Lp/2), D)`` uint8. An odd Lp pads the token axis with a zero
nibble, which has no scale entry and never scores. Codes live at +-7
(scale = amax/7).

``quantize_tokens_int4`` takes a numpy array or a tensor and returns the
same kind (both compute the same bytes, round half to even), so a large
index can be packed on the GPU. Scoring: the K4 kernel
(``ops/cuda_maxsim.maxsim_cuda_int4``) or :func:`maxsim_int4`, the plain
f32 oracle here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from evdr_tpu_torch.ops.cuda_maxsim import unpack_int4_torch
from evdr_tpu_torch.ops.maxsim import NEG_FILL


def packed_token_rows(lp: int) -> int:
    """Token-axis length of the packed array for an Lp-token index."""
    return (lp + 1) // 2


def quantize_tokens_int4(P, pmask=None) -> Tuple:
    """(N, Lp, D) float -> ((N, ceil(Lp/2), D) packed uint8, (N, Lp) f32
    scales).

    Symmetric per token: code = clip(round(x / s), -7, 7), s = amax / 7.
    Fully-zero (e.g. masked) tokens get scale 0 and all-zero codes; an odd
    Lp pads one all-zero token into the last byte's high nibble."""
    if isinstance(P, torch.Tensor):
        return _quantize_tokens_int4_torch(P, pmask)
    P = np.asarray(P, dtype=np.float32)
    n, lp, d = P.shape
    amax = np.max(np.abs(P), axis=-1)                      # (N, Lp)
    scale = amax / 7.0
    safe = np.where(scale > 0, scale, 1.0)
    q = np.clip(np.rint(P / safe[..., None]), -7, 7).astype(np.int8)
    q = np.where((scale > 0)[..., None], q, np.int8(0))
    if pmask is not None:
        valid = np.asarray(pmask, dtype=bool)
        q = np.where(valid[..., None], q, np.int8(0))
        scale = np.where(valid, scale, 0.0)
    if lp % 2:
        q = np.concatenate([q, np.zeros((n, 1, d), np.int8)], axis=1)
    lo = q[:, 0::2].astype(np.uint8) & np.uint8(0xF)   # tokens 0, 2, 4, ...
    hi = q[:, 1::2].astype(np.uint8) & np.uint8(0xF)   # tokens 1, 3, 5, ...
    return (lo | (hi << np.uint8(4))).astype(np.uint8), scale.astype(
        np.float32)


def _quantize_tokens_int4_torch(P: torch.Tensor, pmask=None):
    P = P.float()
    n, lp, d = P.shape
    # divide by a tensor: CUDA divides by a Python scalar as a product
    # with its reciprocal, up to 1 ulp off the host quantizer's scales
    amax = P.abs().amax(dim=-1)
    scale = amax / torch.full_like(amax, 7.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(P / safe[..., None]).clamp_(-7, 7).to(torch.int8)
    keep = scale > 0
    if pmask is not None:
        valid = torch.as_tensor(pmask, device=P.device).bool()
        keep = keep & valid
        scale = torch.where(valid, scale, torch.zeros_like(scale))
    q.mul_(keep[..., None].to(torch.int8))
    if lp % 2:
        q = torch.cat([q, q.new_zeros((n, 1, d))], dim=1)
    lo = q[:, 0::2].view(torch.uint8) & 0xF
    hi = q[:, 1::2].view(torch.uint8) & 0xF
    return lo | (hi << 4), scale


def unpack_int4(packed, lp: int = None) -> np.ndarray:
    """(..., H, D) packed uint8 -> (..., 2H or lp, D) int8 codes.

    Interleaves the low-nibble (even) and high-nibble (odd) token planes
    back into original token order; ``lp`` slices off the odd-Lp pad."""
    packed = np.asarray(packed, np.uint8)
    lo = (packed & 0xF).astype(np.int8)
    hi = (packed >> 4).astype(np.int8)
    lo -= np.int8(16) * (lo >= 8)
    hi -= np.int8(16) * (hi >= 8)
    out = np.stack([lo, hi], axis=-2).reshape(
        *packed.shape[:-2], 2 * packed.shape[-2], packed.shape[-1])
    return out if lp is None else out[..., :lp, :]


def dequantize_int4(packed, scale) -> np.ndarray:
    """Reference dequantization: (N, Lp, D) f32 — the scoring oracle."""
    scale = np.asarray(scale, np.float32)
    return (unpack_int4(packed, lp=scale.shape[-1]).astype(np.float32)
            * scale[..., None])


def _int4_chunk(Q, qmask_f, codes_c, sc_c, pmc):
    """Score one doc chunk: unpack -> matmul -> scale -> mask/max/sum."""
    Pc = unpack_int4_torch(codes_c, pmc.shape[-1]).float()  # (C, Lp, D)
    sim = torch.einsum("qnd,cmd->qcnm", Q, Pc)
    sim = sim * sc_c[None, :, None, :]        # linear: == dequantize first
    sim = sim.masked_fill(~pmc[None, :, None, :], NEG_FILL)
    mx = sim.amax(dim=-1)
    mx = mx * pmc.any(dim=-1)[None, :, None].to(mx.dtype)
    mx = mx * qmask_f[:, None, :]
    return mx.sum(dim=-1)


def maxsim_int4(Q, packed, scales, qmask, pmask,
                chunk_p: int = 128) -> torch.Tensor:
    """Masked MaxSim over a packed-int4 index in f32: (B, N) scores; the
    counterpart of the JAX oracle ``maxsim_int4_xla`` (the -1e4 fill of an
    invalid doc token, a doc with no valid token scores 0)."""
    Q = Q.float()
    qmask_f = qmask.float()
    pmask = pmask.bool()
    scales = scales.float()
    chunk_p = max(1, min(chunk_p, packed.shape[0]))
    return torch.cat([
        _int4_chunk(Q, qmask_f, packed[i:i + chunk_p],
                    scales[i:i + chunk_p], pmask[i:i + chunk_p])
        for i in range(0, packed.shape[0], chunk_p)], dim=1)
