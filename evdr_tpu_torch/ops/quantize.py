"""Per-token symmetric int8 quantization of multi-vector indexes.

Serving indexes are bandwidth-bound on the page stream; storing doc tokens
as int8 + one f32 scale per token halves that stream against bf16 (scale
overhead 4/D, about 3% at D=128). Scores are exactly ``(P_i8 @ Q^T) *
scale``: the scale multiplies the similarity after the matmul and before
the max/masking, which keeps the masking semantics of the float path.

``quantize_tokens_int8`` takes a numpy array or a torch tensor and returns
the same kind; both branches compute the same codes (round half to even).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def quantize_tokens_int8(P, pmask=None) -> Tuple:
    """(N, Lp, D) float -> (int8 codes, (N, Lp) f32 per-token scales).

    Symmetric: code = round(x / s), s = max|x| / 127 per token. Fully-zero
    (e.g. masked) tokens get scale 0 and all-zero codes.
    """
    if isinstance(P, torch.Tensor):
        return _quantize_tokens_int8_torch(P, pmask)
    P = np.asarray(P, dtype=np.float32)
    amax = np.max(np.abs(P), axis=-1)                      # (N, Lp)
    scale = amax / 127.0
    safe = np.where(scale > 0, scale, 1.0)
    codes = np.clip(np.rint(P / safe[..., None]), -127, 127).astype(np.int8)
    codes = np.where((scale > 0)[..., None], codes, np.int8(0))
    if pmask is not None:
        valid = np.asarray(pmask, dtype=bool)
        codes = np.where(valid[..., None], codes, np.int8(0))
        scale = np.where(valid, scale, 0.0)
    return codes, scale.astype(np.float32)


def _quantize_tokens_int8_torch(P: torch.Tensor, pmask=None):
    P = P.float()
    # divide by a tensor: CUDA divides by a Python scalar as a product
    # with its reciprocal, up to 1 ulp off the host quantizer's scales
    amax = P.abs().amax(dim=-1)
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    codes = torch.round(P / safe[..., None]).clamp_(-127, 127).to(torch.int8)
    keep = scale > 0
    if pmask is not None:
        valid = torch.as_tensor(pmask, device=P.device).bool()
        keep = keep & valid
        scale = torch.where(valid, scale, torch.zeros_like(scale))
    codes.mul_(keep[..., None].to(torch.int8))
    return codes, scale


def dequantize_int8(codes, scale) -> np.ndarray:
    """Reference dequantization: (N, Lp, D) f32."""
    return np.asarray(codes, np.float32) * np.asarray(scale, np.float32)[..., None]
