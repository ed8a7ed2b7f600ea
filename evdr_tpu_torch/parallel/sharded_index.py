"""Single-device multi-vector index.

Counterpart of ``evdr_tpu/parallel/sharded_index.py`` for one device: the
doc axis is padded to a multiple of ``pad_docs_to`` (padded docs are fully
masked, so they score 0, and the valid count is tracked so top-k drops
them). Sharding the index over several GPUs is a later slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from evdr_tpu_torch.ops.quantize import quantize_tokens_int8

_FLOAT_DTYPES = {None: torch.float32, "float32": torch.float32,
                 "bfloat16": torch.bfloat16}


@dataclass
class ShardedIndex:
    P: torch.Tensor          # (N_pad, Lp, D): float32, bfloat16 or int8 codes
    pmask: torch.Tensor      # (N_pad, Lp) bool
    n_docs: int              # valid docs (<= N_pad)
    docids: Optional[np.ndarray] = None
    # int8 indexes: per-token f32 scales (N_pad, Lp); None for float ones
    scales: Optional[torch.Tensor] = None

    @property
    def n_pad(self) -> int:
        return int(self.P.shape[0])


def as_tensor(x, device, dtype=None) -> torch.Tensor:
    """numpy array or tensor -> tensor on ``device``; a tensor already there
    with the right dtype is returned as is (no copy)."""
    if not isinstance(x, torch.Tensor):
        x = np.ascontiguousarray(x)
        if not x.flags.writeable:  # e.g. a view of a JAX array
            x = x.copy()
        if x.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
            x = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
        else:
            x = torch.from_numpy(x)
    return x.to(device=device, dtype=dtype)


def _pad_docs(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    if x.shape[0] == n_pad:
        return x.contiguous()
    out = torch.zeros((n_pad,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out[:x.shape[0]] = x
    return out


def build_sharded_index(P, pmask, device, dtype=None, pad_docs_to: int = 64,
                        scales=None, docids=None) -> ShardedIndex:
    """Place an index on ``device``.

    ``dtype`` stores it narrower: 'bfloat16' casts (round to nearest even),
    'int8' quantizes per token (ops/quantize.py) unless ``scales`` are given,
    in which case ``P`` already holds int8 codes (packed files written with
    --normalize). ``P`` may be a numpy array or a tensor on any device;
    quantization runs where ``P`` lies.
    """
    if dtype not in (None, "float32", "bfloat16", "int8"):
        raise NotImplementedError(
            f"dtype={dtype!r} storage is not ported to evdr_tpu_torch yet")
    device = torch.device(device)
    n = int(P.shape[0])
    quantum = max(1, int(pad_docs_to))
    n_pad = ((n + quantum - 1) // quantum) * quantum
    if dtype == "int8":
        if scales is None:
            P, scales = quantize_tokens_int8(P, pmask)
        P = as_tensor(P, device, torch.int8)
        scales = _pad_docs(as_tensor(scales, device, torch.float32), n_pad)
    else:
        if scales is not None:
            raise ValueError("scales are given only with dtype='int8'")
        P = as_tensor(P, device, _FLOAT_DTYPES[dtype])
    return ShardedIndex(
        P=_pad_docs(P, n_pad),
        pmask=_pad_docs(as_tensor(pmask, device, torch.bool), n_pad),
        n_docs=n,
        docids=docids,
        scales=scales,
    )
