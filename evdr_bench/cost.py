"""The frozen cost function: the H100's peaks and a kernel's least time.

A copy of ``chip_smoke.py``'s ``HBM_BYTES_PER_S``, ``PEAK_OPS``, ``bound``,
``tensor_bytes`` and ``valid_ops``, kept here so that no later change to the
program moves the yardstick. Peaks are the data sheet's dense rates of the
H100 SXM at 700 W.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
# dense tensor-core peaks; float32 modes run on the TF32 units
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12}


def bound_ms(nbytes: float, ops: float, peak: str) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of bytes over HBM
    bandwidth and operations over the peak, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[peak]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def tensor_bytes(*ts) -> int:
    """Bytes of the tensors, each read once."""
    return sum(t.numel() * t.element_size() for t in ts)


def valid_ops(qmask, pmask, d: int) -> float:
    """2 * D operations per pair of a valid query token and a valid page
    token."""
    return 2.0 * d * float(qmask.sum()) * float(pmask.sum())


def maxsim_bound_ms(Q, qmask, P, pmask, scales, peak: str) -> tuple[float, str]:
    """The bound of one full MaxSim over an index: every input read once,
    the (nq, n_pages) f32 scores written once, 2 * D operations per valid
    token pair."""
    out = int(Q.shape[0]) * int(P.shape[0]) * 4
    extra = () if scales is None else (scales,)
    return bound_ms(tensor_bytes(Q, qmask, P, pmask, *extra) + out,
                    valid_ops(qmask, pmask, int(Q.shape[-1])), peak)
