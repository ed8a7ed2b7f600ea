"""The numbers that decide ``correct``, each beside its limit.

A number is a gap between what the timed path produced and what the plain
reference (``reference.py``) works out for the same inputs; a run is
correct when every number its cell's traffic file names under ``limits``
is finite and at most its limit. The limits come from readings of sound
runs, of the control and of planted faults (``PERF.md``). A reading no
limit names (``recall_at_10`` of pruned search) is printed, not
compared.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch


def topk_gaps(vals, idx, ref: torch.Tensor, k: int, exact: bool) -> dict:
    """Gaps of answers ``(vals, idx)`` (S, k) against the reference's
    scores ``ref`` (S, N) of the same queries, relative to each query's
    reference top-1 score:
    - ``score_gap``: the largest gap between a returned score and the
      reference's score of the returned doc;
    - ``rank_gap`` (``exact``): the largest gap between the reference's
      r-th best score and its score of the r-th returned doc;
    - ``top1_miss`` (not ``exact``): the share of queries whose reference
      top-1 did not come back, which a stage 1 that picks poor candidates
      raises while ``score_gap`` holds only stage 2's scores;
    - ``recall_at_10`` (not ``exact``): the share of the reference's top 10
      that came back.
    A missing, malformed or out-of-range answer makes the gaps infinite."""
    out = {"score_gap": math.inf}
    if exact:
        out["rank_gap"] = math.inf
    else:
        out["top1_miss"] = 1.0
        out["recall_at_10"] = 0.0
    vals = torch.as_tensor(np.asarray(vals, np.float32), device=ref.device)
    idx = torch.as_tensor(np.asarray(idx, np.int64), device=ref.device)
    n = ref.shape[1]
    if (vals.shape != (ref.shape[0], k) or idx.shape != vals.shape
            or bool(((idx < 0) | (idx >= n)).any())):
        return out
    best, best_i = torch.sort(ref, dim=1, descending=True, stable=True)
    top1 = best[:, :1].abs().clamp_min(1e-6)
    at = torch.gather(ref, 1, idx)
    out["score_gap"] = _max(((vals - at).abs() / top1))
    if exact:
        out["rank_gap"] = _max((best[:, :k] - at).abs() / top1)
    else:
        hit = (best_i[:, :10, None] == idx[:, None, :]).any(-1)
        out["top1_miss"] = 1.0 - float(hit[:, 0].float().mean())
        out["recall_at_10"] = float(hit.float().mean())
    return out


def _max(x: torch.Tensor) -> float:
    x = x.double()
    if not bool(torch.isfinite(x).all()):
        return math.inf
    return float(x.max())


def rel_gap(a: float, b: float) -> float:
    """|a - b| / |b|."""
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-30)


def norm_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The gap between the two norms, not the norm of the difference, over
    the reference's norm (one leaf: the student index)."""
    a = float(torch.linalg.vector_norm(prog.double()))
    b = float(torch.linalg.vector_norm(ref.double()))
    return rel_gap(a, b)


def judge(numbers: Dict[str, float], limits: Optional[dict]) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that
    ``limits`` names (every one of them has to be there). Without limits
    (a calibration run) every number is listed with limit None and nothing
    is correct."""
    if limits is None:
        return False, {n: {"value": v, "limit": None}
                       for n, v in numbers.items()}
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks
