"""Distillation loss zoo — torch functions of (student, teacher) score matrices.

A port of ``evdr_tpu/losses/distill.py``, function for function (the
reference's ``criterion.py`` file:line is cited per function). Teacher
scores are always ``.detach()``ed where JAX uses ``stop_gradient``;
temperatures, top-k selection and reductions match. Top-k and argsort are
stable (lower index first among ties), as ``lax.top_k`` and ``jnp.argsort``
are. Shapes are ``(B, N)`` = (query batch, docs).

Combined variants (liscore / lipairwise / linfo / pairscore — the reference's
``mainv2_iter_*`` script matrix) are expressed through ``combined_loss``.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import torch
import torch.nn.functional as F


def _sg(x):
    return x.detach()


def spl_loss(score_s, score_t) -> torch.Tensor:
    """Score-preserving L2 ("SPL"): 0.5 * mean((t - s)^2) (reference mainv1.py:66-71)."""
    return 0.5 * torch.mean((_sg(score_t) - score_s) ** 2)


def infonce_supervised_loss(score_s, labels, temperature: float = 0.07) -> torch.Tensor:
    """Cross entropy over docs with explicit positive indices (criterion.py:43-53)."""
    logp = F.log_softmax(score_s / temperature, dim=-1)
    nll = -torch.gather(logp, -1, labels[:, None].long())
    return torch.mean(nll)


def infonce_distillation_loss(score_s, score_t, temperature: float = 0.07) -> torch.Tensor:
    """Pseudo-labeled InfoNCE: teacher argmax as the positive (criterion.py:56-68)."""
    targets = torch.argmax(_sg(score_t), dim=-1)
    return infonce_supervised_loss(score_s, targets, temperature)


def score_preserving_loss(score_s, score_t) -> torch.Tensor:
    """Plain MSE between student and teacher logits (criterion.py:74-83)."""
    return torch.mean((score_s - _sg(score_t)) ** 2)


def score_preserving_std_loss(score_s, score_t, eps: float = 1e-6) -> torch.Tensor:
    """Scale-invariant score preservation: MSE of per-query STANDARDIZED
    score rows (beyond-reference extension, no counterpart in criterion.py;
    the JAX package's docstring gives the motivation)."""
    def _std(x):
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
        # eps INSIDE the sqrt: sqrt(var)+eps has a 0/0 NaN gradient at
        # var==0 (e.g. a fully-masked query's identically-zero score row)
        return (x - mu) / torch.sqrt(var + eps * eps)

    return torch.mean((_std(score_s) - _std(_sg(score_t))) ** 2)


def _bce_with_logits(logits, targets):
    # numerically stable: max(x,0) - x*p + log1p(exp(-|x|))
    return (
        torch.clamp(logits, min=0.0)
        - logits * targets
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )


def pairwise_distillation_loss(score_s, score_t) -> torch.Tensor:
    """RankNet: BCE of all-pair student diffs vs sigmoid teacher diffs
    (criterion.py:89-108 — the reference averages over the FULL BxNxN
    tensor, diagonal included; we match that)."""
    score_t = _sg(score_t)
    diff_s = score_s[:, :, None] - score_s[:, None, :]
    diff_t = score_t[:, :, None] - score_t[:, None, :]
    target = torch.sigmoid(diff_t)
    return torch.mean(_bce_with_logits(diff_s, target))


def _stable_topk(x, k):
    """``lax.top_k``: the k largest along the last axis, lower index first
    among ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def listwise_distillation_loss(score_s, score_t, k: int = 10,
                               temperature: float = 1.0) -> torch.Tensor:
    """Top-k partial cross entropy of softened distributions, scaled by T^2
    (criterion.py:114-142). Top-k indices come from the teacher distribution."""
    score_t = _sg(score_t)
    k = min(int(k), score_s.shape[-1])
    log_prob_s = F.log_softmax(score_s / temperature, dim=-1)
    prob_t = F.softmax(score_t / temperature, dim=-1)
    top_p, top_idx = _stable_topk(prob_t, k)
    sel_logp_s = torch.gather(log_prob_s, -1, top_idx)
    loss = -torch.sum(top_p * sel_logp_s, dim=-1).mean()
    return loss * (temperature ** 2)


def lambda_loss(score_s, score_t, alpha: float = 1.0, eps: float = 1e-6) -> torch.Tensor:
    """LambdaLoss: pairwise logistic loss weighted by |ΔNDCG| under the
    teacher-sorted ordering (criterion.py:148-189): discounts 1/log2(rank+1),
    gains sigmoid(sorted teacher scores), weight = |Δgain|*|Δdiscount|*10,
    upper-triangular (i<j) mean."""
    score_t = _sg(score_t)
    n = score_s.shape[-1]
    order = torch.argsort(-score_t, dim=-1, stable=True)
    sorted_t = torch.gather(score_t, -1, order)
    sorted_s = torch.gather(score_s, -1, order)

    ranks = torch.arange(1, n + 1, dtype=torch.float32, device=score_s.device)
    discounts = 1.0 / torch.log2(ranks + 1.0)
    ddiff = torch.abs(discounts[None, :, None] - discounts[None, None, :])

    rel = torch.sigmoid(sorted_t)
    gdiff = torch.abs(rel[:, :, None] - rel[:, None, :])
    weight = gdiff * ddiff * 10.0

    diff_s = sorted_s[:, :, None] - sorted_s[:, None, :]
    pair = -F.logsigmoid(alpha * diff_s)
    tri = torch.triu(torch.ones((n, n), dtype=score_s.dtype,
                                device=score_s.device), diagonal=1)
    return torch.sum(weight * pair * tri) / (torch.sum(tri) + eps)


def ranknce_loss(score_s, score_t, temperature: float = 1.0,
                 lambda_weight: float = 1.0) -> torch.Tensor:
    """RankNCE: InfoNCE with teacher-rank-0 as positive plus a softplus
    ordering regularizer weighted by sigmoid of adjacent teacher gaps
    (criterion.py:192-226)."""
    score_t = _sg(score_t)
    order = torch.argsort(-score_t, dim=-1, stable=True)
    sorted_t = torch.gather(score_t, -1, order)
    sorted_s = torch.gather(score_s, -1, order)

    labels = torch.zeros(score_s.shape[0], dtype=torch.long,
                         device=score_s.device)
    loss_nce = infonce_supervised_loss(sorted_s, labels, temperature)

    diff_s = sorted_s[:, :-1] - sorted_s[:, 1:]
    diff_t = sorted_t[:, :-1] - sorted_t[:, 1:]
    weights = torch.sigmoid(diff_t)
    loss_rank = torch.mean(weights * F.softplus(-diff_s))
    return loss_nce + lambda_weight * loss_rank


# ---------------------------------------------------------------------------
# Registry + combined losses (the reference's 24-script matrix as one selector)
# ---------------------------------------------------------------------------

# name -> (fn(score_s, score_t | labels, **hp), needs_labels)
LOSS_REGISTRY: Dict[str, Tuple[Callable, bool]] = {
    "spl": (spl_loss, False),
    "infonce_sup": (infonce_supervised_loss, True),
    "infonce_distill": (infonce_distillation_loss, False),
    "score": (score_preserving_loss, False),
    "score_std": (score_preserving_std_loss, False),
    "ranknet": (pairwise_distillation_loss, False),
    "listwise": (listwise_distillation_loss, False),
    "lambda": (lambda_loss, False),
    "ranknce": (ranknce_loss, False),
}

# combined-loss recipes: name -> list of (component, weight_hp_key)
COMBINED_RECIPES: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "liscore": (("listwise", "lambda_list"), ("score", "lambda_score")),
    # beyond-reference: liscore with the scale-invariant score term (fixes
    # the mf25 collapse; see score_preserving_std_loss)
    "liscore_std": (("listwise", "lambda_list"), ("score_std", "lambda_score")),
    # beyond-reference: 3-term recipe combining the two strongest settings
    # of the matrix study (lipairwise's pairwise term + the std score term)
    "lipairscore_std": (("listwise", "lambda_list"), ("ranknet", "lambda_pair"),
                        ("score_std", "lambda_score")),
    "lipairwise": (("listwise", "lambda_list"), ("ranknet", "lambda_pair")),
    "linfo": (("listwise", "lambda_list"), ("infonce_distill", "lambda_info")),
    "pairscore": (("ranknet", "lambda_pair"), ("score", "lambda_score")),
}

_HP_KEYS = {
    "listwise": ("k", "temperature"),
    "infonce_sup": ("temperature",),
    "infonce_distill": ("temperature",),
    "lambda": ("alpha", "eps"),
    "ranknce": ("temperature", "lambda_weight"),
}

# linfo uses separate temperatures per component (mainv2_iter_linfo_distill.py)
_COMPONENT_TEMP_OVERRIDE = {
    ("linfo", "listwise"): "list_temp",
    ("linfo", "infonce_distill"): "info_temp",
}


def _component_kwargs(recipe: str, comp: str, hp: Mapping) -> dict:
    kwargs = {}
    for key in _HP_KEYS.get(comp, ()):
        src = key
        if key == "temperature":
            src = _COMPONENT_TEMP_OVERRIDE.get((recipe, comp), "temperature")
        if src in hp:
            kwargs[key] = hp[src]
    return kwargs


def combined_loss(name: str, score_s, score_t, hp: Mapping) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Evaluate a combined recipe. Returns (total, per-component dict).

    Mirrors e.g. mainv2_iter_liscore.py:301-303:
    total = lambda_list * listwise + lambda_score * score_preserving.
    """
    parts = {}
    total = 0.0
    for comp, weight_key in COMBINED_RECIPES[name]:
        fn, _ = LOSS_REGISTRY[comp]
        val = fn(score_s, score_t, **_component_kwargs(name, comp, hp))
        parts[comp] = val
        total = total + float(hp.get(weight_key, 1.0)) * val
    return total, parts
