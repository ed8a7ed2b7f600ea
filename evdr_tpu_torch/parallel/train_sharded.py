"""Doc-sharded distillation training and evaluation over a ``DeviceMesh``.

Counterpart of ``evdr_tpu/parallel/train_sharded.py``. The student
parameter, the teacher index and their masks shard over the mesh's doc
axis (JAX's layout: contiguous row ranges, the padding at the end);
queries replicate on this process's first device. JAX's ``shard_map``
becomes explicit per-shard code: each local shard scores its rows on its
device, and the GLOBAL loss is assembled by three collectives that take
the list of this process's per-shard tensors (:func:`psum`,
:func:`all_gather_cat`, :func:`global_max`), so a mesh of one process
(``mesh_of(["cuda:0"] * 4)``, several cards) and one of several processes
(``multihost.global_doc_mesh``) share the loss code:

- softmax / cross-entropy terms (listwise, the InfoNCE forms): a global
  logsumexp by psum, its max shift detached (JAX's stop_gradient);
- the teacher's top-k: a top-k a shard, all-gathered, merged (the global
  top-k lies in the union of the local ones);
- MSE terms: local sums + psum over the valid (unpadded) docs;
- label and candidate lookups (supervised positives, hard-token docs):
  the owning shard contributes, the others add zero.

Losses without a collective form (ranknet, lambda, ranknce, ...) gather
the batch's (B, N) score rows and reuse the standard loss functions.

One process: a psum moves each shard's partial to the first shard's
device and adds it; autograd flows across ``.to()``. Several processes:
every rank computes the same replicated loss on its first device. The two
cross-process collectives are ``torch.autograd.Function`` s whose
backward all-reduces the upstream gradient (all-gather: this rank's slice
of the all-reduced gradient), and every rank differentiates ``loss /
world``. A replicated consumer then gets world x (1 / world) = its
gradient once, and a psum whose result feeds shard-local terms again
(the means and variances of ``score_std``) gets the sum of every rank's
part, which passing the gradient through unchanged would miss. gloo
takes host tensors, so CUDA tensors are staged through host memory on it
(``parallel/multihost.py``'s rule).

Semantics kept from the JAX package: padding docs are excluded through
``valid`` (global index < ``n_docs``; a real doc whose tokens are all
masked still counts and scores 0); mixup draws ONE permutation of a
shard's rows and applies it on every shard; hardtoken ranks by count of
greater + psum and takes the hard token from the shard that owns the doc;
QAT int8/int4 run shard-locally (per-token, so exactly as one device);
AdamW is elementwise, so each shard's state equals the global state. The
student is scored by the plain differentiable ``maxsim_torch``, as on one
device; the teacher precompute and the evaluation go through
``maxsim(impl=...)`` in float32, which on the GPU is K1's float32 mode on
every shard.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from evdr_tpu_torch.data.packing import l2_normalize
from evdr_tpu_torch.losses.distill import (COMBINED_RECIPES, _component_kwargs,
                                          _stable_topk)
from evdr_tpu_torch.ops.maxsim import maxsim_torch
from evdr_tpu_torch.ops.qat import qat_apply
from evdr_tpu_torch.parallel.mesh import DeviceMesh, gather_blocks
from evdr_tpu_torch.utils.timing import span

if TYPE_CHECKING:  # the train package imports the engine, which imports this
    from evdr_tpu_torch.train.config import TrainConfig

NEG = float("-inf")

# components with a hand-written collective form (cf. losses/distill.py)
_COLLECTIVE_COMPONENTS = ("listwise", "infonce_distill", "score", "score_std",
                          "spl", "infonce_sup")


def has_collective_form(loss_name: str) -> bool:
    """True when the loss avoids the (B, N) gather fallback entirely."""
    if loss_name in _COLLECTIVE_COMPONENTS:
        return True
    recipe = COMBINED_RECIPES.get(loss_name)
    return recipe is not None and all(
        comp in _COLLECTIVE_COMPONENTS for comp, _ in recipe)


# ---------------------------------------------------------------------------
# collectives over this process's shards (and, across processes, the group)
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, mesh: DeviceMesh, op=None) -> torch.Tensor:
    """A new tensor: ``x`` reduced over the mesh's processes (sum unless
    ``op``), on ``x``'s device; gloo gets a host copy."""
    import torch.distributed as dist

    y = x.detach().to("cpu" if mesh.backend == "gloo" else x.device,
                      copy=True).contiguous()
    dist.all_reduce(y, op=dist.ReduceOp.SUM if op is None else op,
                    group=mesh.group)
    return y.to(x.device)


class _AllReduce(torch.autograd.Function):
    """Sum over processes; the backward sums the gradient over them too
    (every rank differentiates loss / world, see the module docstring)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh), None


class _AllGather(torch.autograd.Function):
    """Every shard's block, concatenated along ``dim`` in global shard
    order on this process's first device; the backward gives each local
    block its slice of the gradient summed over processes."""

    @staticmethod
    def forward(ctx, mesh, dim, *xs):
        ctx.mesh, ctx.dim = mesh, dim
        ctx.devices = [x.device for x in xs]
        blocks = gather_blocks([x.detach() for x in xs], mesh,
                               mesh.devices[0])
        return torch.cat(blocks, dim=dim)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        parts = _all_reduce(g.contiguous(), mesh).chunk(mesh.size,
                                                        dim=ctx.dim)
        base = mesh.rank * mesh.n_local
        return (None, None) + tuple(parts[base + i].to(dev)
                                    for i, dev in enumerate(ctx.devices))


def psum(xs: Sequence[torch.Tensor], mesh: DeviceMesh) -> torch.Tensor:
    """The sum over every shard of the mesh of same-shaped tensors (``xs``:
    this process's shards), on this process's first device."""
    dev = mesh.devices[0]
    total = xs[0].to(dev)
    for x in xs[1:]:
        total = total + x.to(dev)
    if mesh.multiprocess:
        total = _AllReduce.apply(total, mesh)
    return total


def all_gather_cat(xs: Sequence[torch.Tensor], mesh: DeviceMesh,
                   dim: int = 1) -> torch.Tensor:
    """Every shard's block concatenated along ``dim`` in global shard
    order (JAX's ``all_gather(..., tiled=True)``), on this process's first
    device."""
    if not mesh.multiprocess:
        dev = mesh.devices[0]
        return torch.cat([x.to(dev) for x in xs], dim=dim)
    return _AllGather.apply(mesh, dim, *xs)


def global_max(xs: Sequence[torch.Tensor], mesh: DeviceMesh) -> torch.Tensor:
    """The elementwise max over every shard, detached (the stabilizing
    shift of a logsumexp carries no gradient), on the first device."""
    import torch.distributed as dist

    dev = mesh.devices[0]
    m = xs[0].detach().to(dev)
    for x in xs[1:]:
        m = torch.maximum(m, x.detach().to(dev))
    if mesh.multiprocess:
        m = _all_reduce(m, mesh, op=dist.ReduceOp.MAX)
    return m


# ---------------------------------------------------------------------------
# the collective loss forms
# ---------------------------------------------------------------------------

def _global_lse(xs, mesh):
    """logsumexp over the sharded last axis: [(B, n_loc)] -> (B,)."""
    m = global_max([x.amax(dim=-1) for x in xs], mesh)
    z = psum([torch.exp(x - m.to(x.device)[:, None]).sum(dim=-1)
              for x in xs], mesh)
    return torch.log(z) + m


def _global_topk_pairs(t_ms, s_ms, k: int, mesh):
    """The global teacher top-k with the student's scores at the same docs:
    both (B, k), on the first device."""
    k_l = min(k, t_ms[0].shape[-1])
    tvs, svs = [], []
    for t, s in zip(t_ms, s_ms):
        tv, ti = _stable_topk(t, k_l)
        tvs.append(tv)
        svs.append(torch.gather(s, 1, ti))
    tv_all = all_gather_cat(tvs, mesh)
    sv_all = all_gather_cat(svs, mesh)
    tk, pos = _stable_topk(tv_all, min(k, tv_all.shape[-1]))
    return tk, torch.gather(sv_all, 1, pos)


def _listwise_global(s_ms, t_ms, k, temp, mesh):
    """listwise_distillation_loss over the sharded doc axis
    (criterion.py:114-142)."""
    lse_t = _global_lse([t / temp for t in t_ms], mesh)
    lse_s = _global_lse([s / temp for s in s_ms], mesh)
    tk, sk = _global_topk_pairs(t_ms, s_ms, k, mesh)
    prob_t = torch.exp(tk / temp - lse_t[:, None])
    logp_s = sk / temp - lse_s[:, None]
    return -torch.sum(prob_t * logp_s, dim=-1).mean() * (temp ** 2)


def _infonce_distill_global(s_ms, t_ms, temp, mesh):
    """infonce_distillation_loss over the sharded doc axis
    (criterion.py:56-68): the student at the teacher's argmax."""
    _, sk = _global_topk_pairs(t_ms, s_ms, 1, mesh)
    lse_s = _global_lse([s / temp for s in s_ms], mesh)
    return torch.mean(lse_s - sk[:, 0] / temp)


def _owned(gidx: torch.Tensor, col: int, shard_size: int):
    """Which global doc indices shard ``col`` owns, and their local rows
    (clipped into the shard where not owned)."""
    owned = torch.div(gidx, shard_size, rounding_mode="floor") == col
    local = (gidx - col * shard_size).clamp(0, shard_size - 1)
    return owned, local


def _infonce_sup_global(s_ms, pos, temp, mesh, shard_size):
    """infonce_supervised_loss with GLOBAL label indices
    (criterion.py:43-53): the owning shard contributes the label's score."""
    lse = _global_lse([s / temp for s in s_ms], mesh)
    parts = []
    for s, (_, col, dev) in zip(s_ms, mesh.local_shards()):
        owned, lpos = _owned(pos.to(dev).long(), col, shard_size)
        s_at = torch.gather(s, 1, lpos[:, None])[:, 0]
        parts.append(torch.where(owned, s_at, torch.zeros_like(s_at)))
    s_at = psum(parts, mesh)
    return torch.mean(lse - s_at / temp)


def _mse_global(s_locs, t_locs, valids, mesh, halved=False):
    """(0.5x) mean squared error over the valid docs only."""
    d2 = [torch.where(v[None, :], (s - t) ** 2, torch.zeros_like(s)).sum()
          for s, t, v in zip(s_locs, t_locs, valids)]
    total = psum(d2, mesh)
    count = psum([v.to(torch.float32).sum() for v in valids], mesh)
    loss = total / (count * s_locs[0].shape[0])
    return 0.5 * loss if halved else loss


def _mse_std_global(s_locs, t_locs, valids, mesh, eps=1e-6):
    """score_preserving_std_loss over the sharded doc axis: each query's
    global mean and std over the valid docs, then the MSE of the
    standardized rows."""
    vs = [v[None, :].to(torch.float32) for v in valids]
    count = psum([v.sum(dim=-1) for v in vs], mesh)             # (1,)

    def std_rows(xs):
        mu = psum([(x * v).sum(dim=-1) for x, v in zip(xs, vs)],
                  mesh) / count
        mus = [mu.to(x.device)[:, None] for x in xs]
        var = psum([(((x - m) ** 2) * v).sum(dim=-1)
                    for x, m, v in zip(xs, mus, vs)], mesh) / count
        # eps inside the sqrt, as the one-device loss
        den = torch.sqrt(var + eps * eps)
        return [(x - m) / den.to(x.device)[:, None]
                for x, m in zip(xs, mus)]

    d2 = [torch.where(v[None, :], (a - b) ** 2, torch.zeros_like(a)).sum()
          for a, b, v in zip(std_rows(s_locs), std_rows(t_locs), valids)]
    return psum(d2, mesh) / (count[0] * s_locs[0].shape[0])


def _collective_component(comp: str, s_locs, t_locs, s_ms, t_ms, valids,
                          pos, kwargs: dict, shard_size: int, mesh):
    """One loss component over the sharded doc axis. ``s_locs/t_locs`` are
    the raw local scores (the MSE terms, padding masked by ``valids``);
    ``s_ms/t_ms`` have the padding at -inf (the softmax terms)."""
    if comp == "listwise":
        return _listwise_global(s_ms, t_ms, kwargs.get("k", 10),
                                kwargs.get("temperature", 1.0), mesh)
    if comp == "infonce_distill":
        return _infonce_distill_global(s_ms, t_ms,
                                       kwargs.get("temperature", 0.07), mesh)
    if comp == "infonce_sup":
        return _infonce_sup_global(s_ms, pos, kwargs.get("temperature", 0.07),
                                   mesh, shard_size)
    if comp == "score":
        return _mse_global(s_locs, t_locs, valids, mesh)
    if comp == "score_std":
        return _mse_std_global(s_locs, t_locs, valids, mesh)
    if comp == "spl":
        return _mse_global(s_locs, t_locs, valids, mesh, halved=True)
    raise ValueError(f"no collective form for component {comp!r}")


def _make_loss_core(cfg: TrainConfig, n_docs: int, mesh: DeviceMesh
                    ) -> Callable:
    """loss_core(s_locs, t_locs, valids, pos) -> (total, parts) over the
    shards' lists: the collective forms where the loss has them, else the
    (B, N) row-gather fallback."""
    from evdr_tpu_torch.train.harness import make_loss_fn

    hp = cfg.loss_hp()
    name = cfg.loss
    collective = has_collective_form(name)
    fallback_loss = None if collective else make_loss_fn(cfg)
    if name in COMBINED_RECIPES:
        comps = [(comp, wk, _component_kwargs(name, comp, hp))
                 for comp, wk in COMBINED_RECIPES[name]]
    else:
        comps = [(name, None, _component_kwargs(name, name, hp))]

    def loss_core(s_locs, t_locs, valids, pos):
        shard_size = s_locs[0].shape[-1]
        s_ms = [s.masked_fill(~v[None, :], NEG)
                for s, v in zip(s_locs, valids)]
        t_ms = (None if t_locs is None else
                [t.masked_fill(~v[None, :], NEG)
                 for t, v in zip(t_locs, valids)])
        if collective:
            parts: Dict[str, torch.Tensor] = {}
            total = 0.0
            for comp, weight_key, kwargs in comps:
                kk = dict(kwargs)
                if "k" in kk:
                    kk["k"] = min(int(kk["k"]), n_docs)
                val = _collective_component(comp, s_locs, t_locs, s_ms, t_ms,
                                            valids, pos, kk, shard_size, mesh)
                parts[comp] = val
                w = float(hp.get(weight_key, 1.0)) if weight_key else 1.0
                total = total + w * val
            return total, parts
        # the fallback: this batch's full score rows (tiny beside the
        # index) and the standard loss functions
        s_full = all_gather_cat(s_locs, mesh)[:, :n_docs]
        t_full = (None if t_locs is None else
                  all_gather_cat(t_locs, mesh)[:, :n_docs])
        return fallback_loss(s_full, t_full, pos)

    return loss_core


# ---------------------------------------------------------------------------
# augmentations over the shards (mainv3 Family D at mesh scale)
# ---------------------------------------------------------------------------

def _mixup_sharded(cfg, P_maskeds, pms, valids, queries, t_locs, draws,
                   mesh, chunk_p):
    """Document mixup (mainv3_iter_liscore_mixup.py:313-331) with one
    permutation of a shard's rows applied on every shard (JAX's
    replicated key); pairs whose partner is a padding doc are excluded
    from the mix MSE. At one shard this is the one-device mixup."""
    from evdr_tpu_torch.train import harness

    gen, host_rng = draws
    lam, perm = harness.mixup_draws(cfg.mixup_alpha, int(pms[0].shape[0]),
                                    host_rng, gen)
    s_mix, t_mix, v_mix = [], [], []
    for i, (_, _, dev) in enumerate(mesh.local_shards()):
        p, lam_d = perm.to(dev), lam.to(dev)
        Q, qm = queries[i]
        pmask_mix = pms[i] & pms[i][p]
        P_mix = lam_d * P_maskeds[i] + (1.0 - lam_d) * P_maskeds[i][p]
        Ps_mix = l2_normalize(P_mix * pmask_mix[..., None].to(P_mix.dtype))
        s_mix.append(maxsim_torch(Q, Ps_mix, qm, pmask_mix, chunk_p=chunk_p))
        t_mix.append((lam_d * t_locs[i] + (1.0 - lam_d) * t_locs[i][:, p])
                     .detach())
        v_mix.append(valids[i] & valids[i][p])
    loss_score_mix = _mse_global(s_mix, t_mix, v_mix, mesh)
    return cfg.lambda_score * loss_score_mix, loss_score_mix


def _hardtoken_sharded(cfg, Pss, pms, s_locs, t_locs, valids, queries, Pt,
                       pmt, gen, loss_core, mesh, n_docs, chunk_p):
    """Hard-token virtual queries over the sharded doc axis
    (mainv3_iter_liscore_QA_hardtoken.py:368-440): the global teacher
    top-k, global student ranks by count of greater + psum (the one-device
    double argsort's ranks but for exact ties), the hard token of each
    picked doc from the shard that owns it. Returns (aux_total,
    aux_parts), or (None, None) when disabled. The (N,)-sized gap-log
    diagnostic stays one-device, as in the JAX package."""
    from evdr_tpu_torch.train import harness

    shard_size = int(s_locs[0].shape[1])
    k = min(int(cfg.k), n_docs)
    a = min(int(cfg.aux_docs), k)
    if a <= 0:
        return None, None
    shards = mesh.local_shards()
    dev0 = mesh.devices[0]
    k_l = min(k, shard_size)

    # the global teacher top-k candidates, by global index
    tvs, gtis = [], []
    for t, v, (_, col, _) in zip(t_locs, valids, shards):
        tv, ti = _stable_topk(t.detach().masked_fill(~v[None, :], NEG), k_l)
        tvs.append(tv)
        gtis.append(ti + col * shard_size)
    tv_all = all_gather_cat(tvs, mesh)
    gti_all = all_gather_cat(gtis, mesh)
    _, pos = _stable_topk(tv_all, k)
    gidx = torch.gather(gti_all, 1, pos)                      # (B, k)

    # the teacher rank of the r-th candidate is r; the student's is the
    # count of valid docs scoring strictly higher
    s_at_parts = []
    for s, (_, col, dev) in zip(s_locs, shards):
        owned, lidx = _owned(gidx.to(dev), col, shard_size)
        s_at = torch.gather(s.detach(), 1, lidx)
        s_at_parts.append(torch.where(owned, s_at, torch.zeros_like(s_at)))
    s_at = psum(s_at_parts, mesh)
    rank_parts = []
    for s, v, (_, _, dev) in zip(s_locs, valids, shards):
        s_valid = s.detach().masked_fill(~v[None, :], NEG)
        rank_parts.append((s_valid[:, None, :]
                           > s_at.to(dev)[:, :, None]).sum(dim=-1))
    rank_s = psum(rank_parts, mesh)
    rank_t = torch.arange(k, device=dev0)[None, :]
    gap_topk = (rank_t - rank_s).abs()
    aux_pos = harness._stable_argsort_desc(gap_topk)[:, :a]
    flat = torch.gather(gidx, 1, aux_pos).reshape(-1)          # (B*a,)

    # the hard token of each (query, aux doc), from its owning shard
    hard_parts = []
    with torch.no_grad():
        for i, (_, col, dev) in enumerate(shards):
            Q, qm = queries[i]
            owned, lflat = _owned(flat.to(dev), col, shard_size)
            doc_tok = Pt[i][lflat]                             # (B*a, Lp, D)
            doc_msk = pmt[i][lflat]
            q_rep = Q.repeat_interleave(a, dim=0)
            qm_rep = qm.repeat_interleave(a, dim=0)
            sim = torch.einsum("bld,bmd->blm", q_rep, doc_tok)
            sim = sim.masked_fill(~qm_rep[:, :, None], NEG)
            max_over_q = sim.amax(dim=1).masked_fill(~doc_msk, NEG)
            best_tok = torch.argmax(max_over_q, dim=1)
            hard_loc = doc_tok[torch.arange(doc_tok.shape[0], device=dev),
                               best_tok]                       # (B*a, D)
            hard_parts.append(torch.where(owned[:, None], hard_loc,
                                          torch.zeros_like(hard_loc)))
        hard = psum(hard_parts, mesh)[:, None, :]              # (B*a, 1, D)
        if cfg.virt_noise_std > 0:
            hard = hard + harness.virtual_query_noise(hard.shape, gen) * \
                cfg.virt_noise_std
        qv = l2_normalize(hard)
        qmask_v = torch.ones(qv.shape[:2], dtype=torch.bool, device=dev0)
        t_v = []
        for i, (_, _, dev) in enumerate(shards):
            t_v.append(maxsim_torch(qv.to(dev), Pt[i], qmask_v.to(dev),
                                    pmt[i], chunk_p=chunk_p))
    s_v = [maxsim_torch(qv.to(dev), Pss[i], qmask_v.to(dev), pms[i],
                        chunk_p=chunk_p)
           for i, (_, _, dev) in enumerate(shards)]
    return loss_core(s_v, t_v, valids, None)


# ---------------------------------------------------------------------------
# the sharded objective shared by train and eval
# ---------------------------------------------------------------------------

def _build_objective(cfg: TrainConfig, mesh: DeviceMesh, n_docs: int, *,
                     with_aug: bool, needs_labels: bool, use_sct: bool):
    """objective(params, Qb, qmb, draws, pms, Pt, pmt, sct_rows, pos_b)
    -> (total, parts) on this process's first device. ``params``, ``pms``,
    ``Pt``, ``pmt`` and ``sct_rows`` (the batch's rows of the precomputed
    teacher table; None: rescore the teacher) hold one tensor per local
    shard; ``draws`` is the step's (generator, host generator)."""
    if mesh.dp != 1:
        raise ValueError("sharded training takes a 1D doc mesh")
    loss_core = _make_loss_core(cfg, n_docs, mesh)
    chunk_p = cfg.chunk_p
    aug = cfg.aug if with_aug else "none"
    shards = mesh.local_shards()

    def objective(params, Qb, qmb, draws, pms, Pt, pmt, sct_rows=None,
                  pos_b=None):
        if aug == "qnoise":
            # train-only Gaussian noise on valid query tokens, mask-multiply
            # + re-L2-normalize (mainv3_iter_liscore_noisev1.py:296-299),
            # drawn once on the first device: every shard sees one batch
            noise = torch.randn(Qb.shape, generator=draws[0],
                                device=Qb.device, dtype=Qb.dtype) * \
                cfg.q_noise_std
            qmf = qmb[..., None].to(Qb.dtype)
            Qb = l2_normalize((Qb + noise * qmf) * qmf)
        copies = {}
        queries, s_locs, t_locs, valids, P_maskeds, Pss = [], [], [], [], [], []
        shard_size = int(pmt[0].shape[0])
        for i, (_, col, dev) in enumerate(shards):
            if dev not in copies:
                copies[dev] = (Qb.to(dev), qmb.to(dev))
            Q, qm = copies[dev]
            queries.append((Q, qm))
            P_masked = params[i] * pms[i][..., None].to(params[i].dtype)
            Ps = l2_normalize(P_masked)
            if cfg.qat in ("int8", "int4"):
                # per-token quantize -> dequantize is doc-independent, so
                # the shard-local STE pass is the global one (pq/opq need
                # replicated codebooks: refused on a mesh by validate())
                Ps = qat_apply(Ps, cfg.qat, pmask=pms[i])
            s_locs.append(maxsim_torch(Q, Ps, qm, pms[i], chunk_p=chunk_p))
            if needs_labels:
                t = None
            elif sct_rows is not None and aug != "qnoise":
                # precomputed rows are clean-query scores; qnoise scores the
                # teacher with the noisy queries (noisev1:305)
                t = sct_rows[i].detach()
            else:
                with torch.no_grad():
                    t = maxsim_torch(Q, Pt[i], qm, pmt[i], chunk_p=chunk_p)
            t_locs.append(t)
            # "valid" = a REAL doc (global index < n_docs), not padding: a
            # real doc whose tokens are all masked still takes part (score
            # 0), as on one device
            valids.append(col * shard_size
                          + torch.arange(shard_size, device=dev) < n_docs)
            P_maskeds.append(P_masked)
            Pss.append(Ps)
        total, parts = loss_core(s_locs, None if needs_labels else t_locs,
                                 valids, pos_b)
        if aug == "mixup" and n_docs > 1:
            mix_term, score_mix = _mixup_sharded(
                cfg, P_maskeds, pms, valids, queries, t_locs, draws, mesh,
                chunk_p)
            total = total + cfg.lambda_mix * mix_term
            parts = dict(parts, mix=mix_term, score_mix=score_mix)
        if aug == "hardtoken":
            aux_total, aux_parts = _hardtoken_sharded(
                cfg, Pss, pms, s_locs, t_locs, valids, queries, Pt, pmt,
                draws[0], loss_core, mesh, n_docs, chunk_p)
            if aux_total is not None:
                total = total + cfg.lambda_aux * aux_total
                parts = dict(parts, aux=aux_total,
                             **{f"aux_{k2}": v for k2, v in aux_parts.items()})
        return total, parts

    return objective


# ---------------------------------------------------------------------------
# the teacher-score precompute over the sharded index
# ---------------------------------------------------------------------------

def precompute_teacher_scores_sharded(Q, qmask, P_sh, pm_sh,
                                      mesh: DeviceMesh, chunk_q: int = 256,
                                      chunk_p: int = 128, impl: str = "auto"
                                      ) -> List[torch.Tensor]:
    """The (Mq, N_pad) teacher MaxSim table, doc-sharded: one (Mq,
    shard_rows) block a local shard, computed and kept on its device
    (``P_sh``/``pm_sh``: the teacher shards). Each shard scores through
    ``maxsim(impl=impl, compute_dtype=float32)`` in chunks of ``chunk_q``
    queries, as the one-device precompute: K1's float32 mode on the GPU
    with 'pallas' or 'auto'."""
    from evdr_tpu_torch.train.harness import _precompute_teacher_scores

    out, copies = [], {}
    for (_, _, dev), P, pm in zip(mesh.local_shards(), P_sh, pm_sh):
        if dev not in copies:
            copies[dev] = (Q.to(dev), qmask.to(dev))
        Qd, qmd = copies[dev]
        out.append(_precompute_teacher_scores(Qd, qmd, P, pm, chunk_q=chunk_q,
                                              chunk_p=chunk_p, impl=impl))
    return out


# ---------------------------------------------------------------------------
# train step and eval loss builders
# ---------------------------------------------------------------------------

def build_sharded_train_step(cfg: TrainConfig, mesh: DeviceMesh, *, params,
                             pmask_student, P_teacher, pmask_teacher,
                             n_docs: int, Q_all, qm_all, sct_all=None,
                             pos_all=None, optimizer=None
                             ) -> Tuple[Callable, torch.optim.Optimizer]:
    """Returns (step, optimizer).

    ``step(idx, seed) -> parts``: the one-device ``build_train_step``'s
    contract: ``idx`` is a (B,) batch of query-pool indices ((K, B) with
    ``cfg.steps_per_dispatch`` K > 1), ``seed`` seeds the step's
    generator on the first device and the host generator of the mixup
    lambda. ``params``, ``pmask_student``, ``P_teacher``,
    ``pmask_teacher`` and ``sct_all`` (the (Mq, shard_rows) blocks of
    ``precompute_teacher_scores_sharded``; None rescores the teacher each
    step) hold one tensor per local shard, padded to the mesh's layout;
    ``Q_all``/``qm_all`` lie on the first device. The optimizer holds the
    shards' parameters (AdamW with optax.adamw's rule when None) and
    updates them in place."""
    from evdr_tpu_torch.train.harness import dispatch_steps, make_optimizer

    params = list(params)
    if optimizer is None:
        optimizer = make_optimizer(cfg, params)
    needs_labels = cfg.loss == "infonce_sup"
    use_sct = sct_all is not None and cfg.aug != "qnoise" and not needs_labels
    objective = _build_objective(cfg, mesh, n_docs, with_aug=True,
                                 needs_labels=needs_labels, use_sct=use_sct)
    dev0 = mesh.devices[0]
    pos_t = (torch.as_tensor(np.asarray(pos_all), dtype=torch.long,
                             device=dev0) if needs_labels else None)
    # every rank differentiates loss / world (see the module docstring)
    scale = 1.0 / mesh.world

    def step(idx, gen, host_rng):
        with span("evdr.train.forward"):
            Qb, qmb = Q_all[idx], qm_all[idx]
            sct_rows = ([s[idx.to(s.device)] for s in sct_all] if use_sct
                        else None)
            pos_b = pos_t[idx] if needs_labels else None
            optimizer.zero_grad(set_to_none=True)
            total, parts = objective(params, Qb, qmb, (gen, host_rng),
                                     pmask_student, P_teacher,
                                     pmask_teacher, sct_rows, pos_b)
        with span("evdr.train.backward"):
            (total * scale if mesh.world > 1 else total).backward()
        with span("evdr.train.optimizer"):
            optimizer.step()
        parts = {k: v.detach() for k, v in parts.items()}
        parts["total_loss"] = total.detach()
        return parts

    def run_step(idx, seed):
        return dispatch_steps(step, idx, seed, dev0)

    return run_step, optimizer


def build_sharded_eval_loss(cfg: TrainConfig, mesh: DeviceMesh, n_docs: int
                            ) -> Callable:
    """eval_loss(params, pms, Pt, pmt, Q, qm, sct_rows=None, pos=None) ->
    (total, parts) as 0-d tensors: the distillation loss on test queries
    through the collective forms (no augmentation, as the one-device
    ``evaluation_loss``), without autograd."""
    needs_labels = cfg.loss == "infonce_sup"
    obj_inline = _build_objective(cfg, mesh, n_docs, with_aug=False,
                                  needs_labels=needs_labels, use_sct=False)
    obj_sct = _build_objective(cfg, mesh, n_docs, with_aug=False,
                               needs_labels=needs_labels, use_sct=True)

    def eval_loss(params, pms, Pt, pmt, Q, qm, sct_rows=None, pos=None):
        with torch.no_grad():
            if sct_rows is not None and not needs_labels:
                return obj_sct(params, Q, qm, None, pms, Pt, pmt, sct_rows,
                               pos)
            return obj_inline(params, Q, qm, None, pms, Pt, pmt, None, pos)

    return eval_loss
