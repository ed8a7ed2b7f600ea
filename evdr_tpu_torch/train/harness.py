"""Unified training harness, single device: index-compression distillation
in PyTorch (the port of the single-device part of
``evdr_tpu/train/harness.py``).

Semantics parity with the shared skeleton (``mainv2_iter_liscore.py:56-311``,
``mainv1.py:160-260``):

  per dataset: load queries + teacher -> per mf: init student (align by docid,
  mask, param) -> step-0 eval -> train loop { student renorm -> MaxSim scores ->
  distillation loss -> AdamW } -> periodic eval + best tracking + best-npz save
  -> final ``summary/best_ndcg5`` JSON line (reporter-compatible).

As in the JAX package:
- the whole dataset lives on the device; batches are device-side gathers
  driven by a host index stream (``index_stream``, numpy, so both packages
  draw the same batches for the same seed);
- teacher scores over the frozen teacher index are precomputed once per
  dataset through ``maxsim(impl=cfg.score_impl, compute_dtype=float32)``;
  with ``score_impl`` ``'pallas'`` (or ``'auto'`` on the GPU) that is K1's
  float32 mode;
- the student is scored in the step by the plain differentiable
  ``maxsim_torch`` (``harness.py:372-373``), never by the fused op;
- evaluation scores in float32 through ``maxsim(impl=cfg.eval_impl)``
  (K1's float32 mode on the GPU with ``'auto'``);
- the optimizer is ``torch.optim.AdamW`` with optax.adamw's defaults
  (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay);
- checkpoints are one npz with the JAX package's leaf layout (param, Adam
  step count, first and second moments), so a checkpoint of either package
  resumes in the other;
- the augmentations ``qnoise``, ``mixup`` and ``hardtoken`` and QAT
  (``--qat int8|int4|pq|opq``, ``qat_start_frac``, ``qat_select_post``)
  follow the JAX step and loop line for line. Their random draws come from
  the step's seed through :func:`mixup_draws` and
  :func:`virtual_query_noise` (other numbers than JAX's; the parity tests
  hand both packages the same draws).

``mesh_docs > 1`` trains doc-sharded (``parallel/train_sharded.py``): the
student, its mask and the teacher shard over a ``DeviceMesh`` in the JAX
package's layout (the doc axis padded to a multiple of the shard count),
queries stay on the first shard's device, the teacher tables are
precomputed shard by shard with ``score_impl`` and the evaluation scores
shard by shard with ``eval_impl`` (K1's float32 mode on every shard of a
GPU mesh). ``run_training(..., mesh=)`` takes the mesh (a one-process
``mesh_of([...])`` or a ``multihost.global_doc_mesh``); without it,
``make_mesh`` over the first ``mesh_docs`` GPUs. Across processes only
process 0 writes (logs, artifacts, checkpoints); the others compute
everything and write nothing. A mesh checkpoint keeps the padded layout, so
it resumes in either package at the same mesh size, and a one-device
checkpoint is zero-padded onto the mesh.

Not ported (``check_ported`` raises ``NotImplementedError``): orbax
checkpoints (they need the ``orbax-checkpoint`` package, which the port
does not depend on; npz is what both packages read).
The JAX package's persistent compilation cache
(``utils/timing.enable_persistent_cache``) has no counterpart: PyTorch runs
eagerly and the kernels are built once per source hash.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from evdr_tpu_torch.data.align import align_by_docid
from evdr_tpu_torch.data.npz_io import (
    load_init_payload,
    load_payload,
    save_compressed_npz,
    tokens_to_object,
)
from evdr_tpu_torch.data.packing import (
    _as_object_array,
    l2_normalize,
    preprocess_docs,
    preprocess_queries,
)
from evdr_tpu_torch.data.registry import DATASETMAP
from evdr_tpu_torch.engine import resolve_device
from evdr_tpu_torch.eval.evaluator import CustomRetrievalEvaluator, eval_retrieval
from evdr_tpu_torch.losses.distill import (
    COMBINED_RECIPES,
    LOSS_REGISTRY,
    _component_kwargs,
    combined_loss,
)
from evdr_tpu_torch.ops.maxsim import maxsim, maxsim_torch
from evdr_tpu_torch.ops.qat import qat_apply
from evdr_tpu_torch.train.config import TrainConfig
from evdr_tpu_torch.utils.logging_utils import get_logger, log_json
from evdr_tpu_torch.utils.prng import PRNGSequence, generator_for, set_seed
from evdr_tpu_torch.utils.timing import span

# loss components whose eval computation materializes (Q, N, N) pairwise
# tensors — these get the reference's >600-query chunking
# (mainv2_ranknet.py:149-161); combined recipes are checked by membership
_PAIRWISE_COMPONENTS = frozenset({"ranknet", "lambda", "ranknce"})

# losses with batch-SUM semantics (lambda_loss divides by the pair count
# only, criterion.py:148-189): eval chunks combine by sum, every other loss
# by a chunk-size-weighted mean
_BATCH_SUM_LOSSES = frozenset({"lambda"})

_ROADMAP_TRAINING = "ROADMAP.md queue 1, 'Training, the rest'"


def check_ported(cfg: TrainConfig) -> None:
    """Refuse the settings the port does not run yet (never ignore them)."""
    if cfg.checkpoint_backend == "orbax":
        raise NotImplementedError(
            "checkpoint_backend='orbax' is not ported to evdr_tpu_torch yet "
            f"({_ROADMAP_TRAINING}): it needs the orbax-checkpoint package; "
            "npz checkpoints resume in both packages")


def _needs_query_chunking(loss: str) -> bool:
    if loss in _PAIRWISE_COMPONENTS:
        return True
    return any(comp in _PAIRWISE_COMPONENTS
               for comp, _ in COMBINED_RECIPES.get(loss, ()))


def _query_chunked_loss(nq: int, loss: str, run) -> Tuple[float, Dict[str, float]]:
    """Eval-loss over test queries, chunked by 300 when the loss materializes
    (Q, N, N) pairwise tensors and the test set is large (the reference's
    tatdqa OOM guard, mainv2_ranknet.py:149-161). ``run(st, ed)`` returns
    (total, parts) for queries [st:ed); the chunk combination equals the
    unchunked value."""
    if not (nq > 600 and _needs_query_chunking(loss)):
        total, parts = run(0, nq)
        return float(total), {k: float(v) for k, v in parts.items()}
    batch_sum = loss in _BATCH_SUM_LOSSES
    total_acc, denom = 0.0, 0
    parts_acc: Dict[str, float] = {}
    for st in range(0, nq, 300):
        ed = min(st + 300, nq)
        t_c, parts_c = run(st, ed)
        w = 1 if batch_sum else ed - st
        total_acc += float(t_c) * w
        for k2, v in parts_c.items():
            parts_acc[k2] = parts_acc.get(k2, 0.0) + float(v) * w
        denom += w if not batch_sum else 0
    denom = max(denom, 1)
    if batch_sum:
        return total_acc, parts_acc
    return (total_acc / denom,
            {k2: v / denom for k2, v in parts_acc.items()})


# =============================================================================
# data bundles
# =============================================================================

@dataclass
class DatasetBundle:
    dataset: str
    Q_train: torch.Tensor          # (Mq, Lq, D) normalized
    qmask_train: torch.Tensor      # (Mq, Lq) bool
    pos_idx: Optional[np.ndarray]  # (Mq,) int gt-doc indices (supervised InfoNCE)
    Q_test: torch.Tensor
    qmask_test: torch.Tensor
    P_teacher_norm: torch.Tensor   # (N, Lp, D) masked + normalized
    pmask_teacher: torch.Tensor    # (N, Lp) bool
    docid_teacher: np.ndarray
    relevant_docs_test: Dict[str, Dict[str, int]]
    docidx_2_docid_test: Dict[str, str]
    qsidx_2_query_test: Optional[np.ndarray]
    sc_t_train: Optional[torch.Tensor] = None  # (Mq, N) precomputed teacher scores
    sc_t_test: Optional[torch.Tensor] = None   # (Qtest, N)

    @property
    def n_docs(self) -> int:
        return int(self.P_teacher_norm.shape[0])

    @property
    def device(self) -> torch.device:
        return self.P_teacher_norm.device


def _derive_pos_idx(qid, relevant_docs, docidx_2_docid) -> Tuple[np.ndarray, np.ndarray]:
    """qid -> index of the rel-max gt doc; mask of resolvable queries.

    Parity with QueryTensorDataset_gtdocs (Qdatasets/query_tensor_dataset.py:19-67).
    """
    docid2idx = {str(docid): int(di) for di, docid in docidx_2_docid.items()}
    pos = np.full(len(qid), -1, dtype=np.int64)
    for i, q in enumerate(qid):
        gt = (relevant_docs or {}).get(str(q))
        if not gt:
            continue
        gt_docid = max(gt.items(), key=lambda kv: kv[1])[0]
        pos[i] = docid2idx.get(str(gt_docid), -1)
    return pos, pos >= 0


def _precompute_teacher_scores(Q, qmask, P, pmask, chunk_q: int, chunk_p: int,
                               impl: str) -> torch.Tensor:
    """Score every query against the frozen teacher index in float32,
    chunking queries (span ``evdr.train.teacher_table``)."""
    with span("evdr.train.teacher_table"), torch.no_grad():
        outs = [maxsim(Q[qs:qs + chunk_q], P, qmask[qs:qs + chunk_q], pmask,
                       chunk_p=chunk_p, impl=impl, compute_dtype=torch.float32)
                for qs in range(0, Q.shape[0], chunk_q)]
    return torch.cat(outs, dim=0)


def _load_any(path):
    """Load an interchange (pickled-object) OR packed (dense) feature npz."""
    from evdr_tpu_torch.tools.convert_packed import is_packed, load_packed_payload

    if is_packed(path):
        return load_packed_payload(path)
    return load_payload(path)


def _queries_from(payload):
    if "Q_norm" in payload:  # packed: already normalized + masked
        return np.asarray(payload["Q_norm"]), np.asarray(payload["qmask"])
    return preprocess_queries(payload["query"], payload.get("query_attnmask"))


def _docs_from(payload):
    if "P_pad" in payload:  # packed: raw padded + composed mask
        return np.asarray(payload["P_pad"]), np.asarray(payload["pmask"])
    P_raw, pmask, _ = preprocess_docs(
        payload["documents"], payload.get("doc_attnmask"),
        payload.get("doc_imgmask"))
    return P_raw, pmask


def load_dataset_bundle(cfg: TrainConfig, dataset: str,
                        need_pos_idx: bool = False,
                        device=None) -> DatasetBundle:
    """Load + pack one dataset (ProxyQ mode or labeled-split mode) onto
    ``device`` (None: the GPU, raising when there is none).

    Feature files may be the reference's pickled-object interchange npz or
    the packed format (tools/convert_packed.py), detected per file.
    """
    device = resolve_device(device)
    paths = DATASETMAP[dataset]

    if cfg.use_labeled_split:
        # mainv1 family: teacher + train queries from the train npz, test
        # queries + eval maps from the test npz (mainv1.py:172-196)
        train_payload = _load_any(f"{cfg.teacher_root}/{paths['train']}")
        test_payload = _load_any(f"{cfg.teacher_root}/{paths['test']}")
        q_src = train_payload
        teacher_payload = train_payload
        eval_payload = test_payload
        qid = train_payload.get("qid")
    else:
        # mainv2/v3 families: ProxyQ pseudo-queries + full-dump teacher
        q_payload = _load_any(f"{cfg.query_root}/{paths['pseudoQ']}")
        teacher_payload = _load_any(f"{cfg.teacher_root}/{paths['split_before']}")
        q_src = q_payload
        eval_payload = teacher_payload
        qid = q_payload.get("qid")

    Q_train, qmask_train = _queries_from(q_src)
    Q_test, qmask_test = _queries_from(eval_payload)
    P_raw, pmask_teacher = _docs_from(teacher_payload)
    P_teacher_norm = np.asarray(
        l2_normalize(P_raw * pmask_teacher[..., None].astype(np.float32)),
        dtype=np.float32,
    )

    pos_idx = None
    if need_pos_idx:
        rel = q_src.get("relevant_docs") or teacher_payload.get("relevant_docs")
        d2d = teacher_payload.get("docidx_2_docid") or {}
        if qid is None or rel is None:
            raise ValueError(f"{dataset}: supervised loss needs qid + relevant_docs")
        pos, ok = _derive_pos_idx(qid, rel, d2d)
        if not ok.all():
            print(f"[dataset] missing gt mapping {int((~ok).sum())}/{len(ok)} -> filtered")
        Q_train, qmask_train, pos_idx = Q_train[ok], qmask_train[ok], pos[ok]
        if Q_train.shape[0] == 0:
            raise ValueError(
                f"{dataset}: no training query has a resolvable gt doc — "
                "relevant_docs must be keyed by str(qid) "
                "(Qdatasets/query_tensor_dataset.py:48 convention)")

    def dev(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    return DatasetBundle(
        dataset=dataset,
        Q_train=dev(Q_train, torch.float32),
        qmask_train=dev(qmask_train, torch.bool),
        pos_idx=pos_idx,
        Q_test=dev(Q_test, torch.float32),
        qmask_test=dev(qmask_test, torch.bool),
        P_teacher_norm=dev(P_teacher_norm, torch.float32),
        pmask_teacher=dev(pmask_teacher, torch.bool),
        docid_teacher=teacher_payload["docid"],
        relevant_docs_test=eval_payload.get("relevant_docs"),
        docidx_2_docid_test=eval_payload.get("docidx_2_docid"),
        qsidx_2_query_test=eval_payload.get("qsidx_2_query"),
    )


def init_student(cfg: TrainConfig, dataset: str, bundle: DatasetBundle, mf: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, tuple]:
    """Load the pooled init index, align to teacher docid order, pack, mask.

    Returns (param (N, Ls, D) masked f32 on the bundle's device,
    pmask_student (N, Ls) bool, (doc_attn_in, doc_img_in) object arrays for
    export parity).
    """
    paths = DATASETMAP[dataset]
    key = f"mf{mf}"
    if key not in paths:
        raise ValueError(f"Missing mapping for {dataset}:{key}")
    init_payload = load_init_payload(f"{cfg.init_root}/{paths[key]}")

    Pbar_obj = init_payload["documents"]
    doc_attn_in = init_payload["doc_attnmask"]
    doc_img_in = init_payload["doc_imgmask"]
    docid_in = init_payload.get("docid")
    if docid_in is not None:
        (Pbar_obj, doc_attn_in, doc_img_in), ok = align_by_docid(
            _as_object_array(bundle.docid_teacher), _as_object_array(docid_in),
            Pbar_obj, doc_attn_in, doc_img_in,
        )
        if ok:
            print(f"[align] {dataset} mf{mf}: init matched by docid")

    Pbar_raw, pmask_student, _ = preprocess_docs(Pbar_obj, doc_attn_in, doc_img_in)
    if Pbar_raw.shape[0] != bundle.n_docs:
        raise ValueError(
            f"init doc count mismatch: got {Pbar_raw.shape[0]} vs teacher {bundle.n_docs}")

    pm = torch.as_tensor(pmask_student, dtype=torch.bool, device=bundle.device)
    param = torch.as_tensor(Pbar_raw, dtype=torch.float32,
                            device=bundle.device) * pm[..., None]
    return param, pm, (doc_attn_in, doc_img_in)


# =============================================================================
# loss dispatch
# =============================================================================

def make_loss_fn(cfg: TrainConfig):
    """Returns loss(sc_s, sc_t, labels) -> (total, parts dict of tensors)."""
    hp = cfg.loss_hp()
    name = cfg.loss
    if name in COMBINED_RECIPES:
        def fn(sc_s, sc_t, labels=None):
            return combined_loss(name, sc_s, sc_t, hp)
        return fn
    base, needs_labels = LOSS_REGISTRY[name]
    kwargs = _component_kwargs(name, name, hp)

    if needs_labels:
        def fn(sc_s, sc_t, labels=None):
            val = base(sc_s, labels, **kwargs)
            return val, {name: val}
    else:
        def fn(sc_s, sc_t, labels=None):
            val = base(sc_s, sc_t, **kwargs)
            return val, {name: val}
    return fn


# =============================================================================
# train step
# =============================================================================

def make_optimizer(cfg: TrainConfig, param) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=wd)``: the same update rule, over the
    parameter or a list of them (a mesh's shards: AdamW is elementwise, so
    per-shard state is the global state)."""
    params = list(param) if isinstance(param, (list, tuple)) else [param]
    return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def mixup_draws(alpha: float, n_docs: int, host_rng: np.random.Generator,
                gen: torch.Generator):
    """One mixup step's draws: lambda ~ Beta(alpha, alpha) (a 0-d f32
    tensor on ``gen``'s device) from ``host_rng``, a numpy generator seeded
    by the step's seed (``torch.distributions.Beta`` takes no generator),
    and a permutation of the docs from ``gen``. Tests replace this function
    to hand the port the JAX step's draws."""
    lam = torch.tensor(host_rng.beta(alpha, alpha), dtype=torch.float32,
                       device=gen.device)
    return lam, torch.randperm(n_docs, generator=gen, device=gen.device)


def virtual_query_noise(shape, gen: torch.Generator) -> torch.Tensor:
    """Standard normal noise for the hard-token virtual queries, from the
    step's generator. Tests replace this function to hand the port the JAX
    step's noise."""
    return torch.randn(shape, generator=gen, device=gen.device)


def build_train_step(cfg: TrainConfig, bundle: DatasetBundle,
                     pmask_student: torch.Tensor, optimizer, qat_books=None):
    """One step: gather batch -> score -> loss -> AdamW, on the parameter
    that ``optimizer`` holds (updated in place).

    Returns ``run_step(idx, seed) -> parts``: ``idx`` is one batch of query
    indices (B,), or (K, B) with ``cfg.steps_per_dispatch`` K > 1; ``seed``
    seeds the step's noise generator (one draw of ``PRNGSequence``) and the
    host generator of the mixup lambda. Parts are 0-d tensors on the device
    (read them at logging cadence only). ``run_step.data["qat_books"]``
    holds the QAT-pq codebooks the step reads; the evaluation's refit swaps
    them there (the JAX step takes them as a jit argument).
    """
    loss_fn = make_loss_fn(cfg)
    needs_labels = cfg.loss == "infonce_sup"
    chunk_p = cfg.chunk_p
    aug = cfg.aug
    param = optimizer.param_groups[0]["params"][0]
    device = param.device
    n_docs = bundle.n_docs
    pmask_s = pmask_student
    pmask_f = pmask_s[..., None].to(torch.float32)
    Q_all, qm_all = bundle.Q_train, bundle.qmask_train
    sct_all = bundle.sc_t_train
    pos_all = (torch.as_tensor(bundle.pos_idx, dtype=torch.long, device=device)
               if bundle.pos_idx is not None else None)
    P_t, pm_t = bundle.P_teacher_norm, bundle.pmask_teacher
    data = {"qat_books": (None if qat_books is None else
                          torch.as_tensor(qat_books, device=device))}

    def step(idx, gen, host_rng):
        with span("evdr.train.forward"):
            Qb = Q_all[idx]
            qmb = qm_all[idx]
            labels = pos_all[idx] if needs_labels else None

            if aug == "qnoise":
                # train-only Gaussian noise on valid query tokens, then mask-
                # multiply + re-L2-normalize (mainv3_iter_liscore_noisev1.py:296-299)
                noise = torch.randn(Qb.shape, generator=gen, device=device,
                                    dtype=Qb.dtype) * cfg.q_noise_std
                qmf = qmb[..., None].to(Qb.dtype)
                Qb = l2_normalize((Qb + noise * qmf) * qmf)

            if needs_labels:
                sc_t = None
            elif sct_all is not None and aug != "qnoise":
                # precomputed rows are clean-query scores; qnoise must score the
                # teacher with the noisy queries (noisev1:305)
                sc_t = sct_all[idx]
            else:
                with torch.no_grad():
                    sc_t = maxsim_torch(Qb, P_t, qmb, pm_t, chunk_p=chunk_p)

            optimizer.zero_grad(set_to_none=True)
            P_masked = param * pmask_f
            Ps = l2_normalize(P_masked)
            if cfg.qat != "none":
                # quantization-aware distillation: score the exact serving
                # reconstruction (STE gradients); hardtoken mining below sees
                # the same form (harness.py:398-409)
                Ps = qat_apply(Ps, cfg.qat, data["qat_books"], pmask=pmask_s)
            # the student is scored by the plain differentiable op, as the JAX
            # step does (harness.py:372-373)
            sc_s = maxsim_torch(Qb, Ps, qmb, pmask_s, chunk_p=chunk_p)
            total, parts = loss_fn(sc_s, sc_t, labels)

            if aug == "mixup" and n_docs > 1:
                # document mixup (mainv3_iter_liscore_mixup.py:313-331)
                lam, perm = mixup_draws(cfg.mixup_alpha, n_docs, host_rng, gen)
                pmask_mix = pmask_s & pmask_s[perm]
                P_mix = lam * P_masked + (1.0 - lam) * P_masked[perm]
                Ps_mix = l2_normalize(P_mix * pmask_mix[..., None].to(P_mix.dtype))
                sc_s_mix = maxsim_torch(Qb, Ps_mix, qmb, pmask_mix,
                                        chunk_p=chunk_p)
                sc_t_mix = lam * sc_t + (1.0 - lam) * sc_t[:, perm]
                loss_score_mix = torch.mean((sc_s_mix - sc_t_mix.detach()) ** 2)
                loss_mix = cfg.lambda_score * loss_score_mix
                total = total + cfg.lambda_mix * loss_mix
                parts = dict(parts, mix=loss_mix, score_mix=loss_score_mix)

            if aug == "hardtoken":
                total, parts = _hardtoken_aux(cfg, total, parts, Ps, sc_s, sc_t,
                                              Qb, qmb, P_t, pm_t, pmask_s,
                                              chunk_p, gen, loss_fn)

        with span("evdr.train.backward"):
            total.backward()
        parts = {k: v.detach() for k, v in parts.items()}
        if cfg.debug_invariants:
            # masked-GRADIENT invariant (mainv1.py:74-87): gradients at
            # masked-out token positions must stay exactly 0
            g_abs = param.grad.abs().amax(dim=-1)  # (N, L)
            parts["_grad_valid_absmax"] = (g_abs * pmask_s).amax()
            parts["_grad_invalid_absmax"] = (g_abs * ~pmask_s).amax()
        with span("evdr.train.optimizer"):
            optimizer.step()
        parts["total_loss"] = total.detach()
        return parts

    def run_step(idx, seed):
        return dispatch_steps(step, idx, seed, device)

    run_step.data = data
    return run_step


def dispatch_steps(step, idx, seed, device):
    """One loop turn of a train step ``step(idx, gen, host_rng) -> parts``:
    ``idx`` is one batch (B,), or (K, B) for K steps, on a generator on
    ``device`` and a host generator both seeded by ``seed``. K steps return
    the last step's parts plus the sum of all K totals (the JAX package's
    scan, harness.py:476-483). Spans: ``evdr.train.step`` around each step
    row, ``evdr.train.feed`` around the indices' copy to the device and
    the generators (inside the step's span for one batch, before the
    first row's for K)."""
    if np.ndim(idx) == 1:
        with span("evdr.train.step"):
            return step(*_feed(idx, seed, device))
    idx, gen, host_rng = _feed(idx, seed, device)
    total_sum = torch.zeros((), dtype=torch.float32, device=device)
    for row in idx:
        with span("evdr.train.step"):
            parts = step(row, gen, host_rng)
        total_sum = total_sum + parts["total_loss"]
    parts["total_loss_sum"] = total_sum
    return parts


def _feed(idx, seed, device):
    """A dispatch's inputs: its indices on ``device`` and its device and
    host generators (span ``evdr.train.feed``)."""
    with span("evdr.train.feed"):
        return (torch.as_tensor(np.asarray(idx), dtype=torch.long,
                                device=device),
                generator_for(seed, device), np.random.default_rng(seed))


def _stable_argsort_desc(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jnp.argsort(-x)``: a stable sort of the negated values, so equal
    values keep index order (the port's rule for ``lax.top_k`` ties)."""
    return torch.argsort(-x, dim=dim, stable=True)


def _hardtoken_aux(cfg, total, parts, Ps, sc_s, sc_t, Qb, qmb, P_t, pm_t,
                   pmask_s, chunk_p, gen, loss_fn):
    """Hard-token virtual-query auxiliary loss (the JAX package's
    ``_hardtoken_aux``, ``mainv3_iter_liscore_QA_hardtoken.py:368-440``):

    1. rank gaps between the teacher's and the student's orderings, by a
       double stable argsort;
    2. per query the ``aux_docs`` docs of largest |gap| within the teacher
       top-k (stable descending sorts: ties keep index order);
    3. for each picked doc, the doc token most similar to any valid query
       token (+ noise, L2-normalized) becomes a 1-token virtual query;
    4. aux loss = the same distillation loss on the virtual queries' scores.
    """
    b, n = sc_s.shape
    k = min(int(cfg.k), n)
    a = min(int(cfg.aux_docs), k)
    if a <= 0:
        return total, parts

    sc_t_ng = sc_t.detach()
    sc_s_ng = sc_s.detach()
    rank_t = torch.argsort(_stable_argsort_desc(sc_t_ng), dim=-1, stable=True)
    rank_s = torch.argsort(_stable_argsort_desc(sc_s_ng), dim=-1, stable=True)
    gap = rank_t - rank_s                                    # exact integers

    # diagnostic: per-doc summed |rank gap|, the top docs logged every
    # gap_log_every steps (the reference's gap-log block)
    G = gap.abs().sum(dim=0)                                 # (N,)
    g_top = min(int(cfg.gap_topk), n)
    gap_top_idx = _stable_argsort_desc(G)[:g_top]
    diag = {"_gap_top_val": G[gap_top_idx].to(torch.float32),
            "_gap_top_idx": gap_top_idx}

    topk_idx = _stable_argsort_desc(sc_t_ng)[:, :k]          # (B, k)
    gap_topk = gap.gather(1, topk_idx).abs()
    aux_pos = _stable_argsort_desc(gap_topk)[:, :a]          # (B, a)
    aux_doc_idx = topk_idx.gather(1, aux_pos)                # (B, a)

    # hard token per (query, aux doc): argmax over doc tokens of the max
    # similarity to any valid query token
    flat = aux_doc_idx.reshape(-1)
    doc_tok = P_t[flat]                                      # (B*a, Lp, D)
    doc_msk = pm_t[flat]
    q_rep = Qb.repeat_interleave(a, dim=0)                   # (B*a, Lq, D)
    qm_rep = qmb.repeat_interleave(a, dim=0)
    with torch.no_grad():
        sim = torch.einsum("bld,bmd->blm", q_rep, doc_tok)
        sim = sim.masked_fill(~qm_rep[:, :, None], float("-inf"))
        max_over_q = sim.amax(dim=1).masked_fill(~doc_msk, float("-inf"))
        best_tok = torch.argmax(max_over_q, dim=1)           # first max
        hard = doc_tok[torch.arange(doc_tok.shape[0], device=doc_tok.device),
                       best_tok][:, None, :]                 # (B*a, 1, D)
        if cfg.virt_noise_std > 0:
            hard = hard + virtual_query_noise(hard.shape, gen) * \
                cfg.virt_noise_std
        qv = l2_normalize(hard)
        qmask_v = torch.ones(qv.shape[:2], dtype=torch.bool, device=qv.device)
        sc_t_v = maxsim_torch(qv, P_t, qmask_v, pm_t, chunk_p=chunk_p)
    sc_s_v = maxsim_torch(qv, Ps, qmask_v, pmask_s, chunk_p=chunk_p)
    aux_total, aux_parts = loss_fn(sc_s_v, sc_t_v, None)
    total = total + cfg.lambda_aux * aux_total
    parts = dict(parts, aux=aux_total,
                 **{f"aux_{k2}": v for k2, v in aux_parts.items()}, **diag)
    return total, parts


# =============================================================================
# eval primitives
# =============================================================================

def _test_pos_idx(bundle: DatasetBundle) -> Optional[np.ndarray]:
    """gt-doc indices for TEST queries (qrels keyed by query string);
    unresolvable queries get -1 and are dropped from the loss."""
    if bundle.relevant_docs_test is None or bundle.qsidx_2_query_test is None:
        return None
    pos, ok = _derive_pos_idx(
        bundle.qsidx_2_query_test, bundle.relevant_docs_test,
        bundle.docidx_2_docid_test or {})
    return pos if ok.all() else np.where(ok, pos, -1)


def evaluation_loss(cfg: TrainConfig, bundle: DatasetBundle, param,
                    pmask_student, qat_books=None) -> Dict[str, float]:
    """Distillation loss on test queries (mainv2_iter_liscore.py:343-370);
    for supervised InfoNCE, the gt-docs eval loss of mainv2_iter_super_infonce.
    Under ``cfg.qat`` it scores the serving reconstruction, as the step
    does."""
    loss_fn = make_loss_fn(cfg)
    with torch.no_grad():
        Ps = l2_normalize(param * pmask_student[..., None].to(torch.float32))
        if cfg.qat != "none":
            Ps = qat_apply(Ps, cfg.qat, qat_books, pmask=pmask_student)
        sc_s = maxsim_torch(bundle.Q_test, Ps, bundle.qmask_test,
                            pmask_student, chunk_p=cfg.chunk_p)
        if cfg.loss == "infonce_sup":
            pos = _test_pos_idx(bundle)
            if pos is None:
                return {"total_loss": 0.0}
            sel = np.flatnonzero(pos >= 0)  # drop queries with no resolvable gt
            if sel.size == 0:
                return {"total_loss": 0.0}
            if sel.size < len(pos):
                sc_s = sc_s[torch.as_tensor(sel, device=sc_s.device)]
                pos = pos[sel]
            total, parts = loss_fn(
                sc_s, None, torch.as_tensor(pos, dtype=torch.long,
                                            device=sc_s.device))
        else:
            if bundle.sc_t_test is not None:
                sc_t = bundle.sc_t_test
            else:
                sc_t = maxsim_torch(bundle.Q_test, bundle.P_teacher_norm,
                                    bundle.qmask_test, bundle.pmask_teacher,
                                    chunk_p=cfg.chunk_p)
            total, parts = _query_chunked_loss(
                int(sc_s.shape[0]), cfg.loss,
                lambda st, ed: loss_fn(sc_s[st:ed], sc_t[st:ed], None))
    out = {"total_loss": float(total)}
    out.update({f"loss_{k}": float(v) for k, v in parts.items()})
    return out


def _fit_qat_books(cfg: TrainConfig, Ps, pmask) -> np.ndarray:
    """Codebooks of the PQ-family QAT tiers in their serving form: compact
    (M, K, D/M) for qat='pq', expanded rotated (M, K, D) for qat='opq'
    (``ops/pq.expand_books``), fit on the host from a token sample of the
    normalized student ``Ps`` (a tensor sends only the sample there); the
    same books as the JAX package's for the same tokens and seed."""
    from evdr_tpu_torch.ops.pq import expand_books, train_opq, train_pq

    if cfg.qat == "opq":
        obooks, rot = train_opq(Ps, pmask, m=cfg.qat_pq_m, seed=cfg.seed)
        return expand_books(obooks, rot)
    return train_pq(Ps, pmask, m=cfg.qat_pq_m, seed=cfg.seed)


def update_best(best: Optional[Dict[str, Any]], metrics: Dict[str, Any],
                step: int, kind: str) -> Tuple[Dict[str, Any], bool]:
    """Best tracking with tie-breaks (mainv2_iter_liscore.py:407-426)."""
    cur_r1 = float(metrics["Recall"]["Recall@1"])
    cur_nd5 = float(metrics["NDCG"]["NDCG@5"])
    if best is None:
        return {"step": step, "Recall@1": cur_r1, "NDCG@5": cur_nd5}, True
    if kind == "r1":
        updated = (cur_r1 > best["Recall@1"]) or (
            cur_r1 == best["Recall@1"] and cur_nd5 > best["NDCG@5"])
    else:
        updated = (cur_nd5 > best["NDCG@5"]) or (
            cur_nd5 == best["NDCG@5"] and cur_r1 > best["Recall@1"])
    if not updated:
        return best, False
    return {"step": step, "Recall@1": cur_r1, "NDCG@5": cur_nd5}, True


def save_best_npz(out_dir: Path, fname: str, *, cfg: TrainConfig, dataset: str,
                  mf: int, step: int, best: Dict, metrics: Dict,
                  param, pmask_student, docid, doc_attn_in, doc_img_in,
                  qat_books=None) -> None:
    """Export the student as a compressed index npz.

    Convention parity: iter-family scripts save the UNNORMALIZED masked param
    (mainv2_iter_liscore.py:428-463); epoch-family scripts save the NORMALIZED
    student (mainv2_distill_infonce.py:364,439). Selected by cfg.trainer.
    """
    with torch.no_grad():
        P_masked = param * pmask_student[..., None].to(torch.float32)
        if cfg.trainer == "epoch":
            P_masked = l2_normalize(P_masked)
    P_np = P_masked.cpu().numpy().astype(np.float32)
    pm_np = pmask_student.cpu().numpy().astype(bool)
    docs_obj = tokens_to_object(P_np, pm_np)
    save_compressed_npz(
        Path(out_dir) / fname,
        docid=_as_object_array(docid),
        documents_obj=docs_obj,
        doc_attnmask_obj=doc_attn_in,
        doc_imgmask_obj=doc_img_in,
        meta={
            "dataset": dataset,
            "mf": mf,
            "step": int(step),
            "best_type": "Recall@1" if fname == "best_recall.npz" else "NDCG@5",
            "best": best,
            "eval": {
                "Recall@1": float(metrics["Recall"]["Recall@1"]),
                "NDCG@5": float(metrics["NDCG"]["NDCG@5"]),
            },
            "latency": float(metrics.get("latency", 0.0)),
            "loss": cfg.loss,
            "aug": cfg.aug,
            "k": cfg.k,
            "temp": cfg.temp,
            "lambda list": cfg.lambda_list,
            "lambda score": cfg.lambda_score,
            "lr": cfg.lr,
        },
        # QAT-pq: the codebooks this student was trained (and its best
        # metrics measured) against; serve with these, not a refit
        extra=({"qat_books": np.asarray(qat_books, np.float32)}
               if qat_books is not None else None),
    )


# =============================================================================
# checkpoint / resume (full train state — beyond the reference's artifacts)
# =============================================================================

def save_checkpoint(path: Path, param, optimizer, step: int, best_r1,
                    best_nd5) -> None:
    """npz in the JAX package's leaf layout: leaf_0 the parameter, leaf_1
    the Adam step count (int32), leaf_2 / leaf_3 the first / second
    moments (optax's ScaleByAdamState order). Crash-atomic (tmp + rename)."""
    count, mu, nu = _adam_state(param, optimizer)
    write_checkpoint(path, {"leaf_0": param.detach().cpu().numpy(),
                            "leaf_1": np.asarray(count, dtype=np.int32),
                            "leaf_2": mu.cpu().numpy(),
                            "leaf_3": nu.cpu().numpy()},
                     step, best_r1, best_nd5)


def _adam_state(param, optimizer):
    """(step count, first moment, second moment) of one parameter; zeros
    before the first step."""
    state = optimizer.state.get(param, {})
    if state:
        return int(state["step"]), state["exp_avg"], state["exp_avg_sq"]
    zeros = torch.zeros_like(param.detach())
    return 0, zeros, zeros


def write_checkpoint(path: Path, arrays: Dict[str, np.ndarray], step: int,
                     best_r1, best_nd5) -> None:
    """The npz of :func:`save_checkpoint` from its leaves (a mesh gathers
    them first)."""
    meta = {"step": step, "best_r1": best_r1, "best_nd5": best_nd5,
            "n_leaves": len(arrays)}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp.npz")
    try:
        np.savez(tmp, meta=np.array(meta, dtype=object), **arrays)
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()


def load_checkpoint(path: Path, device):
    """-> (param, AdamW per-parameter state, step, best_r1, best_nd5) from a
    checkpoint of either package (``convert.train_state_from_numpy``)."""
    from evdr_tpu_torch.convert import train_state_from_numpy

    z, meta = checkpoint_leaves(path)
    param, state = train_state_from_numpy(
        z["leaf_0"], z["leaf_2"], z["leaf_3"], z["leaf_1"], device)
    return param, state, meta["step"], meta["best_r1"], meta["best_nd5"]


def checkpoint_leaves(path: Path):
    """-> (the npz's leaves, its meta dict), checked to be (param, adamw
    state)."""
    z = np.load(path, allow_pickle=True)
    meta = z["meta"].item()
    if meta["n_leaves"] != 4:
        raise ValueError(f"{path}: expected the 4 leaves of (param, adamw "
                         f"state), got {meta['n_leaves']}")
    return z, meta


# =============================================================================
# doc-sharded training (mesh_docs > 1)
# =============================================================================

class MeshStudent:
    """The mesh half of :func:`train_dataset_mf` (the JAX loop's mesh
    branches, ``evdr_tpu/train/harness.py:794-981``, ``:1092-1175``).

    The student parameter and its mask shard over ``mesh`` in the JAX
    package's layout (``n_pad`` rows, a multiple of the shard count, the
    padding at the end), the teacher through ``build_sharded_index``
    (each process builds only the shards it owns); the teacher tables
    (test, and train unless qnoise rescores it) are precomputed shard by
    shard through ``maxsim(impl=cfg.score_impl)``. Every method that
    gathers is a collective: every process of the mesh calls it."""

    def __init__(self, cfg: TrainConfig, bundle: DatasetBundle, mesh,
                 param: torch.Tensor, pmask_student: torch.Tensor):
        from evdr_tpu_torch.parallel.multihost import shard_docs_global
        from evdr_tpu_torch.parallel.sharded_index import build_sharded_index
        from evdr_tpu_torch.parallel.train_sharded import (
            build_sharded_eval_loss, precompute_teacher_scores_sharded)

        self.cfg, self.bundle, self.mesh = cfg, bundle, mesh
        self.dev0 = mesh.devices[0]
        self.n_docs = bundle.n_docs
        teacher = build_sharded_index(bundle.P_teacher_norm,
                                      bundle.pmask_teacher, mesh,
                                      pad_docs_to=1)
        self.n_pad = teacher.n_pad
        self.Pt = [t.P for t in teacher.parts]
        self.pmt = [t.pmask for t in teacher.parts]
        self.params = [x.detach().clone().requires_grad_(True) for x in
                       shard_docs_global(param, mesh, n_pad=self.n_pad)]
        self.pms = shard_docs_global(pmask_student, mesh, n_pad=self.n_pad)
        self.sct_test = self.sct_train = None
        if cfg.loss != "infonce_sup":
            kw = dict(chunk_q=256, chunk_p=cfg.chunk_p, impl=cfg.score_impl)
            self.sct_test = precompute_teacher_scores_sharded(
                bundle.Q_test, bundle.qmask_test, self.Pt, self.pmt, mesh,
                **kw)
            if cfg.precompute_teacher and cfg.aug != "qnoise":
                self.sct_train = precompute_teacher_scores_sharded(
                    bundle.Q_train, bundle.qmask_train, self.Pt, self.pmt,
                    mesh, **kw)
        self.eval_loss_fn = build_sharded_eval_loss(cfg, mesh, self.n_docs)
        self.pos_test = (_test_pos_idx(bundle) if cfg.loss == "infonce_sup"
                         else None)
        self.eval_qsel = None  # supervised eval: drop queries with no gt
        if self.pos_test is not None and (self.pos_test < 0).any():
            keep = np.flatnonzero(self.pos_test >= 0)
            self.eval_qsel = torch.as_tensor(keep, device=self.dev0)
            self.pos_test = self.pos_test[keep] if keep.size else None

    def _host(self, xs) -> np.ndarray:
        from evdr_tpu_torch.parallel.multihost import gather_to_host

        return gather_to_host([x.detach() for x in xs], self.mesh)

    def student(self):
        """(param, pmask) of the real docs, gathered (for the exports)."""
        n = self.n_docs
        return (torch.from_numpy(self._host(self.params)[:n]),
                torch.from_numpy(self._host(self.pms)[:n]))

    def score_fn(self) -> torch.Tensor:
        """The test queries against every shard of the current student in
        float32 through ``maxsim(impl=cfg.eval_impl)`` (the serving form
        under QAT int8/int4: per-token, so shard-local), the score blocks
        gathered: (Q_test, n_docs) on the first device."""
        from evdr_tpu_torch.parallel.mesh import gather_blocks

        cfg, b = self.cfg, self.bundle
        blocks, copies = [], {}
        for p, pm, (_, _, dev) in zip(self.params, self.pms,
                                      self.mesh.local_shards()):
            if dev not in copies:
                copies[dev] = (b.Q_test.to(dev), b.qmask_test.to(dev))
            Q, qm = copies[dev]
            Ps = l2_normalize(p.detach() * pm[..., None].to(torch.float32))
            if cfg.qat in ("int8", "int4"):
                Ps = qat_apply(Ps, cfg.qat, pmask=pm)
            blocks.append(maxsim(Q, Ps, qm, pm, chunk_p=cfg.chunk_p,
                                 impl=cfg.eval_impl,
                                 compute_dtype=torch.float32))
        sc = torch.cat(gather_blocks(blocks, self.mesh, self.dev0), dim=1)
        return sc[:, :self.n_docs]

    def eval_loss(self) -> Dict[str, float]:
        """The distillation loss on the test queries through the collective
        forms (no index-sized gather)."""
        cfg, b = self.cfg, self.bundle
        if cfg.loss == "infonce_sup" and self.pos_test is None:
            return {"total_loss": 0.0}
        pos = (torch.as_tensor(self.pos_test, dtype=torch.long,
                               device=self.dev0)
               if self.pos_test is not None else None)
        Q, qm = b.Q_test, b.qmask_test
        if self.eval_qsel is not None:
            Q, qm = Q[self.eval_qsel], qm[self.eval_qsel]

        def run(st, ed):
            sct = (None if self.sct_test is None
                   else [s[st:ed] for s in self.sct_test])
            return self.eval_loss_fn(
                self.params, self.pms, self.Pt, self.pmt, Q[st:ed],
                qm[st:ed], sct_rows=sct,
                pos=None if pos is None else pos[st:ed])

        total, parts = _query_chunked_loss(int(Q.shape[0]), cfg.loss, run)
        out = {"total_loss": total}
        out.update({f"loss_{k}": v for k, v in parts.items()})
        return out

    def build_step(self, cfg: TrainConfig, optimizer):
        from evdr_tpu_torch.parallel.train_sharded import (
            build_sharded_train_step)

        b = self.bundle
        step, _ = build_sharded_train_step(
            cfg, self.mesh, params=self.params, pmask_student=self.pms,
            P_teacher=self.Pt, pmask_teacher=self.pmt, n_docs=self.n_docs,
            Q_all=b.Q_train, qm_all=b.qmask_train, sct_all=self.sct_train,
            pos_all=b.pos_idx, optimizer=optimizer)
        return step

    def masked_param_absmax(self) -> float:
        from evdr_tpu_torch.parallel.mesh import gather_blocks

        with torch.no_grad():
            m = [(p * ~pm[..., None]).abs().amax() for p, pm in
                 zip(self.params, self.pms)]
        return float(torch.stack(gather_blocks(m, self.mesh,
                                               self.dev0)).max())

    def resume_decision(self, resuming: bool) -> bool:
        """Process 0's decision on every process (a fork would desynchronize
        the collectives)."""
        if not self.mesh.multiprocess:
            return resuming
        import torch.distributed as dist

        flag = torch.tensor([int(resuming)], dtype=torch.int32)
        dist.broadcast(flag, src=0, group=self.mesh.ctrl_group)
        return bool(flag.item())

    def save_checkpoint(self, path, optimizer, step, best_r1, best_nd5,
                        write: bool) -> None:
        """The JAX package's mesh checkpoint: the leaves in the padded
        layout, gathered; only ``write`` (process 0) writes them."""
        states = [_adam_state(p, optimizer) for p in self.params]
        arrays = {"leaf_0": self._host(self.params),
                  "leaf_1": np.asarray(states[0][0], dtype=np.int32),
                  "leaf_2": self._host([s[1] for s in states]),
                  "leaf_3": self._host([s[2] for s in states])}
        if write:
            write_checkpoint(path, arrays, step, best_r1, best_nd5)

    def load_checkpoint(self, path):
        """Resume the shards from a checkpoint of either package: a mesh's
        (``n_pad`` rows) or a one-device run's (``n_docs`` rows,
        zero-padded onto the mesh). Sets the parameters; returns (the AdamW
        states by shard, step, best_r1, best_nd5)."""
        from evdr_tpu_torch.parallel.multihost import shard_docs_global

        z, meta = checkpoint_leaves(path)
        like = tuple(self.params[0].shape[1:])

        def shards(x):
            x = np.asarray(x, dtype=np.float32)
            if x.shape[1:] != like or x.shape[0] > self.n_pad:
                raise ValueError(f"checkpoint leaf shape {x.shape} "
                                 f"incompatible with the mesh state "
                                 f"({self.n_pad},) + {like}")
            if x.shape[0] < self.n_pad:
                x = np.pad(x, ((0, self.n_pad - x.shape[0]),)
                           + ((0, 0),) * (x.ndim - 1))
            return [t.clone() for t in
                    shard_docs_global(x, self.mesh, n_pad=self.n_pad)]

        self.params = [p.requires_grad_(True) for p in shards(z["leaf_0"])]
        count = torch.tensor(float(np.asarray(z["leaf_1"])),
                             dtype=torch.float32)
        states = [{"step": count.clone(), "exp_avg": mu, "exp_avg_sq": nu}
                  for mu, nu in zip(shards(z["leaf_2"]),
                                    shards(z["leaf_3"]))]
        return states, meta["step"], meta["best_r1"], meta["best_nd5"]


# =============================================================================
# index stream (replaces DataLoader: cycling shuffled index batches)
# =============================================================================

def index_stream(n: int, batch: int, seed: int) -> Iterator[np.ndarray]:
    """Infinite stream of shuffled index batches of EXACTLY `batch` elements
    (the reference cycles a shuffled DataLoader; leftover tail rolls into
    the next epoch's permutation). numpy, so it equals the JAX package's."""
    rng = np.random.default_rng(seed)
    buf = np.empty(0, dtype=np.int64)
    while True:
        while len(buf) < batch:
            buf = np.concatenate([buf, rng.permutation(n)])
        yield buf[:batch].astype(np.int32)
        buf = buf[batch:]


# =============================================================================
# main loops
# =============================================================================

def train_dataset_mf(cfg: TrainConfig, bundle: DatasetBundle, dataset: str,
                     mf: int, batch_stream: Optional[Iterator] = None,
                     mesh=None) -> Dict[str, Any]:
    """Train one (dataset, mf) cell on the bundle's device, or doc-sharded
    over ``mesh`` (a ``DeviceMesh`` of ``cfg.mesh_docs`` shards whose first
    device holds the bundle); returns the final summary dict.

    ``batch_stream`` (testing/parity hook) replaces the shuffled index
    stream with an externally supplied iterator of index batches."""
    check_ported(cfg)
    rngs = PRNGSequence(cfg.seed)
    param, pmask_student, (doc_attn_in, doc_img_in) = init_student(
        cfg, dataset, bundle, mf)
    # the mesh: the student and the teacher shard over the doc axis
    # (parallel/train_sharded.py); across processes every process computes
    # everything and only process 0 writes (its out_dir may be shared)
    ms = (None if mesh is None else
          MeshStudent(cfg, bundle, mesh, param, pmask_student))
    is_main = mesh is None or mesh.rank == 0

    out_dir = Path(cfg.out_root) / cfg.name / f"mf{mf}" / dataset
    if is_main:
        out_dir.mkdir(parents=True, exist_ok=True)
        logger, writer = get_logger(out_dir)
        cfg_path = out_dir / "config.json"
        if not cfg_path.exists():
            cfg_path.write_text(
                json.dumps({"dataset": dataset, "mf": mf,
                            **dataclasses.asdict(cfg)}, ensure_ascii=False,
                           indent=2),
                encoding="utf-8")
    else:
        import logging

        logger = logging.getLogger(f"evdr_follower_{os.getpid()}")
        logger.addHandler(logging.NullHandler())
        logger.propagate = False
        writer = None

    evaluator = CustomRetrievalEvaluator()
    pm_f = pmask_student[..., None].to(torch.float32)
    # QAT-pq codebooks (numpy, the form the best npz exports): fit by every
    # eval on the CURRENT student, so the STE grid tracks the drifting
    # embeddings (a grid frozen on the init measured worse than post-hoc
    # quantization; RESULTS.md QAT section). The JAX loop also fits them
    # once before the step-0 (or resume) eval, which refits them on the same
    # student; here that first eval fits them. The step reads them from
    # train_step.data, where each refit swaps them.
    qat_books = None
    train_step = None

    def eval_now(step):
        nonlocal qat_books
        if ms is not None:
            # every process scores and computes the metrics (identical
            # inputs, so identical best-tracking decisions)
            metrics = eval_retrieval(
                evaluator, bundle.Q_test, bundle.qmask_test, None, None,
                bundle.relevant_docs_test, bundle.docidx_2_docid_test,
                bundle.qsidx_2_query_test, score_fn=ms.score_fn)
            ev_loss = ms.eval_loss()
        elif cfg.qat != "none":
            # QAT: evaluate (and select best checkpoints by) the serving
            # reconstruction, not the raw f32 student (harness.py:982-1021)
            with torch.no_grad():
                P_now = l2_normalize(param.detach() * pm_f)
            if cfg.qat in ("pq", "opq"):
                qat_books = _fit_qat_books(cfg, P_now, pmask_student)
                if train_step is not None:
                    train_step.data["qat_books"] = torch.as_tensor(
                        qat_books, device=bundle.device)
            with torch.no_grad():
                Pq = qat_apply(P_now, cfg.qat, qat_books, pmask=pmask_student)

            def qat_score_fn():
                # the reconstruction is made above (serving quantizes at
                # build time); eval latency times the scoring only
                return maxsim(bundle.Q_test, Pq, bundle.qmask_test,
                              pmask_student, chunk_p=cfg.chunk_p,
                              impl=cfg.eval_impl,
                              compute_dtype=torch.float32)

            metrics = eval_retrieval(
                evaluator, bundle.Q_test, bundle.qmask_test, None, None,
                bundle.relevant_docs_test, bundle.docidx_2_docid_test,
                bundle.qsidx_2_query_test, score_fn=qat_score_fn)
            ev_loss = evaluation_loss(cfg, bundle, param.detach(),
                                      pmask_student, qat_books=qat_books)
        else:
            metrics = eval_retrieval(
                evaluator, bundle.Q_test, bundle.qmask_test, param.detach(),
                pmask_student, bundle.relevant_docs_test,
                bundle.docidx_2_docid_test, bundle.qsidx_2_query_test,
                chunk_p=cfg.chunk_p, impl=cfg.eval_impl)
            ev_loss = evaluation_loss(cfg, bundle, param.detach(),
                                      pmask_student, qat_books=qat_books)
        scalars = {
            "dataset": dataset, "mf": mf, "step": int(step),
            "eval/eval loss": ev_loss["total_loss"],
            "eval/Recall@1": float(metrics["Recall"]["Recall@1"]),
            "eval/NDCG@5": float(metrics["NDCG"]["NDCG@5"]),
            "eval/latency": float(metrics["latency"]),
        }
        scalars.update({f"eval/{k}": v for k, v in ev_loss.items() if k != "total_loss"})
        log_json(logger, scalars)
        if writer is not None:
            writer.add_scalar("eval/Recall@1", scalars["eval/Recall@1"], step)
            writer.add_scalar("eval/NDCG@5", scalars["eval/NDCG@5"], step)
            writer.add_scalar("eval/loss", ev_loss["total_loss"], step)
        return metrics

    step0 = 0
    ckpt_path = out_dir / "ckpt.npz"
    resuming = cfg.resume and ckpt_path.exists()
    if ms is not None and cfg.resume:
        resuming = ms.resume_decision(resuming)
    adam_state = None
    # QAT fine-tune selection window (cfg.qat_select_post): best-checkpoint
    # updates only from the STE switch on, so a QAT artifact is never a
    # checkpoint the quantizer never trained (harness.py:1069-1090)
    select_post = (cfg.qat != "none" and cfg.qat_start_frac > 0
                   and cfg.qat_select_post)
    if not resuming:
        # step-0 eval (regression baseline: init metrics must match the
        # pooled index); skipped on resume, the checkpoint carries the best
        # trackers
        metrics0 = eval_now(0)
        log_json(logger, {"dataset": dataset, "mf": mf, "step": 0,
                          "note": "init Pbar before training"})
        if select_post:
            best_r1 = best_nd5 = None  # seeded by the first in-window eval
            log_json(logger, {"note": "qat_select_post: best-checkpoint "
                              "window starts at the STE switch",
                              "qat_start_frac": cfg.qat_start_frac})
        else:
            best_r1, _ = update_best(None, metrics0, 0, "r1")
            best_nd5, _ = update_best(None, metrics0, 0, "nd5")
        last_metrics = metrics0
    elif ms is not None:
        adam_state, step0, best_r1, best_nd5 = ms.load_checkpoint(ckpt_path)
        log_json(logger, {"note": "resumed", "step": step0})
    else:
        param, adam_state, step0, best_r1, best_nd5 = load_checkpoint(
            ckpt_path, bundle.device)
        adam_state = [adam_state]
        log_json(logger, {"note": "resumed", "step": step0})

    if ms is None:
        param.requires_grad_(True)
    optimizer = make_optimizer(cfg, param if ms is None else ms.params)
    if adam_state:
        sd = optimizer.state_dict()
        sd["state"] = dict(enumerate(adam_state))
        optimizer.load_state_dict(sd)
    if resuming:
        # one eval of the RESTORED state: seeds last_metrics with numbers
        # that reflect the resumed index, not the discarded init
        last_metrics = eval_now(step0)

    def build_step(c):
        if ms is not None:
            return ms.build_step(c, optimizer)
        return build_train_step(c, bundle, pmask_student, optimizer,
                                qat_books=qat_books)

    def student():
        """(param, pmask) to export: the mesh's real docs, gathered."""
        if ms is not None:
            return ms.student()
        return param.detach(), pmask_student

    train_step = build_step(cfg)
    step_phase1 = None
    if cfg.qat != "none" and cfg.qat_start_frac > 0:
        # QAT fine-tune phase 1: the plain (no-STE) step, the trajectory of
        # a qat='none' run under the same seed
        step_phase1 = build_step(dataclasses.replace(cfg, qat="none"))

    n_train = int(bundle.Q_train.shape[0])
    if cfg.trainer == "iter":
        max_steps = cfg.max_steps
    else:
        steps_per_epoch = max(1, -(-n_train // cfg.q_batch)) if not cfg.full_batch else 1
        max_steps = cfg.epochs * steps_per_epoch

    if cfg.eval_every > 0:
        eval_every = cfg.eval_every
    elif cfg.trainer == "epoch":
        eval_every = steps_per_epoch  # evaluate every epoch (reference default)
    else:
        eval_every = 200  # iter-family default (mainv2_iter_liscore.py:41)

    batch = n_train if cfg.full_batch else min(cfg.q_batch, n_train)
    stream = (batch_stream if batch_stream is not None
              else index_stream(n_train, batch, cfg.seed))

    t0 = time.time()
    # the loss accumulates on the device; the host reads it at logging and
    # eval cadence only
    loss_cum = torch.zeros((), dtype=torch.float32, device=bundle.device)
    loss_cnt = 0
    log_every = max(1, cfg.print_every or 20)
    K = max(1, cfg.steps_per_dispatch)
    save_every = (cfg.save_period * (
        1 if cfg.trainer == "iter" else steps_per_epoch)
        if cfg.save_period else 0)
    checkpoint_every = cfg.checkpoint_every
    gap_log_every = cfg.gap_log_every
    if K > 1:
        # all cadences snap to multiples of K: the loop visits only those
        def _snap(x):
            return -(-x // K) * K if x else x

        eval_every = _snap(eval_every)
        log_every = _snap(log_every)
        max_steps = _snap(max_steps)
        save_every = _snap(save_every)
        checkpoint_every = _snap(checkpoint_every)
        gap_log_every = _snap(gap_log_every)
    # the QAT fine-tune's switch: dispatches whose last step is <= it run
    # the plain step, the rest the STE step; snapped to dispatch boundaries
    qat_switch = 0
    if step_phase1 is not None:
        qat_switch = int(cfg.qat_start_frac * max_steps)
        if K > 1:
            qat_switch = -(-qat_switch // K) * K
    if step0:
        if step0 % K:
            raise ValueError(
                f"resume step {step0} is not a multiple of "
                f"steps_per_dispatch={K}; resume with a value that divides "
                "the checkpoint step (e.g. the original run's)")
        # fast-forward to the resume point: a resumed run consumes the SAME
        # batch/noise sequence an uninterrupted run would
        if batch_stream is None:
            for _ in range(step0):
                next(stream)
        rngs.advance(step0 // K)
    for step in range(step0 + K, max_steps + 1, K):
        if K == 1:
            idx = next(stream)
        else:
            idx = np.stack([next(stream) for _ in range(K)])
        fn = (step_phase1 if step_phase1 is not None and step <= qat_switch
              else train_step)
        parts = fn(idx, rngs.next())
        loss_cum = loss_cum + parts.get("total_loss_sum", parts["total_loss"])
        loss_cnt += K

        if (step % log_every == 0) or (step % eval_every == 0) or (step == max_steps):
            scalar_parts = {k2: float(v) for k2, v in parts.items()
                            if not k2.startswith("_") and k2 != "total_loss_sum"}
            loss_val = scalar_parts["total_loss"]
            avg = float(loss_cum) / max(loss_cnt, 1)
            if writer is not None:
                writer.add_scalar("train/loss", loss_val, step)
                for k2, v in scalar_parts.items():
                    if k2 != "total_loss":
                        writer.add_scalar(f"train/loss_{k2}", v, step)
            if cfg.print_every:
                log_json(logger, {
                    "dataset": dataset, "mf": mf, "step": step,
                    "train/total loss": loss_val,
                    "train/avg_total_loss": avg,
                    "time_sec": float(time.time() - t0),
                    **{f"train/loss_{k2}": v
                       for k2, v in scalar_parts.items() if k2 != "total_loss"},
                })

        if ("_gap_top_val" in parts and gap_log_every
                and step % gap_log_every == 0):
            # hard-token rank-gap diagnostic (the reference's gap-log block)
            log_json(logger, {
                "dataset": dataset, "mf": mf, "step": step,
                "gaplog/top_docidx": parts["_gap_top_idx"].tolist(),
                "gaplog/top_gap": parts["_gap_top_val"].tolist(),
            })

        if cfg.debug_invariants and step % log_every == 0:
            # masked-token invariants (mainv1.py:74-87): gradients AND
            # parameters at masked-out positions must stay exactly 0
            if ms is not None:
                masked_abs = ms.masked_param_absmax()
            else:
                with torch.no_grad():
                    masked_abs = float((param * ~pmask_student[..., None])
                                       .abs().amax())
            rec = {
                "dataset": dataset, "mf": mf, "step": step,
                "debug/masked_param_absmax": masked_abs,
            }
            if "_grad_invalid_absmax" in parts:
                rec["debug/grad_valid_absmax"] = float(parts["_grad_valid_absmax"])
                rec["debug/grad_invalid_absmax"] = float(parts["_grad_invalid_absmax"])
            log_json(logger, rec)

        if save_every and step % save_every == 0:
            # periodic compressed export (mainv1.py:375-395); a mesh gathers
            # first (every process), process 0 writes
            p_exp, pm_exp = student()
            if is_main:
                save_best_npz(out_dir, f"compressed_ep{step}.npz", cfg=cfg,
                              dataset=dataset, mf=mf, step=step,
                              best={"step": step}, metrics=last_metrics,
                              param=p_exp, pmask_student=pm_exp,
                              docid=bundle.docid_teacher,
                              doc_attn_in=doc_attn_in,
                              doc_img_in=doc_img_in)

        if (step % eval_every == 0) or (step == max_steps):
            metrics = eval_now(step)
            last_metrics = metrics
            if select_post and step <= qat_switch:
                # pre-switch eval: logged for the trajectory, outside the
                # best-checkpoint window (the dispatch AT qat_switch still
                # ran the plain step)
                upd_r1 = upd_nd5 = False
            else:
                best_r1, upd_r1 = update_best(best_r1, metrics, step, "r1")
                best_nd5, upd_nd5 = update_best(best_nd5, metrics, step,
                                                "nd5")
            if upd_r1 or upd_nd5:
                # identical decisions on every process, so the mesh's
                # gathers run everywhere; only process 0 writes
                p_exp, pm_exp = student()
            if upd_r1:
                logger.info(
                    f"best recall step| {step} | nDCG@5={best_r1['NDCG@5']:.5f} | "
                    f"Recall@1={best_r1['Recall@1']:.5f} | Latency {metrics['latency']:.5f}")
                if is_main:
                    save_best_npz(out_dir, "best_recall.npz", cfg=cfg,
                                  dataset=dataset, mf=mf, step=step,
                                  best=best_r1, metrics=metrics, param=p_exp,
                                  pmask_student=pm_exp,
                                  docid=bundle.docid_teacher,
                                  doc_attn_in=doc_attn_in,
                                  doc_img_in=doc_img_in, qat_books=qat_books)
            if upd_nd5:
                logger.info(
                    f"best nDCG@5 step| {step} | nDCG@5={best_nd5['NDCG@5']:.5f} | "
                    f"Recall@1={best_nd5['Recall@1']:.5f} | Latency {metrics['latency']:.5f}")
                if is_main:
                    save_best_npz(out_dir, "best_ndcg5.npz", cfg=cfg,
                                  dataset=dataset, mf=mf, step=step,
                                  best=best_nd5, metrics=metrics, param=p_exp,
                                  pmask_student=pm_exp,
                                  docid=bundle.docid_teacher,
                                  doc_attn_in=doc_attn_in,
                                  doc_img_in=doc_img_in, qat_books=qat_books)

        if checkpoint_every and step % checkpoint_every == 0:
            if ms is not None:
                ms.save_checkpoint(ckpt_path, optimizer, step, best_r1,
                                   best_nd5, write=is_main)
            else:
                save_checkpoint(ckpt_path, param, optimizer, step, best_r1,
                                best_nd5)

    if cfg.export_packed != "none" and is_main:
        # train -> serve in one run: convert the best artifact into the
        # packed serving format (tools/convert_packed.py); 'opq' is the pq
        # tier with an OPQ rotation folded into expanded books
        src = Path(out_dir) / "best_ndcg5.npz"
        if src.exists():
            from evdr_tpu_torch.tools.convert_packed import (
                convert_payload_to_packed)

            dt = "pq" if cfg.export_packed == "opq" else cfg.export_packed
            packed = convert_payload_to_packed(
                load_payload(src), length_multiple=16, dtype=dt,
                normalize=True, pq_opq=(cfg.export_packed == "opq"),
                device=bundle.device)
            dst = Path(out_dir) / "best_ndcg5.packed.npz"
            tmpp = str(dst) + ".tmp.npz"
            np.savez(tmpp, **packed)
            os.replace(tmpp, dst)
            logger.info(json.dumps({
                "export_packed": str(dst), "dtype": cfg.export_packed}))
        else:
            logger.warning("export_packed: no best_ndcg5.npz artifact "
                           "(no eval improved on the init?)")

    summary = {
        "summary/latency": float(last_metrics.get("latency", 0.0)),
        "summary/best_recall": best_r1,
        "summary/best_ndcg5": best_nd5,
        "note": "training finished",
    }
    log_json(logger, summary)
    if writer is not None:
        writer.close()
    return summary


def run_training(cfg: TrainConfig, device=None,
                 mesh=None) -> Dict[str, Dict[str, Any]]:
    """Outer loop: datasets x mfs (reference main() skeleton), on
    ``device`` (None: the GPU, raising when there is none). With
    ``cfg.mesh_docs > 1`` it trains doc-sharded over ``mesh`` (a
    ``DeviceMesh`` of that many shards, e.g. ``mesh_of(["cpu"] * 4)`` or
    ``multihost.global_doc_mesh``), by default ``make_mesh`` over the
    first ``mesh_docs`` GPUs; the data then lie on the mesh's first
    device."""
    cfg.validate()
    check_ported(cfg)
    if cfg.mesh_docs > 1:
        if mesh is None:
            from evdr_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh(cfg.mesh_docs, device=device or "cuda")
        if mesh.size != cfg.mesh_docs or mesh.dp != 1:
            raise ValueError(f"mesh_docs={cfg.mesh_docs} needs a 1D doc mesh "
                             f"of that many shards, got {mesh.shape}")
        device = mesh.devices[0]
    elif mesh is not None:
        raise ValueError("a mesh trains with mesh_docs equal to its size "
                         f"(> 1), got mesh_docs={cfg.mesh_docs}")
    device = resolve_device(device)
    set_seed(cfg.seed)
    results = {}
    for dataset in cfg.datasets:
        bundle = load_dataset_bundle(cfg, dataset,
                                     need_pos_idx=(cfg.loss == "infonce_sup"),
                                     device=device)
        # qnoise scores the teacher with the noisy queries inline each step
        # (noisev1:305), so clean-query precomputed rows would be dead
        # weight; a mesh precomputes its tables shard by shard
        # (MeshStudent)
        if (cfg.precompute_teacher and cfg.loss != "infonce_sup"
                and cfg.aug != "qnoise" and mesh is None):
            bundle.sc_t_train = _precompute_teacher_scores(
                bundle.Q_train, bundle.qmask_train, bundle.P_teacher_norm,
                bundle.pmask_teacher, chunk_q=256, chunk_p=cfg.chunk_p,
                impl=cfg.score_impl)
        if cfg.loss != "infonce_sup" and mesh is None:
            # the supervised eval loss uses gt labels, never teacher scores
            bundle.sc_t_test = _precompute_teacher_scores(
                bundle.Q_test, bundle.qmask_test, bundle.P_teacher_norm,
                bundle.pmask_teacher, chunk_q=256, chunk_p=cfg.chunk_p,
                impl=cfg.score_impl)
        for mf in cfg.mfs:
            results[f"{dataset}/mf{mf}"] = train_dataset_mf(
                cfg, bundle, dataset, mf, mesh=mesh)
            print(f"[done] {dataset} mf{mf}")
    return results
