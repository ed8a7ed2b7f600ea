"""Back-to-back score-distillation steps: ``train/harness.build_train_step``'s
``run_step`` over ``index_stream`` batches, with the teacher table
precomputed at set-up (``_precompute_teacher_scores``), as a user distils a
compressed index for one corpus.

The configuration gives the corpus (pages, questions a page and the train
share), the student's pooling factor ``mf``, the loss and its
hyperparameters, the optimizer's and the teacher scorer. Set-up makes the
pages and queries on the device, pools the student from the pages, builds
the step and takes its first ``CHECKED_STEPS`` steps through the window's
own call and feed, keeping each step's loss, the first gradient (from the
optimizer's first moment) and the student's change; the window then goes
on with the same objects. ``train_steps_per_s``: the steps of the window
over the window, which ends when the device has finished them.
"""

from __future__ import annotations

import numpy as np
import torch

from evdr_bench import check, gen, reference
from evdr_bench.harness import Outcome

CHECKED_STEPS = 3


def make_inputs(ctx):
    """Teacher pages, train queries (``questions_per_page`` x
    ``train_share`` a page) and the pooled student, on the device."""
    cfg, dev = ctx.config, ctx.device
    n_pages = int(cfg["n_pages"])
    per_page = int(round(cfg["questions_per_page"] * cfg["train_share"]))
    P, pmask = gen.make_pages(cfg, ctx.seed, dev)
    targets = torch.arange(n_pages, device=dev).repeat_interleave(per_page)
    Q, qmask = gen.make_queries(
        cfg, P, pmask, targets, gen.generator(ctx.seed, "queries",
                                              device=dev))
    p0, pm_s = gen.pooled_init(P, pmask, int(cfg["mf"]))
    return P, pmask, Q, qmask, p0, pm_s


def ref_hp(cfg: dict) -> dict:
    """The reference's hyperparameters, from the configuration."""
    opt = cfg["optimizer"]
    return dict(opt, betas=tuple(opt["betas"]), **cfg["loss_hp"])


def gaps(got: dict, ref: dict) -> dict:
    """The compared numbers: the largest relative gap of a step's loss,
    and the gaps of the first gradient's and the change's norms."""
    return {
        "loss_gap": max(check.rel_gap(a, b)
                        for a, b in zip(got["losses"], ref["losses"])),
        "grad_gap": check.norm_gap(got["grad1"], ref["grad1"]),
        "change_gap": check.norm_gap(got["delta"], ref["delta"]),
    }


def run(ctx) -> Outcome:
    from evdr_tpu_torch.train import harness as th
    from evdr_tpu_torch.train.config import TrainConfig
    from evdr_tpu_torch.utils.prng import PRNGSequence

    cfg = ctx.config
    opt, hp = cfg["optimizer"], cfg["loss_hp"]
    n_pages = int(cfg["n_pages"])
    with ctx.span("bench.make_inputs"):
        P, pmask, Q, qmask, p0, pm_s = make_inputs(ctx)
    ctx.mark("inputs")
    tcfg = TrainConfig(loss=cfg["loss"], q_batch=int(ctx.traffic["q_batch"]),
                       seed=ctx.seed, lr=float(opt["lr"]),
                       weight_decay=float(opt["weight_decay"]),
                       k=int(hp["k"]), temp=float(hp["temp"]),
                       lambda_list=float(hp["lambda_list"]),
                       lambda_score=float(hp["lambda_score"]),
                       score_impl=cfg["teacher_impl"]).validate()
    bundle = th.DatasetBundle(
        dataset=cfg["name"], Q_train=Q, qmask_train=qmask, pos_idx=None,
        Q_test=Q[:0], qmask_test=qmask[:0], P_teacher_norm=P,
        pmask_teacher=pmask, docid_teacher=np.arange(n_pages),
        relevant_docs_test={}, docidx_2_docid_test={},
        qsidx_2_query_test=None)
    with ctx.span("bench.teacher_table"):
        bundle.sc_t_train = th._precompute_teacher_scores(
            Q, qmask, P, pmask, chunk_q=256, chunk_p=tcfg.chunk_p,
            impl=tcfg.score_impl)
    ctx.mark("teacher table")
    param = p0.clone().requires_grad_(True)
    optimizer = th.make_optimizer(tcfg, param)
    run_step = th.build_train_step(tcfg, bundle, pm_s, optimizer)
    stream = th.index_stream(Q.shape[0], tcfg.q_batch, tcfg.seed)
    rngs = PRNGSequence(tcfg.seed)
    batches, losses, grad1 = [], [], None
    for s in range(CHECKED_STEPS):
        idx = next(stream)
        batches.append(idx.copy())
        parts = run_step(idx, rngs.next())
        losses.append(float(parts["total_loss"]))
        if s == 0:
            # the first moment after one step is (1 - beta1) x the
            # gradient; a step that kept no state reads a zero gradient
            beta1 = optimizer.param_groups[0]["betas"][0]
            m1 = optimizer.state.get(param, {}).get("exp_avg")
            grad1 = (torch.zeros_like(param) if m1 is None
                     else m1 / (1.0 - beta1)).detach().clone()
            ctx.mark("first step")
    delta = (param.detach() - p0).clone()
    ctx.setup_done()
    with ctx.window() as w:
        n = 0
        while True:
            with ctx.span("bench.train_step"):
                run_step(next(stream), rngs.next())
            n += 1
            if w.elapsed() >= ctx.seconds:
                break
    peak = ctx.memory_peak()
    del bundle, optimizer, run_step, param, parts
    ctx.free()
    ref = reference.train_reference(P, pmask, Q, qmask, batches, p0, pm_s,
                                    ref_hp(cfg))
    numbers = gaps({"losses": losses, "grad1": grad1, "delta": delta}, ref)
    return Outcome(e2e={"train_steps_per_s": n / w.seconds}, attempted=n,
                   failed=0, numbers=numbers, memory_peak_bytes=peak,
                   obs={"window_s": w.seconds, "steps": n})
