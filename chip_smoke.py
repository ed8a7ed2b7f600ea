#!/usr/bin/env python3
"""Drive the torch port's serving and training paths on one NVIDIA GPU and
hold every CUDA kernel against its plain PyTorch version.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout; it needs one CUDA device, ``nvcc`` and
``nvidia-smi``, and no network. It writes its training fixture and run
under ``build/chip_smoke/`` and removes them at the end. Phases, one report
line each:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every kernel compiled from ``evdr_tpu_torch/csrc`` (seconds);
3. parity: each kernel against its plain version at the serving shape
   (256 queries x 32 tokens, 1,000 pages x 768 tokens, D = 128) with
   masked query and doc tokens, a doc with no valid token and a valid token
   of scale 0;
4. main path: RetrievalEngine.search_dense on an int8 engine with
   on-device query quantization (50,000 pages built from int8 codes), on an
   int8 engine over the same index without it, and on a bfloat16 engine
   (10,000 pages through build), each checked against the plain version;
5. entry point: tools/serve_http over the bf16 engine, GET /healthz and
   POST /search;
6. times: each kernel at the main path's shapes (median of 7 CUDA-event
   timings) beside its bound, its plain version's time (median of 3) and
   the end-to-end search_dense rate;
7. training-kernel parity: K1's float32 mode at the eval shape (1,000
   queries x 32 tokens against 1,000 student pages x 154 tokens), K5 and
   K6 at the train step's shape (32 queries x 32 tokens against the same
   pages), on tie-free random data (``untie``) and on the same data with a
   doc that has no valid token;
8. the trainer: a synthetic corpus of 1,000 pages x 640-768 tokens (D =
   128) with its pooled mf5 student is written by the port's
   write_dataset_fixture, and ``evdr_tpu_torch.train.cli.main`` trains it
   for 200 steps (teacher precompute and every eval through K1's float32
   mode); NDCG@5 must rise from step 0, the log must end with its summary
   line, and the best artifact must load and score as logged;
9. a train step through the differentiable op: the liscore loss and one
   AdamW step on the student with its pages scored by MaxSimFn (K5, then
   K6), held against the same step through maxsim_torch;
10. times of K1's float32 mode, K5 and K6 at those shapes.

Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. Any failure raises: the script exits nonzero and prints no result
line. Launch counts in the kernels line come from the main paths' runs
only: phases 4-5 (serving: K1 bf16, K2), phase 8 (the trainer: K1 float32)
and phase 9 (the train step: K5, K6), each with the counts set to 0 just
before it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM
# dense tensor-core peaks; K1's float32 mode runs on the TF32 units
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12}
NQ, LQ, D, LP = 256, 32, 128, 768
PARITY_DOCS, INT8_DOCS, BF16_DOCS = 1_000, 50_000, 10_000
K = 10
# training: a syntheticDocQA / shift-sized ViDoRe corpus (SURVEY.md:154),
# 1,000 pages x 640-768 tokens, its mf5 pooled student (~154 tokens a
# page), 1,000 test queries x 16-32 tokens, 10,000 ProxyQ train queries
# (10 per page: the reference's 50 per page reduced for time)
TRAIN_DOCS, DOC_LEN, MF = 1_000, (640, 768), 5
TEST_Q, TRAIN_Q, STEP_NQ = 1_000, 10_000, 32
TRAIN_STEPS, EVAL_EVERY = 200, 100
FIXTURE_KEY = "chipsmoke"
DEVICE = "cuda"  # the training phases' device (a CPU rehearsal sets "cpu")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


# ------------------------------------------------------------------ data


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def make_pages(n, gen, chunk=1000):
    """(n, LP, D) unit f32 tokens and a mask with ~10% invalid tokens,
    made on the device in chunks."""
    P = torch.empty((n, LP, D), dtype=torch.float32, device="cuda")
    pm = torch.empty((n, LP), dtype=torch.bool, device="cuda")
    for i in range(0, n, chunk):
        c = min(chunk, n - i)
        P[i:i + c] = unit(torch.randn((c, LP, D), device="cuda",
                                      generator=gen))
        pm[i:i + c] = torch.rand((c, LP), device="cuda", generator=gen) > 0.1
    return P, pm


def make_int8_pages(n, gen, quantize, chunk=1000):
    """int8 codes + scales + mask of n normalized pages, quantized chunk by
    chunk on the device, so no full f32 corpus is ever held."""
    codes = torch.empty((n, LP, D), dtype=torch.int8, device="cuda")
    scales = torch.empty((n, LP), dtype=torch.float32, device="cuda")
    pm = torch.empty((n, LP), dtype=torch.bool, device="cuda")
    for i in range(0, n, chunk):
        c = min(chunk, n - i)
        m = torch.rand((c, LP), device="cuda", generator=gen) > 0.1
        x = unit(torch.randn((c, LP, D), device="cuda", generator=gen)
                 * m[..., None])
        codes[i:i + c], scales[i:i + c] = quantize(x, m)
        pm[i:i + c] = m
    return codes, scales, pm


def planted_queries(tokens_of, n_docs, gen, nq=NQ):
    """Queries that each copy 32 tokens of one doc, plus noise of norm ~0.5,
    with ~15% of query tokens masked. Returns Q, qmask, the planted docs."""
    targets = (torch.arange(nq, device="cuda") * 7919 + 11) % n_docs
    pos = torch.randint(0, LP, (nq, LQ), device="cuda", generator=gen)
    base = tokens_of(targets)[torch.arange(nq, device="cuda")[:, None], pos]
    noise = torch.randn((nq, LQ, D), device="cuda", generator=gen) * (
        0.5 / D ** 0.5)
    Q = unit(base + noise)
    qm = torch.rand((nq, LQ), device="cuda", generator=gen) > 0.15
    qm[:, 0] = True
    return Q, qm, targets


# ---------------------------------------------------------------- timing


def cuda_ms(fn, reps):
    """Median, min and max of ``reps`` CUDA-event timings (ms) of fn()."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts), min(ts), max(ts)


def bound(nbytes, ops, peak):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[peak]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def tensor_bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def valid_ops(qmask, pmask):
    """2 * D operations per pair of valid query and page tokens."""
    return 2.0 * D * float(qmask.sum()) * float(pmask.sum())


def rel_err(a, b) -> float:
    """Relative Frobenius error of a against b."""
    return float((a.double() - b.double()).norm() / b.double().norm())


# -------------------------------------------------------------- training


def untie(Q, qm, P, pm, gap=1e-5, chunk=100) -> int:
    """Make random data tie-free for K6: wherever a valid query row's best
    and second-best similarity to a doc (exact, in f64, on the
    bf16-rounded operands the kernels multiply) lie within ``gap``, mask
    out the runner-up page token. Otherwise a different f32 summation
    order may pick the other one as the argmax and E = (sim == M) differs
    between K6 and its plain version, a whole token's gradient moved.
    Returns the number of tokens masked (in ``pm``, in place)."""
    rows = Q.to(torch.bfloat16).double().reshape(-1, Q.shape[-1])
    rows = rows[qm.reshape(-1)]
    masked = 0
    for _ in range(3):
        hits = 0
        for i in range(0, P.shape[0], chunk):
            sim = torch.einsum("rd,cmd->rcm", rows,
                               P[i:i + chunk].to(torch.bfloat16).double())
            sim = sim.masked_fill(~pm[i:i + chunk][None], float("-inf"))
            top = sim.topk(2, dim=-1)
            v = top.values
            r, c = ((v[..., 0] - v[..., 1] < gap)
                    & torch.isfinite(v[..., 1])).nonzero(as_tuple=True)
            pm[i + c, top.indices[r, c, 1]] = False
            hits += len(r)
        masked += hits
        if not hits:
            return masked
    raise RuntimeError("untie: near-ties remain after 3 passes")


def train_parity(cm, ct, Qe, qme, P, pm, gen, label):
    """Phase 7 on one data set: K1 float32 at the eval shape (queries Qe),
    K5 and K6 at the train step's shape (the first STEP_NQ queries)."""
    got = cm.maxsim_cuda_f32(Qe, P, qme, pm)
    torch.cuda.synchronize()
    want = cm.maxsim_plain(Qe, P, qme, pm, compute=torch.float32)
    e_f32 = float((got - want).abs().max())
    top_k = got.topk(K, dim=1).indices.sort(dim=1).values
    top_p = want.topk(K, dim=1).indices.sort(dim=1).values
    agree = float((top_k == top_p).all(dim=1).float().mean())
    Qs, qms = Qe[:STEP_NQ], qme[:STEP_NQ]
    out, M = ct.maxsim_cuda_fwd_train(Qs, P, qms, pm)
    torch.cuda.synchronize()
    out_p, M_p = ct.maxsim_fwd_train_plain(Qs, P, qms, pm)
    e_out = float((out - out_p).abs().max())
    e_m = float((M - M_p).abs().max())
    g = torch.randn((STEP_NQ, P.shape[0]), device=DEVICE, generator=gen)
    dq, dp = ct.maxsim_cuda_bwd(Qs, P, qms, pm, M, g)
    torch.cuda.synchronize()
    dq_p, dp_p = ct.maxsim_bwd_plain(Qs, P, qms, pm, M_p, g)
    e_dq, e_dp = rel_err(dq, dq_p), rel_err(dp, dp_p)
    a_grad = max(float((dq - dq_p).abs().max()), float((dp - dp_p).abs().max()))
    empty = ~pm.any(dim=1)
    log(f"phase 7 parity {label}: K1 float32 max_abs_err={e_f32:.3e} (tol "
        f"1e-4), top-{K} sets equal for {agree:.4f} of {Qe.shape[0]} queries; "
        f"K5 scores {e_out:.3e}, M {e_m:.3e} (tol 1e-4); K6 dQ {e_dq:.3e}, "
        f"dP {e_dp:.3e} relative (tol 1e-3), {a_grad:.3e} max abs; "
        f"{int(empty.sum())} empty doc(s)")
    for name, v in (("K1 float32", torch.isfinite(got).all()),
                    ("K5", torch.isfinite(out).all()),
                    ("K6", torch.isfinite(dq).all() & torch.isfinite(dp).all())):
        check(bool(v), f"{name} output finite ({label})")
    check(e_f32 <= 1e-4 and agree == 1.0, f"K1 float32 parity ({label})")
    check(e_out <= 1e-4 and e_m <= 1e-4, f"K5 parity ({label})")
    check(e_dq <= 1e-3 and e_dp <= 1e-3, f"K6 parity ({label})")
    if empty.any():
        check(float(got[:, empty].abs().max()) == 0.0
              and float(dp[empty].abs().max()) == 0.0,
              f"an empty doc scores 0 and gets no gradient ({label})")
    # name -> (max abs error, tolerance, relative error where it is checked)
    return {"maxsim_f32": (e_f32, 1e-4, None),
            "maxsim_fwd_train": (max(e_out, e_m), 1e-4, None),
            "maxsim_bwd": (a_grad, None, max(e_dq, e_dp))}


def eval_lines(log_path):
    rows = []
    for ln in log_path.read_text().splitlines():
        if '"eval/NDCG@5"' in ln or '"train/total loss"' in ln:
            rows.append(json.loads(ln[ln.index("{"):]))
    return rows


def run_trainer(cm, work, seed):
    """Phase 8: write the fixture, train through the CLI, check the run.
    Returns (its launch counts, the fixture's TrainConfig kwargs, the log's
    steps/s and eval ms/query)."""
    from evdr_tpu_torch.data.npz_io import load_init_payload
    from evdr_tpu_torch.data.synthetic import write_dataset_fixture
    from evdr_tpu_torch.train import cli

    t0 = time.perf_counter()
    data = work / "data"
    data.mkdir(parents=True)
    write_dataset_fixture(
        data, key=FIXTURE_KEY, n_docs=TRAIN_DOCS, n_test_queries=TEST_Q,
        n_train_queries=TRAIN_Q, dim=D, mfs=(MF,), seed=seed,
        init_noise=2.5, doc_len_range=DOC_LEN, query_len_range=(16, 32))
    log(f"phase 8 fixture: {TRAIN_DOCS} pages x {DOC_LEN[0]}-{DOC_LEN[1]} "
        f"tokens x {D}, {TEST_Q} test + {TRAIN_Q} train queries, mf{MF} "
        f"student, written in {time.perf_counter() - t0:.1f} s")
    kw = dict(datasets=[FIXTURE_KEY], query_root=str(data),
              teacher_root=str(data), init_root=str(data / "S3E_init"),
              mfs=[MF], out_root=str(work / "results"), name="smoke",
              seed=seed)
    argv = ["--datasets", FIXTURE_KEY, "--query_root", kw["query_root"],
            "--teacher_root", kw["teacher_root"], "--init_root",
            kw["init_root"], "--mfs", str(MF), "--out_root", kw["out_root"],
            "--name", "smoke", "--seed", str(seed), "--score_impl", "pallas",
            "--eval_impl", "auto", "--max_steps", str(TRAIN_STEPS),
            "--eval_every", str(EVAL_EVERY)]
    if DEVICE != "cuda":
        argv += ["--device", DEVICE]
    cm.reset_launch_counts()
    t1 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = cm.launch_counts()

    out_dir = work / "results" / "smoke" / f"mf{MF}" / FIXTURE_KEY
    log_path = out_dir / "train.log"
    rows = eval_lines(log_path)
    evals = [r for r in rows if "eval/NDCG@5" in r]
    trains = {r["step"]: r["time_sec"] for r in rows
              if "train/total loss" in r}
    nd0, nd_end = evals[0]["eval/NDCG@5"], evals[-1]["eval/NDCG@5"]
    # steps/s between two log lines with no eval between them
    steps_s = (EVAL_EVERY - 20) / (trains[EVAL_EVERY] - trains[20])
    eval_ms = statistics.median(r["eval/latency"] for r in evals)
    last = log_path.read_text().rstrip().splitlines()[-1]
    m = re.search(r"(\{.*\"summary/best_ndcg5\".*\})\s*$", last)
    check(m is not None, "train.log ends with the summary/best_ndcg5 line")
    best = json.loads(m.group(1))["summary/best_ndcg5"]
    init = load_init_payload(out_dir / "best_ndcg5.npz")
    check(len(init["documents"]) == TRAIN_DOCS and all(
        np.isfinite(x).all() for x in init["documents"]),
        "best_ndcg5.npz loads with finite pages")
    log(f"phase 8 trainer: {TRAIN_STEPS} steps in {wall:.1f} s (CLI wall "
        f"time, teacher precompute, fixture load and 3 evals included); "
        f"eval NDCG@5 step 0 {nd0:.5f} -> step {evals[-1]['step']} "
        f"{nd_end:.5f}, best {best}; launches {counts}")
    log(f"phase 8 trainer rate: {steps_s:.1f} steps/s (train.log, steps "
        f"20-{EVAL_EVERY}), eval {eval_ms:.4f} ms/query (median of "
        f"{len(evals)} evals, K1 float32 scoring + host copy)")
    check(nd_end > nd0, f"NDCG@5 rose from step 0 ({nd0} -> {nd_end})")
    check(counts["maxsim_cuda_f32"] > 0, "K1 float32 launched by the trainer")
    return counts, kw, init, best, steps_s, eval_ms


def check_best_artifact(bundle, init, best):
    """The best artifact, scored again by the plain f32 path (impl='xla'),
    gives the NDCG@5 the trainer logged for it through K1 float32."""
    from evdr_tpu_torch.data.packing import preprocess_docs
    from evdr_tpu_torch.eval.evaluator import (CustomRetrievalEvaluator,
                                               eval_retrieval)

    P, pm, _ = preprocess_docs(init["documents"], init["doc_attnmask"],
                               init["doc_imgmask"])
    m = eval_retrieval(
        CustomRetrievalEvaluator(), bundle.Q_test, bundle.qmask_test,
        torch.from_numpy(P).to(DEVICE), torch.from_numpy(pm).to(DEVICE),
        bundle.relevant_docs_test, bundle.docidx_2_docid_test,
        bundle.qsidx_2_query_test, impl="xla")
    nd = float(m["NDCG"]["NDCG@5"])
    log(f"phase 8 best artifact rescored by maxsim_torch: NDCG@5 {nd:.5f} "
        f"(logged {best['NDCG@5']:.5f})")
    check(abs(nd - best["NDCG@5"]) <= 2e-3, "best artifact rescored")


def train_step_phase(cm, ct, bundle, param0, pm_s):
    """Phase 9: liscore + one AdamW step with the student scored by
    MaxSimFn (K5 forward, K6 backward), against the same step through
    maxsim_torch. Returns the launch counts and the step's inputs."""
    from evdr_tpu_torch.data.packing import l2_normalize
    from evdr_tpu_torch.ops.maxsim import maxsim_torch
    from evdr_tpu_torch.train.config import TrainConfig
    from evdr_tpu_torch.train.harness import (_precompute_teacher_scores,
                                              make_loss_fn, make_optimizer)

    cfg = TrainConfig(loss="liscore")
    Qb, qmb = bundle.Q_test[:STEP_NQ], bundle.qmask_test[:STEP_NQ]
    sc_t = _precompute_teacher_scores(
        Qb, qmb, bundle.P_teacher_norm, bundle.pmask_teacher, chunk_q=256,
        chunk_p=cfg.chunk_p, impl="pallas")
    loss_fn = make_loss_fn(cfg)
    pm_f = pm_s[..., None].float()

    def step(score):
        p = param0.clone().requires_grad_(True)
        opt = make_optimizer(cfg, p)
        total, _ = loss_fn(score(l2_normalize(p * pm_f)), sc_t, None)
        opt.zero_grad(set_to_none=True)
        total.backward()
        grad = p.grad.clone()
        opt.step()
        return p.detach(), grad, float(total.detach())

    cm.reset_launch_counts()
    p_k, g_k, l_k = step(
        lambda Ps: ct.MaxSimFn.apply(Qb, Ps, qmb, pm_s, torch.bfloat16))
    torch.cuda.synchronize()
    counts = cm.launch_counts()

    def on_kernel_operands(Ps):
        # the values the kernel op multiplies (bf16-rounded Q and P), with
        # the gradient passed straight through the rounding as MaxSimFn does
        Pr = Ps + (Ps.to(torch.bfloat16).float() - Ps).detach()
        return maxsim_torch(Qb.to(torch.bfloat16).float(), Pr, qmb, pm_s,
                            chunk_p=cfg.chunk_p)

    p_r, g_r, l_r = step(on_kernel_operands)
    p_f, g_f, l_f = step(lambda Ps: maxsim_torch(Qb, Ps, qmb, pm_s,
                                                 chunk_p=cfg.chunk_p))
    e_p = rel_err(p_k, p_r)
    e_u = rel_err(p_k - param0, p_r - param0)
    log(f"phase 9 train step through MaxSimFn ({STEP_NQ} x {Qb.shape[1]} "
        f"queries, {pm_s.shape[0]} x {pm_s.shape[1]} student pages): loss "
        f"{l_k:.6f} vs {l_r:.6f} through maxsim_torch on the kernel's bf16 "
        f"operands; updated parameter relative error {e_p:.3e} (tol 1e-3), "
        f"update {e_u:.3e}, gradient {rel_err(g_k, g_r):.3e}. Against "
        f"maxsim_torch in f32: loss {l_f:.6f}, parameter {rel_err(p_k, p_f):.3e}, "
        f"gradient {rel_err(g_k, g_f):.3e}; launches {counts}")
    check(torch.isfinite(p_k).all().item(), "updated parameter finite")
    check(abs(l_k - l_r) <= 1e-4 * max(1.0, abs(l_r)), "step loss")
    check(e_p <= 1e-3, f"updated parameter through MaxSimFn ({e_p})")
    check(counts["maxsim_cuda_fwd_train"] > 0 and counts["maxsim_cuda_bwd"] > 0,
          "K5 and K6 launched by the train step")
    check(counts["maxsim_cuda"] == 0, "the grad-mode forward is K5, not K1")
    return counts, (Qb, l2_normalize(param0 * pm_f), qmb, pm_s)


def training_times(cm, ct, eval_args, step_args, gen, counts_of, parity,
                   smi):
    """Phase 10: K1 float32 at the eval shape, K5 and K6 at the train
    step's shape: median of 7 CUDA-event timings, bound, plain time."""
    Qb, Ps, qmb, pm_s = step_args
    _, M = ct.maxsim_cuda_fwd_train(Qb, Ps, qmb, pm_s)
    g = torch.randn((Qb.shape[0], Ps.shape[0]), device=DEVICE, generator=gen)
    bwd_args = (Qb, Ps, qmb, pm_s, M, g)
    nq, lq = Qb.shape[:2]
    nd, lp = pm_s.shape
    qe, pe = eval_args[2], eval_args[3]
    rows_docs = float(qmb.sum()) * float(pm_s.any(dim=1).sum())
    timed = [
        # name, wrapper, plain, args, bytes moved, operations, peak, source,
        # replaces
        ("maxsim_f32", cm.maxsim_cuda_f32,
         lambda *a: cm.maxsim_plain(*a, compute=torch.float32), eval_args,
         tensor_bytes(*eval_args) + qe.shape[0] * pe.shape[0] * 4,
         valid_ops(qe, pe), "tf32", "evdr_tpu_torch/csrc/maxsim_f32.cu",
         "evdr_tpu/ops/pallas_maxsim.py:433"),
        ("maxsim_fwd_train", ct.maxsim_cuda_fwd_train,
         ct.maxsim_fwd_train_plain, step_args,
         tensor_bytes(*step_args) + (nq + nq * lq) * nd * 4,
         valid_ops(qmb, pm_s), "bf16", "evdr_tpu_torch/csrc/maxsim_train.cu",
         "evdr_tpu/ops/pallas_maxsim_bwd.py:84"),
        # the recompute, then one page row per (query row, doc) into dQ and
        # one query row into dP (the indicator is one-hot but for ties)
        ("maxsim_bwd", ct.maxsim_cuda_bwd, ct.maxsim_bwd_plain, bwd_args,
         tensor_bytes(*bwd_args) + (nq * lq + nd * lp) * D * 4,
         valid_ops(qmb, pm_s) + 4.0 * D * rows_docs, "bf16",
         "evdr_tpu_torch/csrc/maxsim_train.cu",
         "evdr_tpu/ops/pallas_maxsim_bwd.py:168"),
    ]
    kernels = []
    for kname, kern, plain, kargs, nbytes, ops, peak, src, repl in timed:
        ms, lo, hi = cuda_ms(lambda: kern(*kargs), 7)
        plain_ms, _, _ = cuda_ms(lambda: plain(*kargs), 3)
        bms, by = bound(nbytes, ops, peak)
        log(f"phase 10 time {kname}: {ms:.3f} ms median of 7 (spread "
            f"{lo:.3f}-{hi:.3f}) at {tuple(kargs[0].shape)} queries x "
            f"{tuple(kargs[1].shape)} pages; bound {bms:.3f} ms by {by} "
            f"({peak} peak); plain {plain_ms:.3f} ms (median of 3); library: "
            f"none; {smi}")
        err, tol, rel = parity[kname]
        entry = {
            "name": kname, "route": "cuda", "source": src, "replaces": repl,
            "launches": counts_of[kname], "max_abs_err": err, "tol": tol,
            "ms": ms, "ms_min": lo, "ms_max": hi, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}
        if rel is not None:
            entry.update(rel_err=rel, rel_tol=1e-3)
        kernels.append(entry)
    return kernels


def training_phases(cm, ct, gen, seed, smi, root):
    """Phases 7-10; returns the kernels line's training entries."""
    from evdr_tpu_torch.train.config import TrainConfig
    from evdr_tpu_torch.train.harness import init_student, load_dataset_bundle

    # 7. parity at the eval and train-step shapes, random data
    n_doc_tok = -(-DOC_LEN[1] // MF)  # the student's padded page length
    Qe = unit(torch.randn((TEST_Q, LQ, D), device=DEVICE, generator=gen))
    qme = torch.rand((TEST_Q, LQ), device=DEVICE, generator=gen) > 0.15
    qme[:, 0] = True
    P = unit(torch.randn((TRAIN_DOCS, n_doc_tok, D), device=DEVICE,
                         generator=gen))
    pm = torch.rand((TRAIN_DOCS, n_doc_tok), device=DEVICE,
                    generator=gen) > 0.1
    pm[:, 0] = True
    n_untied = untie(Qe[:STEP_NQ], qme[:STEP_NQ], P, pm)
    log(f"phase 7 data: random unit tokens; {n_untied} runner-up page "
        f"token(s) within 1e-5 of a step row's max masked out (tie-free)")
    parity = train_parity(cm, ct, Qe, qme, P, pm, gen, "random")
    pm[7] = False
    for k, (a, tol, r) in train_parity(cm, ct, Qe, qme, P, pm, gen,
                                       "with an empty doc").items():
        a0, _, r0 = parity[k]
        parity[k] = (max(a, a0), tol, None if r is None else max(r, r0))
    del Qe, qme, P, pm

    # 8. the trainer
    work = root / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        trainer_counts, kw, init, best, _, _ = run_trainer(cm, work, seed)
        cfg = TrainConfig(**kw)
        bundle = load_dataset_bundle(cfg, FIXTURE_KEY, device=DEVICE)
        check_best_artifact(bundle, init, best)
        param0, pm_s, _ = init_student(cfg, FIXTURE_KEY, bundle, MF)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 9. a train step through the differentiable op
    step_counts, step_args = train_step_phase(cm, ct, bundle, param0, pm_s)

    # 10. times
    Ps0 = step_args[1]
    eval_args = (bundle.Q_test, Ps0, bundle.qmask_test, pm_s)
    counts_of = {"maxsim_f32": trainer_counts["maxsim_cuda_f32"],
                 "maxsim_fwd_train": step_counts["maxsim_cuda_fwd_train"],
                 "maxsim_bwd": step_counts["maxsim_cuda_bwd"]}
    return training_times(cm, ct, eval_args, step_args, gen, counts_of,
                          parity, smi)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs "
              "the port on a GPU only", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from evdr_tpu_torch import RetrievalEngine
        from evdr_tpu_torch.ops import _cuda_build
        from evdr_tpu_torch.ops import cuda_maxsim as cm
        from evdr_tpu_torch.ops import cuda_maxsim_train as ct
        from evdr_tpu_torch.ops.quantize import quantize_tokens_int8
        from evdr_tpu_torch.data.packing import preprocess_queries
        from evdr_tpu_torch.tools.serve_http import make_server
    except ImportError as e:
        print(f"chip_smoke: the evdr_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2

    # the plain versions are the reference: full-precision f32 matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    # 1. device ---------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"phase 1 device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s))")
    log(smi)

    # 2. build ----------------------------------------------------------
    secs = _cuda_build.build_all()
    regs = [ln.strip() for n in _cuda_build.LIBRARIES
            for ln in _cuda_build.build_log(n).splitlines()
            if "registers" in ln]
    log(f"phase 2 build: {secs:.1f} s, {len(_cuda_build.LIBRARIES)} "
        f"libraries; ptxas: {' | '.join(regs)}")

    # 3. parity at the serving shape -------------------------------------
    P, pm = make_pages(PARITY_DOCS, gen)
    pm[7] = False                     # a doc with no valid token
    P[11, 0] = 0.0                    # a valid token of scale 0
    pm[11, 0] = True
    P = P * pm[..., None]
    codes, scales = quantize_tokens_int8(P, pm)
    check(float(scales[11, 0]) == 0.0 and bool(pm[11, 0]),
          "zero-scale token present")
    Q, qm, _ = planted_queries(lambda t: P[t], PARITY_DOCS, gen)
    Pb = P.to(torch.bfloat16)
    parity_cases = {
        "maxsim_bf16": (cm.maxsim_cuda, cm.maxsim_plain,
                        (Q, Pb, qm, pm), 2e-2),
        "maxsim_int8": (cm.maxsim_cuda_int8, cm.maxsim_int8_plain,
                        (Q, codes, scales, qm, pm), 2e-2),
        "maxsim_int8full": (cm.maxsim_cuda_int8full, cm.maxsim_int8full_plain,
                            (Q, codes, scales, qm, pm), 1e-3),
    }
    parity = {}
    for kname, (kern, plain, kargs, tol) in parity_cases.items():
        got = kern(*kargs)
        torch.cuda.synchronize()
        want = plain(*kargs)
        err = float((got - want).abs().max())
        top_k = got.topk(K, dim=1).indices.sort(dim=1).values
        top_p = want.topk(K, dim=1).indices.sort(dim=1).values
        agree = float((top_k == top_p).all(dim=1).float().mean())
        empty = float(got[:, 7].abs().max())
        log(f"phase 3 parity {kname}: max_abs_err={err:.3e} (tol {tol:g}), "
            f"top-{K} sets equal for {agree:.4f} of queries, "
            f"empty doc {empty}")
        check(torch.isfinite(got).all().item(), f"{kname} finite")
        check(err <= tol, f"{kname} error {err} > {tol}")
        check(agree >= 0.99, f"{kname} top-{K} agreement {agree}")
        check(empty == 0.0, f"{kname} empty doc scores {empty}")
        parity[kname] = (err, tol)
    del P, Pb, codes, scales, Q, qm

    # 4-5. the main path ------------------------------------------------
    cm.reset_launch_counts()
    t0 = time.perf_counter()
    codes, scales, pm8 = make_int8_pages(INT8_DOCS, gen, quantize_tokens_int8)
    pm8[123] = False
    codes[123] = 0
    scales[123] = 0.0
    eng_q8 = RetrievalEngine(dtype="int8", quantize_queries=True
                             ).build_from_codes(codes, scales, pm8)
    del codes, scales
    idx8 = eng_q8.index
    eng_i8 = RetrievalEngine.from_index(idx8.P, idx8.pmask, idx8.n_docs,
                                        scales=idx8.scales, dtype="int8")
    Pf, pmf = make_pages(BF16_DOCS, gen)
    eng_bf = RetrievalEngine(dtype="bfloat16").build(Pf, pmf)
    torch.cuda.synchronize()
    log(f"phase 4 build: int8 index {INT8_DOCS} pages x {LP} x {D} "
        f"({tensor_bytes(idx8.P, idx8.scales) / 1e9:.2f} GB codes+scales), "
        f"bf16 index {BF16_DOCS} pages, {time.perf_counter() - t0:.1f} s")
    check(eng_q8.impl == "cuda_q8" and eng_i8.impl == "cuda"
          and eng_bf.impl == "cuda", "impl names")

    def dequant_tokens(t):
        return idx8.P[t].float() * idx8.scales[t][..., None]

    Q8, qm8, tgt8 = planted_queries(dequant_tokens, INT8_DOCS, gen)
    Qb, qmb, tgtb = planted_queries(lambda t: Pf[t], BF16_DOCS, gen)
    del Pf
    e2e = {}
    engines = [("int8+quantize_queries", eng_q8, Q8, qm8, tgt8,
                cm.maxsim_int8full_plain, 1e-3),
               ("int8", eng_i8, Q8, qm8, tgt8, cm.maxsim_int8_plain, 2e-2),
               ("bfloat16", eng_bf, Qb, qmb, tgtb, cm.maxsim_plain, 2e-2)]
    for label, eng, Q, qm, tgt, plain, tol in engines:
        eng.search_dense(Q, qm, k=K)  # warm
        t1 = time.perf_counter()
        vals, idx = eng.search_dense(Q, qm, k=K)  # host arrays: synced
        dt = time.perf_counter() - t1
        e2e[label] = NQ / dt
        check(vals.shape == (NQ, K) and np.isfinite(vals).all(),
              f"{label} output shape/finite")
        hit = float(np.mean(idx[:, 0] == tgt.cpu().numpy()))
        ix = eng.index
        args16 = ((Q[:16], ix.P, ix.scales, qm[:16], ix.pmask)
                  if ix.scales is not None else (Q[:16], ix.P, qm[:16],
                                                  ix.pmask))
        ref = plain(*args16)[:, :ix.n_docs]
        rv, ri = ref.topk(K, dim=1)
        top1_same = bool((ri[:, 0].cpu().numpy() == idx[:16, 0]).all())
        verr = float(np.abs(rv.cpu().numpy() - vals[:16]).max())
        log(f"phase 4 search_dense {label}: {dt * 1e3:.1f} ms for {NQ} "
            f"queries ({e2e[label]:.1f} q/s), planted doc at rank 1 for "
            f"{hit:.4f}, top-1 of 16 queries equal to the plain version: "
            f"{top1_same}, top-{K} score error {verr:.2e}")
        check(hit >= 0.99, f"{label} recall@1 {hit}")
        check(top1_same and verr <= tol, f"{label} against plain")

    # 5. entry point: the HTTP server over the bf16 engine
    srv = make_server(eng_bf, port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        check(health["impl"] == "cuda" and health["n_docs"] == BF16_DOCS,
              f"healthz {health}")
        qs = [q[m].cpu().numpy() for q, m in zip(Qb[:4], qmb[:4])]
        body = json.dumps({"queries": [q.tolist() for q in qs],
                           "k": K}).encode()
        req = urllib.request.Request(url + "/search", data=body, headers={
            "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            reply = json.loads(r.read())
        qobj = np.empty(4, dtype=object)
        qobj[:] = qs
        Qh, qmh = preprocess_queries(qobj, None, length_multiple=8)
        _, idx_direct = eng_bf.search_dense(Qh, qmh, k=K)
        top1 = [r[0] for r in reply["docids"]]
        check(top1 == [r[0] for r in eng_bf.ids_for(idx_direct)],
              "HTTP top-1 equals search_dense")
        log(f"phase 5 serve_http: /healthz {health}; /search top-1 "
            f"{top1} equals search_dense")
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    counts = cm.launch_counts()
    log(f"phase 4-5 launches: {counts}")
    for w in (cm.maxsim_cuda, cm.maxsim_cuda_int8, cm.maxsim_cuda_int8full):
        check(counts[w.__name__] > 0, f"{w.__name__} never launched on the "
                                      "serving path")

    # 6. times at the main path's shapes ---------------------------------
    i8 = (Q8, idx8.P, idx8.scales, qm8, idx8.pmask)
    bfx = eng_bf.index
    bf = (Qb, bfx.P, qmb, bfx.pmask)
    timed = [
        ("maxsim_bf16", cm.maxsim_cuda, cm.maxsim_plain, bf, "bf16",
         "evdr_tpu_torch/csrc/maxsim_bf16.cu",
         "evdr_tpu/ops/pallas_maxsim.py:433", cm.maxsim_cuda),
        ("maxsim_int8", cm.maxsim_cuda_int8, cm.maxsim_int8_plain, i8,
         "bf16", "evdr_tpu_torch/csrc/maxsim_int8.cu",
         "evdr_tpu/ops/pallas_maxsim.py:686", cm.maxsim_cuda_int8),
        ("maxsim_int8full", cm.maxsim_cuda_int8full,
         cm.maxsim_int8full_plain, i8, "int8",
         "evdr_tpu_torch/csrc/maxsim_int8.cu",
         "evdr_tpu/ops/pallas_maxsim.py:686", cm.maxsim_cuda_int8full),
    ]
    kernels = []
    for kname, kern, plain, kargs, peak, src, repl, wrapper in timed:
        ms, lo, hi = cuda_ms(lambda: kern(*kargs), 7)
        plain_ms, _, _ = cuda_ms(lambda: plain(*kargs), 3)
        qmask, pmask = kargs[-2], kargs[-1]
        out_bytes = kargs[0].shape[0] * pmask.shape[0] * 4
        bms, by = bound(tensor_bytes(*kargs) + out_bytes,
                        valid_ops(qmask, pmask), peak)
        nd = pmask.shape[0]
        log(f"phase 6 time {kname}: {ms:.3f} ms median of 7 (spread "
            f"{lo:.3f}-{hi:.3f}) at {NQ}x{LQ} queries x {nd}x{LP} pages; "
            f"bound {bms:.3f} ms by {by}; plain {plain_ms:.3f} ms (median "
            f"of 3); library: none; {smi}")
        err, tol = parity[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": repl,
            "launches": counts[wrapper.__name__], "max_abs_err": err,
            "tol": tol, "ms": ms, "ms_min": lo, "ms_max": hi,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None})
    log("phase 6 search_dense end to end: " + ", ".join(
        f"{k} {v:.1f} q/s" for k, v in e2e.items()))
    del eng_q8, eng_i8, eng_bf, idx8, bfx, i8, bf, Q8, Qb, timed, kargs, srv
    torch.cuda.empty_cache()

    # 7-10. training
    kernels += training_phases(cm, ct, gen, args.seed, smi, Path(root))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
