#!/usr/bin/env python3
"""Drive the torch port's serving (bf16, int8, int4, PQ/OPQ) and training
paths on one NVIDIA GPU and hold every CUDA kernel against its plain
PyTorch version.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout; it needs one CUDA device, ``nvcc`` and
``nvidia-smi``, and no network. It writes its training fixture and run
under ``build/chip_smoke/``, and the capacity tiers' files under
``build/chip_smoke_tiers/``, and removes them at the end. Phases, one report
line each:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every kernel compiled from ``evdr_tpu_torch/csrc`` (seconds);
3. parity: K1 and K2 against their plain versions at the serving shape
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
   timings) beside its bound (its share of the data-sheet bound; the
   mma.sync kernels' share of the ceiling scripts/mma_sync_peak.cu
   measured, in the log only), its plain version's time (median of 3) and the
   end-to-end search_dense rate; K1 bf16's and K2 int8full's wgmma
   designs (query-token rows and page tokens a tile, stages, warpgroups,
   registers, CTAs per SM, shared bytes), and K2 int8full's mma.sync loop
   timed on the same operands, its scores bit-equal to the wgmma kernel's;
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
   K6), held against the same step through maxsim_torch; K5's scores on
   the step's inputs bit-equal to K1's (K5 is K1's kernel with an M store);
10. times of K1's float32 mode at the eval shape and at the teacher
    precompute's (256 queries of the train split against the 1,000
    teacher pages), of K5 and K6 at the train step's, with K1 float32's
    CTAs per SM, K5's design (library, tile, stages, CTAs per SM,
    registers) and K6's (which recomputes on K5's wgmma products), and
    K5's scores bit-equal to K1's again;
11. capacity-tier parity at the serving shape (1,000 pages): K4 (int4 and
    int4full, at Lp 768 and at an odd Lp of 767) and K3 (pq and pqfull,
    with compact PQ books and with expanded OPQ books) against their plain
    versions, with a doc that has no valid token and a valid token of
    scale 0; K3 on the first 4, 12, 20, 36 and 68 queries (1, 3, 5, 9 and
    17 query blocks: a cluster of one and clusters with padding CTAs)
    bit-equal to the same rows of the 256-query call (clusters of 2 CTAs
    at most with compact books, of 8 with expanded ones);
12. the int4 tier: RetrievalEngine(dtype='int4') with and without
    quantize_queries over 50,000 pages whose packed codes are made on the
    device and enter through build_from_codes4;
13. the PQ tier: RetrievalEngine(dtype='pq') with and without
    quantize_queries over 50,000 pages (books trained by train_pq on a
    token sample of the first 1,000 pages, codes by encode_pq_device,
    entering through build_from_pq), and a pq_opq=True engine through
    build on 3,000 pages;
14. entry points on those 3,000 pages: tools/convert_packed writes int4 and
    pq files from an interchange npz, RetrievalEngine.from_npz and
    tools/search.main load them (rank 1 equals search_dense), and
    tools/serve_http serves the pq engine (/healthz, /search);
15. times of K4 and K3's four modes at the 50,000-page shapes, and of K3's
    expanded-books path on the same codes with expand_books of a random
    rotation (plain versions on the first 10,000 pages), with K3's cluster
    size and CTAs per SM;
16. K5 and K6 in float32 mode at the train step's shape (32 queries x 32
    tokens against 1,000 pages x 154 tokens) against their plain float32
    versions, on tie-free data and with a doc that has no valid token; one
    backward through maxsim(impl='pallas', compute_dtype=float32), the
    entry point that reaches them, against the plain versions; K5's scores
    bit-equal to K1 float32's; their times, with K5's and K6's designs
    (phase 10 gives bf16's); then MaxSimFn at D 192 in both modes
    and 256 in bf16 against the plain K5/K6 pair (300 pages), and K6 on
    planted exact ties (a duplicated page token, a zero query row) against
    its plain version in both modes;
17. K2b (``deferred=True`` of both K2 wrappers) at the serving shape:
    parity on 1,000 pages against K2's plain version and bit-equality with
    K2, also for 16 queries of 256 tokens (one launch of its 256-row
    tiles); one call of each entry point on a 50,000-page index; K2b's
    times beside K2's at Lp 768 (those 50,000 pages) and at Lp 64 (100,000
    pages, a doc ending every page tile), with its registers;
18. the rest of training, through ``evdr_tpu_torch.train.cli.main`` on
    phase 8's fixture, 200 steps each: (a) ``--aug hardtoken --qat int4``,
    (b) ``--aug mixup --qat pq --qat_start_frac 0.5``; NDCG@5 must rise
    from step 0, each log must end with its summary line, and (b)'s best
    npz must carry its codebooks and serve through
    ``RetrievalEngine.from_npz(dtype='pq')`` with rank 1 equal to the f32
    scoring of the exported reconstruction (but for near-ties);
19. every query length and width: an index of D = 72 (stored zero-padded
    to 80 at build) on every tier (bf16, int8, int4 and PQ at M = 8, each
    quantized tier with and without quantize_queries) answering queries
    of 200 tokens through search_dense, against the plain versions on the
    same index (K3 scores them in two slices of 128 and 72 tokens, K1,
    K2 and K4 in one launch of their 256-row tiles); then tools/serve_http
    over the bf16 engine, one request of 200 tokens coalesced with three of
    32 tokens, every request answered with search_dense's top-1;
20. every token width above the fast kernels' bound (256; float32 192):
    an index of D = 320 on every tier (3,000 pages x 768 tokens; PQ at
    M = 16 with compact books of 20 dims and the same codes with the books
    expanded to full width), 256 planted queries x 32 tokens through
    search_dense on the wide functions, against the plain versions; K2b's
    wide entry points bit-equal to K2's; K1 float32 at D 200 and 320;
    MaxSimFn at D 320 in both modes against the plain K5/K6 pair, the wide
    K5 bit-equal to the wide K1, the wide K6 on planted exact ties and
    bit-equal across two calls; each wide kernel's time beside its bound;
21. pruned two-stage search: 50,000 float pages (phase 4's shape) and 256
    planted queries; the summary build (4 k-means centres a page) timed;
    engines with prune_centroids=4 through build: int8 (int8 summaries,
    stage 1 on K2), the same with quantize_queries (K2's full mode), int8
    with int4 summaries (K4) and pq (bf16 summaries, K1); at 512 and
    2,500 candidates (1% and 5%) each engine's q/s, recall@1 and @10
    against its exact search, stage 1 and stage 2 timed apart by CUDA
    events, stage 1's launches by shape (Lp 4) and its bound; stage 2's
    kernel (``rerank_int8``, the int8 engines' stage 2, one launch a
    search) at the pruned benchmark cell's shape (256 x 32 queries, 416
    candidates from the quantize_queries engine's stage 1) against its
    plain version, with its time, its bound by bytes and by operations,
    and the plain version's time; gates: the
    rerank's scores equal plain exact f32 MaxSim of the returned docs, no
    index >= n_docs, and at n_candidates = n_docs (the first 2,000 pages,
    int8 and pq) the top-10 equal to exact MaxSim's at every untied rank;
    a pruned PQ npz through from_npz, tools/search.main and
    tools/serve_http (/healthz reports pruned);
22. incremental serving at the serving shape: int8 engines over 49,000
    pages with and without quantize_queries (K2's two modes), bf16 over
    10,000 (K1), int4 (K4) and pq at M = 16 (K3) over 49,000; each takes
    1,000 float pages through add in four calls (Lp 768, 768, 701, 701; 50
    of them upserting main docids) and 500 deletes (250 main, 250 tail),
    then serves 256 planted queries (half on live docs, a quarter on
    deleted ones, a quarter on the upserted pages) through the merged
    main + tail search. Gates: no deleted doc returned, recall@1 1.0 on
    the live targets, top-10 ids equal at every untied rank and scores
    within 1e-5 of a fresh engine built from the live corpus (pq: of the
    plain version on main + tail); compact() and save_npz -> from_npz
    (mmap=True, and eager for bf16) leave the top-10 as it was. A pruned
    int8 engine (prune_centroids=4, 2,000 pages) takes the same
    mutations: no deleted doc at 512 candidates or at all of them, where
    it must equal its exact merged search; after its compact,
    tools/serve_http with --save_dir answers /add, /delete, /search and
    /save (the file reloads equal), and scripts/torch_measure_rss.py
    loads a 25,000-page int8 file eagerly and memory-mapped. Times: q/s before add and with the tail and
    tombstones, the first search after the adds (the lazy tail build),
    delete, compact, save and both loads, the tail kernel's share of the
    merged search;
23. multi-device serving on the one card: (a) a 4-shard mesh (4 x
    cuda:0) over phase 4's shapes serving int8 with and without
    quantize_queries (50,000 pages), int4, PQ at M = 16 (50,000 pages, random
    codes and books) and bf16 (10,000), and a 2 x 2 (dp x docs) mesh for
    int8, each against its one-shard engine, one tier at a time; pruned
    int8 on 2,000 pages at 512 candidates and at all of them; phase 22's
    mutations on the 4-shard int8 engine; (c) a one-process NCCL group of
    2 shards; (b) two tools/serve_http --multihost processes over gloo
    (2 shards each) serving a 25,000-page int8 file: /healthz, /search,
    /add, /delete, /search, /save. Gates: top-10 ids equal and scores
    bit-equal to the one-shard engine after the same calls, one launch a
    shard (pruned: one a stage), both servers exit 0. Times: q/s of each mesh beside its
    one-shard engine's, the merge's share of a mesh top-k (CUDA events),
    the processes' start and HTTP times;
24. multi-GPU training on phase 8's fixture: (a) phase 8's run (200
    steps, --score_impl auto) through run_training on a 4-shard mesh of
    the card, after its first step is held against the one-device step
    (loss rtol 1e-5, rows atol 2e-5; the sharded teacher table against
    the one-device table) and three more steps are traced by
    utils.timing.trace_ctx (device_memory_report's peak beside); its eval
    series against phase 8's log (step 0 equal, then MESH_LOSS_RTOL /
    MESH_METRIC_ATOL), K1 float32 launched on every shard; (b) hardtoken
    + QAT int4 (its first step against one device) and mixup, 50 steps
    each, finite, the int4 artifact served through from_npz; (c) two
    ``evdr_tpu_torch.train.cli`` processes over gloo (--mesh_docs 4
    --local_shards 2, 50 steps): process 0's log equals (a)'s first 50
    steps, the follower writes nothing; (d) a one-process NCCL group of 2
    shards, 20 steps, equal to the one-process mesh. Times: steps/s and
    eval ms/query beside phase 8's, each part's seconds.

Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. Any failure raises: the script exits nonzero and prints no result
line. Launch counts in the kernels line come from the main paths' runs
only: phases 4-5 (serving: K1 bf16, K2), phase 8 (the trainer: K1 float32),
phase 9 (the train step: K5, K6), phases 12-14 (the capacity tiers: K4,
K3) and phase 20's engines (the wide functions, by kernel function),
each with the counts set to 0 just before it; K1 float32's and K3's
also by kernel function and shape (``cuda_maxsim.launch_shapes``; K3's
compact-books pq and pqfull and its expanded-books path are three
entries). The float32 modes of
K5/K6 and K2b have no trainer or engine path, in the JAX package either
(its student is scored by maxsim_xla, its engine never passes
``deferred``): their launches come from their entry points' calls in
phases 16, 17 and 20, with the counts set to 0 just before each. Phase
21's stage 1 launches (K1, K2, K4 at Lp 4) join the entries of K1 bf16,
K2 and K4 as ``pruned_stage1_launches``, and phase 22's merged main +
tail searches (counts set to 0 just before each) those of K1 bf16, K2,
K4 and K3 (compact books) as ``incremental_launches``, and phase 23's
mesh searches (counts set to 0 just before each) as
``sharded_launches``, and phase 24 (a)'s mesh run (counts set to 0 just
before it) K1 float32's as ``mesh_train_launches``. Stage 2's kernel
(``rerank_int8``) counts the launches of phase 21's pruned searches on the
int8 engines (counts set to 0 just before each).
"""

from __future__ import annotations

import argparse
import dataclasses
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
from collections import Counter
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM
# dense tensor-core peaks; K1's float32 mode runs on the TF32 units
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12}
# what mma.sync reached on an NVIDIA H100 80GB HBM3 at 700.00 W, the
# ceiling of the kernels that issue it (scripts/mma_sync_peak.cu, the top of
# its 1-4 CTAs per SM; PERF.md section 3); not measured by this script, so
# the shares it gives stand in the phase 6 log only, never in the kernels
# line, and none for K1 bf16 and K2 int8full, which issue wgmma
MMA_SYNC_OPS = {"bf16": 634.3e12, "int8": 1275.9e12, "tf32": 317.2e12}
NQ, LQ, D, LP = 256, 32, 128, 768
PARITY_DOCS, INT8_DOCS, BF16_DOCS = 1_000, 50_000, 10_000
K = 10
# the capacity tiers: 50,000-page int4 and PQ indexes (M = 16 bytes a
# token), an OPQ engine and the entry points on 3,000 pages (over 2M
# tokens, so convert_packed encodes on the GPU, as the JAX package does);
# books train on 16,384 sampled tokens (train_pq's default is 65,536; the
# OPQ build keeps it) and the plain versions are timed on 10,000 pages
INT4_DOCS, PQ_DOCS, OPQ_DOCS, PQ_M = 50_000, 50_000, 3_000, 16
PQ_SAMPLE, PLAIN_TIME_DOCS = 16_384, 10_000
# K2b's short-page shape: 100,000 pages x 64 tokens (0.82 GB of codes), a
# doc ending every page tile
SHORT_DOCS, SHORT_LP = 100_000, 64
# every query length and width (phase 19): 3,000 pages of D = 72 (stored
# zero-padded to 80) and queries of 200 tokens (K1 and K3 score them in
# two slices, 128 + 72 tokens; K2 and K4 take 256 in one launch)
SHAPES_DOCS, SHAPES_D, SHAPES_LQ, SHAPES_PQ_M = 3_000, 72, 200, 8
# every width (phase 20): 3,000 pages x 768 tokens at D = 320, above the
# fast kernels' 256 (PQ at M = 16: compact books of 20 dims, and the same
# codes with the books expanded to full width), K1 float32 also at D 200
# (above its 192); the plain versions timed on the first 1,000 pages
WIDE_DOCS, WIDE_D, WIDE_PQ_M, WIDE_F32_DS = 3_000, 320, 16, (200, 320)
PLAIN_WIDE_DOCS = 1_000
# pruned search (phase 21): phase 4's shape as float pages, 4 k-means
# centres a page (the engine's default), 1% and 5% of the pages as
# candidates; the full-cover gate and the files on the first 2,000 pages
PRUNE_DOCS, PRUNE_K, PRUNE_CANDS = 50_000, 4, (512, 2_500)
PRUNE_FULL_DOCS = 2_000
# stage 2's kernel timed at the pruned benchmark cell's shape: 256 x 32
# queries, 416 candidates (1% of M3DocVQA's 41,005 pages) of 768 x 128
PRUNE_CELL_CANDS = 416
# incremental serving (phase 22): main indexes of 49,000 pages (bf16
# 10,000), 1,000 pages added in four calls (the last two of 701 tokens),
# 50 of them upserting main docids, 250 main and 250 tail docs deleted;
# the pruned engine on 2,000 pages; the host-memory tool on 25,000 int8
# pages (~2.5 GB); the save -> eager from_npz round trip on the bf16
# engine (the others: mmap only; the eager loader dequantizes or decodes a
# 49,000-page file into 19 GB of host f32, the slowest step phase 22
# would have)
INC_DOCS, INC_BF16_DOCS, INC_ADD_LP = 49_000, 10_000, (LP, LP, 701, 701)
INC_ADD, INC_UPSERT, INC_DELETE = 1_000, 50, 250
INC_PRUNE_DOCS, INC_PRUNE_CANDS, RSS_DOCS = 2_000, 512, 25_000
INC_EAGER = ("bfloat16",)
# multi-device serving (phase 23): 4 shards of the one card (and a 2 x 2
# dp x docs mesh for int8) over phase 4's shapes, pruned int8 on
# PRUNE_FULL_DOCS pages; a 25,000-page int8 file served by two
# serve_http --multihost processes (gloo, 2 shards each; 16 queries over
# HTTP) and a one-process NCCL group of 2 shards
MESH_SHARDS, MESH_FILE_DOCS, MESH_HTTP_NQ, MESH_SPAWN_S = 4, 25_000, 16, 300
# multi-GPU training (phase 24): phase 8's run on MESH_SHARDS shards of the
# card; hardtoken + QAT int4 and mixup runs; two training CLI processes
# (gloo, 2 shards each); a one-process NCCL group of 2 shards; a few mesh
# steps traced. The log series of a mesh run may differ from one device's
# by float32 summation order only: losses within MESH_LOSS_RTOL relative,
# NDCG@5 and Recall@1 within MESH_METRIC_ATOL over 200 steps (measured on
# an NVIDIA H100 80GB HBM3 at 700.00 W: 1.5e-6 and 1.3e-4, one query's
# rank change among the 1,000)
MESH_TRAIN_STEPS_AUG, MESH_PROC_STEPS, MESH_NCCL_STEPS = 50, 50, 20
MESH_TRACE_STEPS = 3
MESH_LOSS_RTOL, MESH_METRIC_ATOL = 1e-4, 2e-3
# training: a syntheticDocQA / shift-sized ViDoRe corpus (SURVEY.md:154),
# 1,000 pages x 640-768 tokens, its mf5 pooled student (~154 tokens a
# page), 1,000 test queries x 16-32 tokens, 10,000 ProxyQ train queries
# (10 per page: the reference's 50 per page reduced for time)
TRAIN_DOCS, DOC_LEN, MF = 1_000, (640, 768), 5
TEST_Q, TRAIN_Q, STEP_NQ = 1_000, 10_000, 32
TRAIN_STEPS, EVAL_EVERY = 200, 100
FIXTURE_KEY = "chipsmoke"
DEVICE = "cuda"  # the phases' device (a CPU rehearsal sets "cpu")


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
    P = torch.empty((n, LP, D), dtype=torch.float32, device=DEVICE)
    pm = torch.empty((n, LP), dtype=torch.bool, device=DEVICE)
    for i in range(0, n, chunk):
        c = min(chunk, n - i)
        P[i:i + c] = unit(torch.randn((c, LP, D), device=DEVICE,
                                      generator=gen))
        pm[i:i + c] = torch.rand((c, LP), device=DEVICE, generator=gen) > 0.1
    return P, pm


def make_int8_pages(n, gen, quantize, chunk=1000, rows=None,
                    dtype=torch.int8, lp=LP):
    """int8 codes (or, with ``rows`` and ``dtype``, packed int4 codes) +
    scales + mask of n normalized pages of ``lp`` tokens, quantized chunk by
    chunk on the device, so no full f32 corpus is ever held."""
    codes = torch.empty((n, lp if rows is None else rows, D), dtype=dtype,
                        device=DEVICE)
    scales = torch.empty((n, lp), dtype=torch.float32, device=DEVICE)
    pm = torch.empty((n, lp), dtype=torch.bool, device=DEVICE)
    for i in range(0, n, chunk):
        c = min(chunk, n - i)
        m = torch.rand((c, lp), device=DEVICE, generator=gen) > 0.1
        x = unit(torch.randn((c, lp, D), device=DEVICE, generator=gen)
                 * m[..., None])
        codes[i:i + c], scales[i:i + c] = quantize(x, m)
        pm[i:i + c] = m
    return codes, scales, pm


def planted_queries(tokens_of, n_docs, gen, nq=NQ, lq=LQ):
    """Queries that each copy ``lq`` tokens of one doc, plus noise of norm
    ~0.5, with ~15% of query tokens masked. Returns Q, qmask, the planted
    docs."""
    targets = (torch.arange(nq, device=DEVICE) * 7919 + 11) % n_docs
    pages = tokens_of(targets)
    d = pages.shape[-1]
    pos = torch.randint(0, pages.shape[1], (nq, lq), device=DEVICE,
                        generator=gen)
    base = pages[torch.arange(nq, device=DEVICE)[:, None], pos]
    noise = torch.randn((nq, lq, d), device=DEVICE, generator=gen) * (
        0.5 / d ** 0.5)
    Q = unit(base + noise)
    qm = torch.rand((nq, lq), device=DEVICE, generator=gen) > 0.15
    qm[:, 0] = True
    return Q, qm, targets


def check_engine(phase, label, eng, Q, qm, tgt, plain, tol):
    """search_dense over planted queries: recall@1 of the planted doc must
    be >= 0.99, and against the plain version on the engine's own index,
    top-1 of 16 queries equal and the top-K scores within ``tol``. Returns
    the queries/s of the timed call (after a warm one)."""
    from evdr_tpu_torch.parallel.sharded_index import pad_queries

    nq = Q.shape[0]
    eng.search_dense(Q, qm, k=K)  # warm
    t1 = time.perf_counter()
    vals, idx = eng.search_dense(Q, qm, k=K)  # host arrays: synced
    dt = time.perf_counter() - t1
    check(vals.shape == (nq, K) and np.isfinite(vals).all(),
          f"{label} output shape/finite")
    hit = float(np.mean(idx[:, 0] == tgt.cpu().numpy()))
    ix = eng.index
    Q = pad_queries(Q, ix)  # an index of D off 16 is stored zero-padded
    if ix.books is not None:
        args16 = (Q[:16], ix.P, qm[:16], ix.pmask, ix.books)
    elif ix.scales is not None:
        args16 = (Q[:16], ix.P, ix.scales, qm[:16], ix.pmask)
    else:
        args16 = (Q[:16], ix.P, qm[:16], ix.pmask)
    ref = plain(*args16)[:, :ix.n_docs]
    rv, ri = ref.topk(K, dim=1)
    top1_same = bool((ri[:, 0].cpu().numpy() == idx[:16, 0]).all())
    verr = float(np.abs(rv.cpu().numpy() - vals[:16]).max())
    log(f"phase {phase} search_dense {label}: {dt * 1e3:.1f} ms for {nq} "
        f"queries ({nq / dt:.1f} q/s), planted doc at rank 1 for "
        f"{hit:.4f}, top-1 of 16 queries equal to the plain version: "
        f"{top1_same}, top-{K} score error {verr:.2e} (tol {tol:g})")
    check(hit >= 0.99, f"{label} recall@1 {hit}")
    check(top1_same and verr <= tol, f"{label} against plain")
    return nq / dt


def check_http(phase, eng, Q, qm):
    """tools/serve_http over ``eng``: GET /healthz, then POST /search with 4
    of the queries; its top-1 must equal search_dense's."""
    from evdr_tpu_torch.data.packing import preprocess_queries
    from evdr_tpu_torch.tools.serve_http import make_server

    srv = make_server(eng, port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        check(health["impl"] == eng.impl and health["n_docs"] == eng.n_docs
              and health["dtype"] == eng.dtype, f"healthz {health}")
        qs = [q[m].cpu().numpy() for q, m in zip(Q[:4], qm[:4])]
        body = json.dumps({"queries": [q.tolist() for q in qs],
                           "k": K}).encode()
        req = urllib.request.Request(url + "/search", data=body, headers={
            "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            reply = json.loads(r.read())
        qobj = np.empty(4, dtype=object)
        qobj[:] = qs
        Qh, qmh = preprocess_queries(qobj, None, length_multiple=8)
        _, idx_direct = eng.search_dense(Qh, qmh, k=K)
        top1 = [r[0] for r in reply["docids"]]
        check(top1 == [r[0] for r in eng.ids_for(idx_direct)],
              "HTTP top-1 equals search_dense")
        log(f"phase {phase} serve_http: /healthz {health}; /search top-1 "
            f"{top1} equals search_dense")
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)


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


def launch_shapes(cm, wrapper, func=None):
    """The launches of one wrapper (and kernel function) since the counts
    were last set to 0, by shape: [{nq, lq, nd, lp, launches}, ...]."""
    return [{"nq": nq, "lq": lq, "nd": nd, "lp": lp, "launches": n}
            for (w, f, nq, lq, nd, lp), n in sorted(cm.launch_shapes.items())
            if w == wrapper and func in (None, f)]


def int8full_mma(cm, Q, P_i8, scales, qmask, pmask):
    """K2 int8full's mma.sync loop (``evdr_maxsim_int8full``) on the
    operands ``maxsim_cuda_int8full`` hands its route, at D = 128 and Lq <=
    256: the kernel the wgmma one is held to bit for bit."""
    nq, lq, d = Q.shape
    nd, lp = pmask.shape
    qk, qw = cm.quantize_queries_int8(Q, qmask)
    out = torch.empty((nq, nd), dtype=torch.float32, device=Q.device)
    cm.call_kernel("maxsim_int8", "evdr_maxsim_int8full",
                   (qk, qw, P_i8, scales, pmask, out), nq, lq, nd, lp, d,
                   aligned=(qk, P_i8))
    return out


def ptxas_registers(build, lib, tag=""):
    """The register counts ptxas reported for each kernel of ``lib`` whose
    mangled name holds ``tag``."""
    regs = re.findall(r"Function properties for (\S+)\n.*\n.*Used (\d+) "
                      r"registers", build.build_log(lib))
    return [int(r) for n, r in regs if tag in n]


def k5_design(cm, build, dtype):
    """K5's launch at width D: K1's kernel with the M store (its library,
    query-token rows a CTA, page tokens a tile, stages, CTAs per SM from the
    occupancy API; bf16: shared bytes and whether M goes out in runs of a
    CTA's docs), and the ptxas registers of its instantiations (the
    STORE_M = true ones)."""
    if dtype == torch.float32:
        per_sm, rows, cols = cm.f32_occupancy(D, train=True)
        return dict(library="maxsim_f32", ctas_per_sm=per_sm, rows=rows,
                    tile_tokens=cols, stages=2,
                    registers=ptxas_registers(build, "maxsim_f32", "Lb1E"))
    return dict(cm.bf16_config(D, train=True), library="maxsim_bf16",
                registers=ptxas_registers(build, "maxsim_bf16", "Lb1E"))


def k6_design(ct, build, dtype, nq, lq):
    """K6's launch at the train step's shape: cluster size, ring stages,
    page tiles a cluster barrier, CTAs per SM, clusters the card holds at
    once, shared bytes, and the ptxas registers of its D = 128
    instantiation."""
    n_qb = -(-nq // (ct.ROW_CAP["maxsim_train"] // lq))
    cluster = ct.bwd_cluster(min(n_qb, ct.MAX_QB_BLOCKS))
    cfg = ct.bwd_config(dtype, D, cluster)
    mode = 3 if dtype == torch.float32 else 0  # maxsim_tile.cuh Mode
    tag = f"maxsim_bwd_kernelILi{mode}ELi{-(-D // 64)}E"
    return dict(cfg, cluster=cluster,
                registers=ptxas_registers(build, "maxsim_train", tag))


def rel_err(a, b) -> float:
    """Relative Frobenius error of a against b."""
    return float((a.double() - b.double()).norm() / b.double().norm())


# -------------------------------------------------------------- training


def untie(Q, qm, P, pm, gap=1e-5, chunk=100, dtype=torch.bfloat16) -> int:
    """Make random data tie-free for K6: wherever a valid query row's best
    and second-best similarity to a doc (exact, in f64, on the operands
    the kernels multiply, rounded to ``dtype``) lie within ``gap``, mask
    out the runner-up page token. Otherwise a different f32 summation
    order may pick the other one as the argmax and E = (sim == M) differs
    between K6 and its plain version, a whole token's gradient moved.
    Returns the number of tokens masked (in ``pm``, in place)."""
    rows = Q.to(dtype).double().reshape(-1, Q.shape[-1])
    rows = rows[qm.reshape(-1)]
    masked = 0
    for _ in range(3):
        hits = 0
        for i in range(0, P.shape[0], chunk):
            sim = torch.einsum("rd,cmd->rcm", rows,
                               P[i:i + chunk].to(dtype).double())
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
    shapes = launch_shapes(cm, "maxsim_cuda_f32")

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
        f"{nd_end:.5f}, best {best}; launches {counts}; K1 float32 by "
        f"shape {shapes}")
    log(f"phase 8 trainer rate: {steps_s:.1f} steps/s (train.log, steps "
        f"20-{EVAL_EVERY}), eval {eval_ms:.4f} ms/query (median of "
        f"{len(evals)} evals, K1 float32 scoring + host copy)")
    check(nd_end > nd0, f"NDCG@5 rose from step 0 ({nd0} -> {nd_end})")
    check(counts["maxsim_cuda_f32"] > 0, "K1 float32 launched by the trainer")
    return counts, kw, init, best, steps_s, eval_ms, shapes


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
    args = (Qb, l2_normalize(param0 * pm_f), qmb, pm_s)
    same = torch.equal(ct.maxsim_cuda_fwd_train(*args)[0],
                       cm.maxsim_cuda(*args))
    log(f"phase 9 K5's scores on the step's inputs bit-equal to K1's: {same}")
    check(same, "K5's scores equal K1's (phase 9)")
    return counts, args


def training_times(cm, ct, build, eval_args, teacher_args, step_args, gen,
                   counts_of, f32_shapes, parity, smi):
    """Phase 10: K1 float32 at the teacher precompute's shape and at the
    eval shape, K5 and K6 at the train step's shape: median of 7 CUDA-event
    timings, bound, plain time."""
    Qb, Ps, qmb, pm_s = step_args
    _, M = ct.maxsim_cuda_fwd_train(Qb, Ps, qmb, pm_s)
    g = torch.randn((Qb.shape[0], Ps.shape[0]), device=DEVICE, generator=gen)
    bwd_args = (Qb, Ps, qmb, pm_s, M, g)
    nq, lq = Qb.shape[:2]
    nd, lp = pm_s.shape
    rows_docs = float(qmb.sum()) * float(pm_s.any(dim=1).sum())

    def f32_plain(*a):
        return cm.maxsim_plain(*a, compute=torch.float32)

    def f32_bound(a):
        return bound(tensor_bytes(*a) + a[0].shape[0] * a[3].shape[0] * 4,
                     valid_ops(a[2], a[3]), "tf32")

    # K1 float32 at its two shapes on the trainer's path, each held to its
    # plain version on the same inputs; the kernels line gives the teacher
    # precompute's (most of its launches) and both
    f32_times = {}
    for label, args in (("teacher", teacher_args), ("eval", eval_args)):
        err = (cm.maxsim_cuda_f32(*args) - f32_plain(*args)).abs().max().item()
        check(err <= 1e-4, f"maxsim_f32 at the {label} shape against its "
                           f"plain version ({err})")
        ms, lo, hi = cuda_ms(lambda: cm.maxsim_cuda_f32(*args), 7)
        plain_ms, _, _ = cuda_ms(lambda: f32_plain(*args), 3)
        bms, by = f32_bound(args)
        n = sum(x["launches"] for x in f32_shapes
                if (x["nd"], x["lp"]) == tuple(args[3].shape))
        f32_times[label] = dict(
            nq=args[0].shape[0], lq=args[0].shape[1], nd=args[3].shape[0],
            lp=args[3].shape[1], launches=n, max_abs_err=err, tol=1e-4,
            ms=ms, ms_min=lo, ms_max=hi, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by)
        per_sm, rows, cols = cm.f32_occupancy(D)
        f32_times[label].update(ctas_per_sm=per_sm, tile=[rows, cols])
        log(f"phase 10 time maxsim_f32 at the {label} shape: {ms:.3f} ms "
            f"median of 7 (spread {lo:.3f}-{hi:.3f}) at "
            f"{tuple(args[0].shape)} queries x {tuple(args[1].shape)} "
            f"pages, {n} launches of this page shape in phase 8; max abs "
            f"error against the plain version {err:.3e} (tol 1e-4); bound "
            f"{bms:.3f} ms by {by} (tf32 peak); plain {plain_ms:.3f} ms "
            f"(median of 3); tile {rows} x {cols}, {per_sm} CTAs per SM; "
            f"{smi}")
    timed = [
        # name, wrapper, plain, args, bytes moved, operations, peak, source,
        # replaces
        ("maxsim_f32", cm.maxsim_cuda_f32, f32_plain, teacher_args,
         None, None, "tf32", "evdr_tpu_torch/csrc/maxsim_f32.cu",
         "evdr_tpu/ops/pallas_maxsim.py:433"),
        ("maxsim_fwd_train", ct.maxsim_cuda_fwd_train,
         ct.maxsim_fwd_train_plain, step_args,
         tensor_bytes(*step_args) + (nq + nq * lq) * nd * 4,
         valid_ops(qmb, pm_s), "bf16", "evdr_tpu_torch/csrc/maxsim_bf16.cu",
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
        err, tol, rel = parity[kname]
        entry = {
            "name": kname, "route": "cuda", "source": src, "replaces": repl,
            "launches": counts_of[kname], "max_abs_err": err, "tol": tol,
            "library_ms": None}
        if kname == "maxsim_f32":
            t = f32_times["teacher"]
            # every number of the entry at the teacher shape (phase 7's
            # eval-shape parity stays in its own check)
            entry.update({k: t[k] for k in ("max_abs_err", "tol", "ms",
                                            "ms_min", "ms_max", "plain_ms",
                                            "bound_ms", "bound_by")})
            entry.update(shapes=[dict(x, label=k)
                                 for k, x in f32_times.items()],
                         launches_by_shape=f32_shapes)
            kernels.append(entry)
            continue
        ms, lo, hi = cuda_ms(lambda: kern(*kargs), 7)
        plain_ms, _, _ = cuda_ms(lambda: plain(*kargs), 3)
        bms, by = bound(nbytes, ops, peak)
        log(f"phase 10 time {kname}: {ms:.3f} ms median of 7 (spread "
            f"{lo:.3f}-{hi:.3f}) at {tuple(kargs[0].shape)} queries x "
            f"{tuple(kargs[1].shape)} pages; bound {bms:.3f} ms by {by} "
            f"({peak} peak); plain {plain_ms:.3f} ms (median of 3); library: "
            f"none; {smi}")
        entry.update(ms=ms, ms_min=lo, ms_max=hi, plain_ms=plain_ms,
                     bound_ms=bms, bound_by=by)
        if rel is not None:
            entry.update(rel_err=rel, rel_tol=1e-3)
        if kname == "maxsim_fwd_train":
            same = torch.equal(kern(*kargs)[0], cm.maxsim_cuda(*kargs))
            entry.update(design=k5_design(cm, build, torch.bfloat16),
                         same_as_k1=same)
            log(f"phase 10 K5 bf16 design: {entry['design']} (K1's wgmma + "
                f"TMA kernel with the M store, 64-token tiles, the width K6 "
                f"recomputes); scores bit-equal to K1's: {same}")
            check(same, "K5's scores equal K1's (phase 10)")
        if kname == "maxsim_bwd":
            entry["design"] = k6_design(ct, build, torch.bfloat16, nq, lq)
            log(f"phase 10 K6 bf16 design: {entry['design']} (its "
                f"recompute on K5's wgmma m64n64k16 products, each 128 x 64 "
                f"tile by two warpgroups; a cluster of the chunk's query "
                f"blocks, sparse hit masks, four page tiles a cluster "
                f"barrier)")
        kernels.append(entry)
    return kernels


def training_phases(cm, ct, gen, seed, smi, work):
    """Phases 7-10; returns the kernels line's training entries, the
    fixture's dataset bundle and phase 8's run (its config's kwargs, rates
    and log series). The fixture stays under ``work`` for phases 18 and
    24."""
    from evdr_tpu_torch.ops import _cuda_build as build
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
    trainer_counts, kw, init, best, steps_s, eval_ms, f32_shapes = \
        run_trainer(cm, work, seed)
    cfg = TrainConfig(**kw)
    phase8 = {"kw": kw, "steps_s": steps_s, "eval_ms": eval_ms,
              "lines": run_lines(cfg)}
    bundle = load_dataset_bundle(cfg, FIXTURE_KEY, device=DEVICE)
    check_best_artifact(bundle, init, best)
    param0, pm_s, _ = init_student(cfg, FIXTURE_KEY, bundle, MF)

    # 9. a train step through the differentiable op
    step_counts, step_args = train_step_phase(cm, ct, bundle, param0, pm_s)

    # 10. times
    Ps0 = step_args[1]
    eval_args = (bundle.Q_test, Ps0, bundle.qmask_test, pm_s)
    # one chunk of the teacher precompute (chunk_q=256, harness.py)
    teacher_args = (bundle.Q_train[:256], bundle.P_teacher_norm,
                    bundle.qmask_train[:256], bundle.pmask_teacher)
    counts_of = {"maxsim_f32": trainer_counts["maxsim_cuda_f32"],
                 "maxsim_fwd_train": step_counts["maxsim_cuda_fwd_train"],
                 "maxsim_bwd": step_counts["maxsim_cuda_bwd"]}
    return training_times(cm, ct, build, eval_args, teacher_args, step_args,
                          gen, counts_of, f32_shapes, parity, smi), bundle, \
        phase8


# -------------------------------------------------------- capacity tiers


def pq_tokens(codes, books):
    """(n, Lp, M) PQ codes + compact (M, K, D/M) books -> (n, Lp, D) f32
    tokens: the subspaces' centroids, concatenated."""
    m = books.shape[0]
    return books[torch.arange(m, device=codes.device), codes.long()
                 ].flatten(-2)


def parity_case(phase, kname, label, kern, plain, kargs, tol, empty_doc):
    """One kernel call against its plain version on the same inputs:
    max abs error within ``tol``, top-K sets equal for >= 99% of queries,
    ``empty_doc`` (no valid token) scoring exactly 0. Returns the error."""
    got = kern(*kargs)
    torch.cuda.synchronize()
    want = plain(*kargs)
    err = float((got - want).abs().max())
    top_k = got.topk(K, dim=1).indices.sort(dim=1).values
    top_p = want.topk(K, dim=1).indices.sort(dim=1).values
    agree = float((top_k == top_p).all(dim=1).float().mean())
    empty = float(got[:, empty_doc].abs().max())
    log(f"phase {phase} parity {kname} ({label}): max_abs_err={err:.3e} "
        f"(tol {tol:g}), top-{K} sets equal for {agree:.4f} of queries, "
        f"empty doc {empty}")
    check(torch.isfinite(got).all().item(), f"{kname} ({label}) finite")
    check(err <= tol, f"{kname} ({label}) error {err} > {tol}")
    check(agree >= 0.99, f"{kname} ({label}) top-{K} agreement {agree}")
    check(empty == 0.0, f"{kname} ({label}) empty doc scores {empty}")
    return err


def tier_parity(cm, gen, seed):
    """Phase 11: K4 (int4, int4full; Lp 768 and 767) and K3 (pq, pqfull;
    compact and expanded OPQ books) against their plain versions at the
    serving shape, with a doc that has no valid token and a valid token of
    scale 0. Returns {kernel: (largest error, its tolerance)}."""
    from evdr_tpu_torch.ops.int4 import quantize_tokens_int4
    from evdr_tpu_torch.ops.pq import encode_pq_device, expand_books, train_pq

    P, pm = make_pages(PARITY_DOCS, gen)
    pm[7] = False                     # a doc with no valid token
    P[11, 0] = 0.0                    # a valid token of scale 0
    pm[11, 0] = True
    P = P * pm[..., None]
    Q, qm, _ = planted_queries(lambda t: P[t], PARITY_DOCS, gen)
    cases = []
    for lp in (LP, LP - 1):           # an odd Lp leaves a pad nibble a page
        pml = pm[:, :lp].contiguous()
        packed, sc = quantize_tokens_int4(P[:, :lp], pml)
        check(float(sc[11, 0]) == 0.0 and bool(pml[11, 0]),
              "zero-scale int4 token present")
        kargs = (Q, packed, sc, qm, pml)
        cases += [("maxsim_int4", f"Lp {lp}", cm.maxsim_cuda_int4,
                   cm.maxsim_int4_plain, kargs, 2e-2),
                  ("maxsim_int4full", f"Lp {lp}", cm.maxsim_cuda_int4full,
                   cm.maxsim_int4full_plain, kargs, 1e-3)]
    books = train_pq(P, pm, m=PQ_M, sample=PQ_SAMPLE, seed=seed)
    # expanded books: the same books with a random rotation folded in
    # (random unit tokens are isotropic: the books fit the rotated space
    # as well as the original one)
    rng = np.random.default_rng(seed)
    rot = np.linalg.qr(rng.normal(size=(D, D)))[0].astype(np.float32)
    for label, b, r in (("compact books", books, None),
                        ("expanded OPQ books", expand_books(books, rot), rot)):
        codes = encode_pq_device(P, books, pm, rot=r)
        kargs = (Q, codes, qm, pm, torch.from_numpy(b).to(DEVICE))
        # pqfull scores int8 x int8 on compact books; on expanded ones it
        # casts the int8 queries up and scores in bf16, as pq does (both
        # wrappers then run the expanded-books kernel)
        ex = "" if r is None else "_expanded"
        cases += [("maxsim_pq" + ex, label + ", pq", cm.maxsim_cuda_pq,
                   cm.maxsim_pq_plain, kargs, 2e-2),
                  (("maxsim_pqfull" if r is None else "maxsim_pq_expanded"),
                   label + ", pqfull", cm.maxsim_cuda_pqfull,
                   cm.maxsim_pqfull_plain, kargs, 1e-3 if r is None else 2e-2)]
    parity = {}
    for kname, label, kern, plain, kargs, tol in cases:
        err = parity_case(11, kname, label, kern, plain, kargs, tol, 7)
        if kname not in parity or err > parity[kname][0]:
            parity[kname] = (err, tol)
        if kern in (cm.maxsim_cuda_pq, cm.maxsim_cuda_pqfull):
            # fewer query blocks: a cluster of one, and clusters whose last
            # CTAs are padding; the decode's split changes no value
            full = kern(*kargs)
            compact = kname != "maxsim_pq_expanded"
            sizes = []
            for nq in (4, 12, 20, 36, 68):
                sub = (kargs[0][:nq], kargs[1], kargs[2][:nq], *kargs[3:])
                check(torch.equal(kern(*sub), full[:nq]),
                      f"{kname} ({label}) on {nq} queries equals the "
                      f"256-query call")
                sizes.append(f"{nq} queries: C="
                             f"{cm.pq_cluster(nq, LQ, compact)}")
            log(f"phase 11 partial clusters {kname} ({label}): bit-equal to "
                f"the 256-query call (C={cm.pq_cluster(NQ, LQ, compact)}) "
                f"at " + ", ".join(sizes))
    return parity


def tier_engines(cm, gen, seed, e2e):
    """Phases 12-13: the int4 and PQ engines over 50,000 pages (codes made
    on the device) and an OPQ engine through build. Each serves planted
    queries through search_dense (check_engine). Returns the timing phase's
    arguments, the OPQ pages and their planted queries."""
    from evdr_tpu_torch import RetrievalEngine
    from evdr_tpu_torch.ops.int4 import quantize_tokens_int4
    from evdr_tpu_torch.ops.pq import encode_pq_device, train_pq

    # 12. int4: packed codes + scales, made chunk by chunk on the device
    t0 = time.perf_counter()
    packed, sc, pm4 = make_int8_pages(INT4_DOCS, gen, quantize_tokens_int4,
                                      rows=(LP + 1) // 2, dtype=torch.uint8)
    pm4[123] = False
    packed[123] = 0
    sc[123] = 0.0
    eng4q = RetrievalEngine(dtype="int4", quantize_queries=True
                            ).build_from_codes4(packed, sc, pm4)
    del packed, sc
    ix4 = eng4q.index
    eng4 = RetrievalEngine.from_index(ix4.P, ix4.pmask, ix4.n_docs,
                                      scales=ix4.scales, dtype="int4")
    torch.cuda.synchronize()
    log(f"phase 12 build: int4 index {INT4_DOCS} pages x {LP} x {D} "
        f"({tensor_bytes(ix4.P) / 1e9:.2f} GB packed codes + "
        f"{tensor_bytes(ix4.scales) / 1e9:.2f} GB scales), "
        f"{time.perf_counter() - t0:.1f} s")
    base = "cuda" if DEVICE == "cuda" else "plain"  # plain: a CPU rehearsal
    check(eng4q.impl == base + "_q8" and eng4.impl == base, "int4 impl names")

    def int4_tokens(t):
        return cm.unpack_int4_torch(ix4.P[t], LP).float() * ix4.scales[t][
            ..., None]

    Q4, qm4, tgt4 = planted_queries(int4_tokens, INT4_DOCS, gen)
    e2e["int4+quantize_queries"] = check_engine(
        12, "int4+quantize_queries", eng4q, Q4, qm4, tgt4,
        cm.maxsim_int4full_plain, 1e-3)
    e2e["int4"] = check_engine(12, "int4", eng4, Q4, qm4, tgt4,
                               cm.maxsim_int4_plain, 2e-2)
    args4 = (Q4, ix4.P, ix4.scales, qm4, ix4.pmask)
    del eng4q, eng4

    # 13. PQ: books trained on a token sample of the first 1,000 pages,
    # codes encoded on the device chunk by chunk
    t0 = time.perf_counter()
    Pc, pmc = make_pages(1_000, gen)
    books = train_pq(Pc, pmc, m=PQ_M, sample=PQ_SAMPLE, seed=seed)
    t_train = time.perf_counter() - t0
    codes = torch.empty((PQ_DOCS, LP, PQ_M), dtype=torch.uint8,
                        device=DEVICE)
    pmq = torch.empty((PQ_DOCS, LP), dtype=torch.bool, device=DEVICE)
    for i in range(0, PQ_DOCS, 1_000):
        if i:
            Pc, pmc = make_pages(min(1_000, PQ_DOCS - i), gen)
        codes[i:i + Pc.shape[0]] = encode_pq_device(Pc, books, pmc)
        pmq[i:i + Pc.shape[0]] = pmc
    del Pc, pmc
    pmq[123] = False
    codes[123] = 0
    engpq_q = RetrievalEngine(dtype="pq", quantize_queries=True
                              ).build_from_pq(codes, books, pmq)
    del codes
    ixq = engpq_q.index
    engpq = RetrievalEngine.from_index(ixq.P, ixq.pmask, ixq.n_docs,
                                       books=ixq.books, dtype="pq")
    torch.cuda.synchronize()
    log(f"phase 13 build: PQ index {PQ_DOCS} pages x {LP} tokens x M="
        f"{PQ_M} ({tensor_bytes(ixq.P) / 1e9:.2f} GB codes, books "
        f"{tuple(ixq.books.shape)}), train_pq on {PQ_SAMPLE} sampled tokens "
        f"{t_train:.1f} s, in all {time.perf_counter() - t0:.1f} s")
    check(engpq_q.impl == base + "_q8" and engpq.impl == base
          and engpq.dim == D, "pq impl names and dim")
    Qp, qmp, tgtp = planted_queries(lambda t: pq_tokens(ixq.P[t], ixq.books),
                                    PQ_DOCS, gen)
    e2e["pq+quantize_queries"] = check_engine(
        13, "pq+quantize_queries", engpq_q, Qp, qmp, tgtp,
        cm.maxsim_pqfull_plain, 1e-3)
    e2e["pq"] = check_engine(13, "pq", engpq, Qp, qmp, tgtp,
                             cm.maxsim_pq_plain, 2e-2)
    argspq = (Qp, ixq.P, qmp, ixq.pmask, ixq.books)
    del engpq_q, engpq

    # 13. OPQ through build: train_opq on the host at its default sample,
    # the codes encoded on the device, served with expanded books
    Po, pmo = make_pages(OPQ_DOCS, gen)
    t0 = time.perf_counter()
    engo = RetrievalEngine(dtype="pq", pq_opq=True).build(Po, pmo)
    torch.cuda.synchronize()
    log(f"phase 13 build: OPQ engine on {OPQ_DOCS} pages through build "
        f"(books {tuple(engo.index.books.shape)}), "
        f"{time.perf_counter() - t0:.1f} s")
    check(engo.impl == base and engo.index.books_expanded
          and engo.dim == D, "OPQ engine: expanded books, impl, dim")
    Qo, qmo, tgto = planted_queries(lambda t: Po[t], OPQ_DOCS, gen)
    e2e["pq+opq"] = check_engine(13, "pq+opq", engo, Qo, qmo, tgto,
                                 cm.maxsim_pq_plain, 2e-2)
    return args4, argspq, (Po, pmo, Qo, qmo, tgto)


def tier_entry_points(opq_data, work):
    """Phase 14: tools/convert_packed writes int4 and pq files from an
    interchange npz of the OPQ pages; RetrievalEngine.from_npz and
    tools/search.main load each (rank 1 equals search_dense, planted doc
    at rank 1), and tools/serve_http serves the pq engine."""
    from evdr_tpu_torch import RetrievalEngine
    from evdr_tpu_torch.data.npz_io import tokens_to_object
    from evdr_tpu_torch.tools import convert_packed, search

    P, pm, Q, qm, tgt = opq_data
    nq = min(64, Q.shape[0])
    t0 = time.perf_counter()
    src = work / "pages.npz"
    np.savez(src, documents=tokens_to_object(P.cpu().numpy(),
                                             pm.cpu().numpy()),
             query=tokens_to_object(Q[:nq].cpu().numpy(),
                                    qm[:nq].cpu().numpy()),
             docid=np.asarray([f"page-{i}" for i in range(P.shape[0])],
                              dtype=object),
             qid=np.asarray([f"q{i}" for i in range(nq)], dtype=object))
    log(f"phase 14 interchange npz: {P.shape[0]} pages, {nq} queries, "
        f"{src.stat().st_size / 1e9:.2f} GB, {time.perf_counter() - t0:.1f} s")
    want = [f"page-{int(t)}" for t in tgt[:nq]]
    pq_eng = None
    for dtype in ("int4", "pq"):
        out = work / f"pages.{dtype}.npz"
        t0 = time.perf_counter()
        convert_packed.main(["--in_npz", str(src), "--out_npz", str(out),
                             "--dtype", dtype, "--normalize",
                             "--length_multiple", "16"])
        t_conv = time.perf_counter() - t0
        eng = RetrievalEngine.from_npz(out, dtype=dtype)
        if dtype == "int4":
            check(eng.index.P.dtype == torch.uint8
                  and eng.index.scales is not None, "int4 codes served")
        else:
            check(eng.index.books is not None and eng.dim == D,
                  "pq codes served")
        payload = convert_packed.load_packed_payload(out)
        _, idx = eng.search_dense(payload["Q_norm"], payload["qmask"], k=K)
        direct = [r[0] for r in eng.ids_for(idx)]
        run = work / f"run.{dtype}.json"
        search.main(["--index", str(out), "--queries", str(out), "--dtype",
                     dtype, "--k", str(K), "--format", "json", "--out",
                     str(run)])
        ranked = json.loads(run.read_text())
        cli = [next(iter(ranked[f"q{i}"])) for i in range(nq)]
        hit = float(np.mean([a == b for a, b in zip(direct, want)]))
        log(f"phase 14 {dtype} file: convert_packed {t_conv:.1f} s "
            f"({out.stat().st_size / 1e9:.3f} GB); from_npz and search.main "
            f"rank 1 equal: {cli == direct}; planted doc at rank 1 for "
            f"{hit:.4f} of {nq} queries")
        check(cli == direct, f"{dtype}: search CLI rank 1 equals search_dense")
        check(hit >= 0.99, f"{dtype} file recall@1 {hit}")
        if dtype == "pq":
            pq_eng = eng
    check_http(14, pq_eng, Q, qm)


def tier_times(cm, args4, argspq, counts, pq_shapes, parity, smi, seed):
    """Phase 15: K4 and K3's four modes at the 50,000-page shapes, and K3's
    expanded-books path on the same codes (books expanded with a random
    rotation, as phase 11's): median of 7 CUDA-event timings, bound, the
    plain version's time on the first PLAIN_TIME_DOCS pages; K3's cluster
    size and CTAs per SM."""
    from evdr_tpu_torch.ops.pq import expand_books

    n = PLAIN_TIME_DOCS
    Q4, P4, sc4, qm4, pm4 = args4
    Qp, cp, qmp, pmp, books = argspq
    rng = np.random.default_rng(seed)
    rot = np.linalg.qr(rng.normal(size=(D, D)))[0].astype(np.float32)
    books_ex = torch.from_numpy(expand_books(books.cpu().numpy(), rot)).to(
        DEVICE)
    argsex = (Qp, cp, qmp, pmp, books_ex)
    slice4 = (Q4, P4[:n], sc4[:n], qm4, pm4[:n])
    slicepq = (Qp, cp[:n], qmp, pmp[:n], books)
    sliceex = (Qp, cp[:n], qmp, pmp[:n], books_ex)
    timed = [
        # name, wrapper, plain, args, the plain version's args, peak, source,
        # replaces
        ("maxsim_int4", cm.maxsim_cuda_int4, cm.maxsim_int4_plain, args4,
         slice4, "bf16", "evdr_tpu_torch/csrc/maxsim_int4.cu",
         "evdr_tpu/ops/pallas_maxsim.py:1413"),
        ("maxsim_int4full", cm.maxsim_cuda_int4full, cm.maxsim_int4full_plain,
         args4, slice4, "int8", "evdr_tpu_torch/csrc/maxsim_int4.cu",
         "evdr_tpu/ops/pallas_maxsim.py:1413"),
        # the PQ decode counts as bytes (codes and books read once)
        ("maxsim_pq", cm.maxsim_cuda_pq, cm.maxsim_pq_plain, argspq, slicepq,
         "bf16", "evdr_tpu_torch/csrc/maxsim_pq.cu",
         "evdr_tpu/ops/pallas_maxsim.py:1109"),
        ("maxsim_pqfull", cm.maxsim_cuda_pqfull, cm.maxsim_pqfull_plain,
         argspq, slicepq, "int8", "evdr_tpu_torch/csrc/maxsim_pq.cu",
         "evdr_tpu/ops/pallas_maxsim.py:1109"),
        ("maxsim_pq_expanded", cm.maxsim_cuda_pq, cm.maxsim_pq_plain, argsex,
         sliceex, "bf16", "evdr_tpu_torch/csrc/maxsim_pq.cu",
         "evdr_tpu/ops/pallas_maxsim.py:1109"),
    ]
    pq_modes = {"maxsim_pq": "pq", "maxsim_pqfull": "pqfull",
                "maxsim_pq_expanded": "pq_sum"}
    kernels = []
    for kname, kern, plain, kargs, pargs, peak, src, repl in timed:
        ms, lo, hi = cuda_ms(lambda: kern(*kargs), 7)
        plain_ms, _, _ = cuda_ms(lambda: plain(*pargs), 3)
        qmask, pmask = (qm4, pm4) if kargs is args4 else (qmp, pmp)
        nd = pmask.shape[0]
        bms, by = bound(tensor_bytes(*kargs) + NQ * nd * 4,
                        valid_ops(qmask, pmask), peak)
        extra, entry = "", {}
        if kname in pq_modes:
            c = cm.pq_cluster(NQ, LQ, pq_modes[kname] != "pq_sum")
            per_sm, clusters = cm.pq_occupancy(pq_modes[kname], D, PQ_M, c)
            extra = (f"; cluster of {c} CTAs (each tile decoded once per "
                     f"cluster), {per_sm} CTAs per SM, {clusters} clusters "
                     f"resident")
            entry = {"cluster": c, "ctas_per_sm": per_sm,
                     "clusters_resident": clusters,
                     "launches_by_shape": pq_shapes[kname]}
        log(f"phase 15 time {kname}: {ms:.3f} ms median of 7 (spread "
            f"{lo:.3f}-{hi:.3f}) at {NQ}x{LQ} queries x {nd}x{LP} pages; "
            f"bound {bms:.3f} ms by {by} ({peak} peak; {bms / ms:.1%} of "
            f"the time); plain {plain_ms:.3f} ms (median of 3, on the first "
            f"{n} pages); library: none{extra}; {smi}")
        err, tol = parity[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": repl,
            "launches": counts[kname if kname in pq_modes
                               else kern.__name__],
            "max_abs_err": err, "tol": tol, "ms": ms, "ms_min": lo,
            "ms_max": hi, "plain_ms": plain_ms, "plain_docs": n,
            "bound_ms": bms, "bound_by": by, "library_ms": None, **entry})
    return kernels


def tier_phases(cm, gen, seed, smi, root):
    """Phases 11-15; returns the kernels line's K4 and K3 entries."""
    t0 = time.perf_counter()
    parity = tier_parity(cm, gen, seed)
    torch.cuda.empty_cache()
    cm.reset_launch_counts()
    e2e = {}
    args4, argspq, opq_data = tier_engines(cm, gen, seed, e2e)
    work = root / "build" / "chip_smoke_tiers"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        tier_entry_points(opq_data, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.synchronize()
    counts = cm.launch_counts()
    # K3's three kernels, by function and shape
    pq_shapes = {
        "maxsim_pq": launch_shapes(cm, "maxsim_cuda_pq", "evdr_maxsim_pq"),
        "maxsim_pqfull": launch_shapes(cm, "maxsim_cuda_pqfull",
                                       "evdr_maxsim_pqfull"),
        "maxsim_pq_expanded": (
            launch_shapes(cm, "maxsim_cuda_pq", "evdr_maxsim_pq_sum")
            + launch_shapes(cm, "maxsim_cuda_pqfull", "evdr_maxsim_pq_sum"))}
    for k, v in pq_shapes.items():
        counts[k] = sum(x["launches"] for x in v)
    log(f"phase 12-14 launches: {counts}; K3 by shape: {pq_shapes}")
    for name in ("maxsim_cuda_int4", "maxsim_cuda_int4full", "maxsim_pq",
                 "maxsim_pqfull", "maxsim_pq_expanded"):
        check(counts[name] > 0, f"{name} never launched on the capacity "
                                "tiers' path")
    del opq_data
    kernels = tier_times(cm, args4, argspq, counts, pq_shapes, parity, smi,
                         seed)
    log("phase 15 search_dense end to end: " + ", ".join(
        f"{k} {v:.1f} q/s" for k, v in e2e.items()))
    log(f"phases 11-15: {time.perf_counter() - t0:.1f} s")
    return kernels


# ------------------------------------------- the last TPU kernels (16-17)


def f32_train_parity(ct, Q, qm, P, pm, gen, label):
    """Phase 16 on one data set: K5 and K6 in float32 mode against their
    plain float32 versions. Returns (max abs error of K5's scores and M,
    relative error of K6's dQ and dP, max abs error of K6)."""
    out, M = ct.maxsim_cuda_fwd_train(Q, P, qm, pm, torch.float32)
    torch.cuda.synchronize()
    out_p, M_p = ct.maxsim_fwd_train_plain(Q, P, qm, pm, torch.float32)
    e_fwd = max(float((out - out_p).abs().max()),
                float((M - M_p).abs().max()))
    same_k1 = bool(torch.equal(out, ct.maxsim_cuda(Q, P, qm, pm,
                                                   torch.float32)))
    g = torch.randn((Q.shape[0], P.shape[0]), device=DEVICE, generator=gen)
    dq, dp = ct.maxsim_cuda_bwd(Q, P, qm, pm, M, g, torch.float32)
    torch.cuda.synchronize()
    dq_p, dp_p = ct.maxsim_bwd_plain(Q, P, qm, pm, M_p, g, torch.float32)
    e_rel = max(rel_err(dq, dq_p), rel_err(dp, dp_p))
    e_abs = max(float((dq - dq_p).abs().max()), float((dp - dp_p).abs().max()))
    empty = ~pm.any(dim=1)
    log(f"phase 16 parity {label}: K5 float32 scores and M max_abs_err="
        f"{e_fwd:.3e} (tol 1e-4), scores bit-equal to K1 float32: "
        f"{same_k1}; K6 float32 dQ/dP relative {e_rel:.3e} (tol 1e-4), "
        f"{e_abs:.3e} max abs; {int(empty.sum())} empty doc(s)")
    for name, v in (("K5 f32", torch.isfinite(out).all()),
                    ("K6 f32", torch.isfinite(dq).all()
                     & torch.isfinite(dp).all())):
        check(bool(v), f"{name} output finite ({label})")
    check(e_fwd <= 1e-4 and same_k1, f"K5 float32 parity ({label})")
    check(e_rel <= 1e-4, f"K6 float32 parity ({label})")
    if empty.any():
        check(float(out[:, empty].abs().max()) == 0.0
              and float(dp[empty].abs().max()) == 0.0,
              f"an empty doc scores 0 and gets no gradient ({label})")
    return e_fwd, e_rel, e_abs


def f32_train_phase(cm, ct, gen, smi):
    """Phase 16: K5 and K6 in float32 mode at the train step's shape:
    parity on tie-free random data and with an empty doc, one backward
    through maxsim(impl='pallas', compute_dtype=float32) (their launches),
    times. Returns their kernels-line entries."""
    from evdr_tpu_torch.ops import _cuda_build as build
    from evdr_tpu_torch.ops.maxsim import maxsim

    n_doc_tok = -(-DOC_LEN[1] // MF)
    Q = unit(torch.randn((STEP_NQ, LQ, D), device=DEVICE, generator=gen))
    qm = torch.rand((STEP_NQ, LQ), device=DEVICE, generator=gen) > 0.15
    qm[:, 0] = True
    P = unit(torch.randn((TRAIN_DOCS, n_doc_tok, D), device=DEVICE,
                         generator=gen))
    pm = torch.rand((TRAIN_DOCS, n_doc_tok), device=DEVICE,
                    generator=gen) > 0.1
    pm[:, 0] = True
    n_untied = untie(Q, qm, P, pm, dtype=torch.float32)
    log(f"phase 16 data: {STEP_NQ} x {LQ} queries, {TRAIN_DOCS} x "
        f"{n_doc_tok} random unit pages; {n_untied} runner-up token(s) "
        f"within 1e-5 of a row's max masked out (tie-free in f32)")
    errs = [f32_train_parity(ct, Q, qm, P, pm, gen, "random")]
    pm[7] = False
    errs.append(f32_train_parity(ct, Q, qm, P, pm, gen, "with an empty doc"))
    e_fwd = max(e[0] for e in errs)
    e_rel = max(e[1] for e in errs)
    e_abs = max(e[2] for e in errs)

    # the entry point: one backward through the dispatcher in float32
    w = torch.randn((STEP_NQ, TRAIN_DOCS), device=DEVICE, generator=gen)
    Qg = Q.clone().requires_grad_(True)
    Pg = P.clone().requires_grad_(True)
    cm.reset_launch_counts()
    out = maxsim(Qg, Pg, qm, pm, impl="pallas", compute_dtype=torch.float32)
    (out * w).sum().backward()
    torch.cuda.synchronize()
    counts = cm.launch_counts()
    out_p, M_p = ct.maxsim_fwd_train_plain(Q, P, qm, pm, torch.float32)
    dq_p, dp_p = ct.maxsim_bwd_plain(Q, P, qm, pm, M_p, w, torch.float32)
    e_out = float((out.detach() - out_p).abs().max())
    e_g = max(rel_err(Qg.grad, dq_p), rel_err(Pg.grad, dp_p))
    log(f"phase 16 maxsim(impl='pallas', compute_dtype=float32) under "
        f"autograd: scores {e_out:.3e} max abs, dQ/dP {e_g:.3e} relative "
        f"against the plain float32 path; launches {counts}")
    check(e_out <= 1e-4 and e_g <= 1e-4, "the float32 op's backward")
    check(counts["maxsim_cuda_fwd_train_f32"] > 0
          and counts["maxsim_cuda_bwd_f32"] > 0
          and counts["maxsim_cuda_fwd_train"] == 0
          and counts["maxsim_cuda_bwd"] == 0,
          "the float32 op ran K5 f32 and K6 f32")

    M = ct.maxsim_cuda_fwd_train(Q, P, qm, pm, torch.float32)[1]
    fwd_args = (Q, P, qm, pm)
    bwd_args = (Q, P, qm, pm, M, w)
    rows_docs = float(qm.sum()) * float(pm.any(dim=1).sum())
    timed = [
        ("maxsim_fwd_train_f32", ct.maxsim_cuda_fwd_train_f32,
         lambda *a: ct.maxsim_fwd_train_plain(*a, torch.float32), fwd_args,
         tensor_bytes(*fwd_args) + (STEP_NQ + STEP_NQ * LQ) * TRAIN_DOCS * 4,
         valid_ops(qm, pm), e_fwd, 1e-4, None,
         "evdr_tpu/ops/pallas_maxsim_bwd.py:84"),
        ("maxsim_bwd_f32", ct.maxsim_cuda_bwd_f32,
         lambda *a: ct.maxsim_bwd_plain(*a, torch.float32), bwd_args,
         tensor_bytes(*bwd_args) + (STEP_NQ * LQ + TRAIN_DOCS * n_doc_tok)
         * D * 4, valid_ops(qm, pm) + 4.0 * D * rows_docs, e_abs, None,
         e_rel, "evdr_tpu/ops/pallas_maxsim_bwd.py:168"),
    ]
    kernels = []
    for kname, kern, plain, kargs, nbytes, ops, err, tol, rel, repl in timed:
        ms, lo, hi = cuda_ms(lambda: kern(*kargs), 7)
        plain_ms, _, _ = cuda_ms(lambda: plain(*kargs), 3)
        bms, by = bound(nbytes, ops, "tf32")
        log(f"phase 16 time {kname}: {ms:.3f} ms median of 7 (spread "
            f"{lo:.3f}-{hi:.3f}) at {STEP_NQ}x{LQ} queries x "
            f"{TRAIN_DOCS}x{n_doc_tok} pages; bound {bms:.3f} ms by {by} "
            f"(tf32 peak); plain {plain_ms:.3f} ms (median of 3); library: "
            f"none; {smi}")
        src = ("maxsim_f32.cu" if kname == "maxsim_fwd_train_f32"
               else "maxsim_train.cu")
        entry = {
            "name": kname, "route": "cuda",
            "source": f"evdr_tpu_torch/csrc/{src}", "replaces": repl,
            "launches": counts[kern.__name__], "max_abs_err": err, "tol": tol,
            "ms": ms, "ms_min": lo, "ms_max": hi, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}
        if rel is not None:
            entry.update(rel_err=rel, rel_tol=1e-4)
        if kname == "maxsim_fwd_train_f32":
            entry["design"] = k5_design(cm, build, torch.float32)
            log(f"phase 16 K5 float32 design: {entry['design']} (K1 "
                f"float32's kernel with the M store)")
        if kname == "maxsim_bwd_f32":
            entry["design"] = k6_design(ct, build, torch.float32, STEP_NQ, LQ)
            log(f"phase 16 K6 float32 design: {entry['design']}")
        kernels.append(entry)
    return kernels


def k6_widths_and_ties(ct, gen):
    """Phase 16, K6 at the widths it gained and on exact ties: MaxSimFn
    (K5, then K6) at D 192 in both modes and 256 in bf16 against the plain
    K5/K6 pair on tie-free data with an empty doc; K6 on planted exact ties
    (a page token duplicated in its doc, with a query token on it; a zero
    query row with qmask 1, which ties with every valid token) against its
    plain version, in both modes. Tolerances as phases 7 and 16: dQ and dP
    within 1e-3 (bf16) and 1e-4 (float32) relative, scores 1e-4."""
    nd, lp = 300, -(-DOC_LEN[1] // MF)

    def data(d, dtype, ties):
        Q = unit(torch.randn((STEP_NQ, LQ, d), device=DEVICE, generator=gen))
        qm = torch.rand((STEP_NQ, LQ), device=DEVICE, generator=gen) > 0.15
        P = unit(torch.randn((nd, lp, d), device=DEVICE, generator=gen))
        pm = torch.rand((nd, lp), device=DEVICE, generator=gen) > 0.1
        qm[:, 0] = True
        pm[:, 0] = True
        pm[7] = False
        if ties:
            Q[0, 0] = P[1, 0]
        untie(Q, qm, P, pm, dtype=dtype)
        if ties:
            P[1, lp - 1] = P[1, 0]
            pm[1, 0] = pm[1, lp - 1] = True
            Q[-1, 0] = 0.0
        w = torch.randn((STEP_NQ, nd), device=DEVICE, generator=gen)
        return Q, P, qm, pm, w

    for d, dtype, tol in ((192, torch.bfloat16, 1e-3),
                          (192, torch.float32, 1e-4),
                          (256, torch.bfloat16, 1e-3)):
        Q, P, qm, pm, w = data(d, dtype, False)
        Qg = Q.clone().requires_grad_(True)
        Pg = P.clone().requires_grad_(True)
        out = ct.MaxSimFn.apply(Qg, Pg, qm, pm, dtype)
        (out * w).sum().backward()
        torch.cuda.synchronize()
        out_p, M_p = ct.maxsim_fwd_train_plain(Q, P, qm, pm, dtype)
        dq_p, dp_p = ct.maxsim_bwd_plain(Q, P, qm, pm, M_p, w, dtype)
        e_out = float((out.detach() - out_p).abs().max())
        e_g = max(rel_err(Qg.grad, dq_p), rel_err(Pg.grad, dp_p))
        log(f"phase 16 MaxSimFn at D = {d} ({dtype}): scores {e_out:.3e} "
            f"max abs (tol 1e-4), dQ/dP {e_g:.3e} relative (tol {tol:g}) "
            f"against the plain K5/K6 pair")
        check(bool(torch.isfinite(Pg.grad).all()) and e_out <= 1e-4
              and e_g <= tol, f"MaxSimFn at D = {d} ({dtype})")
        check(float(Pg.grad[7].abs().max()) == 0.0,
              f"the empty doc gets no gradient at D = {d} ({dtype})")
    for dtype, tol in ((torch.bfloat16, 1e-3), (torch.float32, 1e-4)):
        Q, P, qm, pm, w = data(D, dtype, True)
        M = ct.maxsim_cuda_fwd_train(Q, P, qm, pm, dtype)[1]
        dq, dp = ct.maxsim_cuda_bwd(Q, P, qm, pm, M, w, dtype)
        torch.cuda.synchronize()
        M_p = ct.maxsim_fwd_train_plain(Q, P, qm, pm, dtype)[1]
        dq_p, dp_p = ct.maxsim_bwd_plain(Q, P, qm, pm, M_p, w, dtype)
        e_g = max(rel_err(dq, dq_p), rel_err(dp, dp_p))
        tied = bool(torch.equal(dp[1, 0], dp[1, lp - 1]))
        log(f"phase 16 K6 on exact ties ({dtype}): dQ/dP {e_g:.3e} relative "
            f"(tol {tol:g}); the duplicated token's two copies got the same "
            f"gradient: {tied}")
        check(e_g <= tol and tied, f"K6 on exact ties ({dtype})")


def defer_phase(cm, gen, smi):
    """Phase 17: K2b in both modes. Parity at the serving shape (1,000
    pages, against K2's plain version, and bit-equal to K2; also at Lq 256,
    one launch), one call of
    each entry point with deferred=True on a 50,000-page index (their
    launches), then K2b's times beside K2's at Lp 768 and at Lp 64 (100,000
    pages). Returns the kernels-line entries."""
    from evdr_tpu_torch.ops import _cuda_build
    from evdr_tpu_torch.ops.quantize import quantize_tokens_int8

    modes = [("maxsim_int8full_deferred", cm.maxsim_cuda_int8full,
              cm.maxsim_cuda_int8full_deferred, cm.maxsim_int8full_plain,
              1e-3, "int8"),
             ("maxsim_int8_deferred", cm.maxsim_cuda_int8,
              cm.maxsim_cuda_int8_deferred, cm.maxsim_int8_plain, 2e-2,
              "bf16")]
    P, pm = make_pages(PARITY_DOCS, gen)
    pm[7] = False                     # a doc with no valid token
    P[11, 0] = 0.0                    # a valid token of scale 0
    pm[11, 0] = True
    P = P * pm[..., None]
    codes, scales = quantize_tokens_int8(P, pm)
    Q, qm, _ = planted_queries(lambda t: P[t], PARITY_DOCS, gen)
    Q256, qm256, _ = planted_queries(lambda t: P[t], PARITY_DOCS, gen,
                                     nq=16, lq=256)
    del P
    parity = {}
    for kname, k2, k2b, plain, tol, _ in modes:
        kargs = (Q, codes, scales, qm, pm)
        err = parity_case(17, kname, "serving shape", k2b, plain, kargs, tol,
                          7)
        same = bool(torch.equal(k2b(*kargs), k2(*kargs)))
        log(f"phase 17 {kname} bit-equal to K2: {same}")
        check(same, f"{kname} equals K2 bit for bit")
        parity[kname] = (err, tol)
        # a 256-token query fills one launch of the 256-row tiles
        kargs = (Q256, codes, scales, qm256, pm)
        n0 = k2b.launches
        parity_case(17, kname, "16 queries x 256 tokens", k2b, plain, kargs,
                    tol, 7)
        check(k2b.launches == n0 + 1, f"{kname}: one launch at Lq 256")
        same = bool(torch.equal(k2b(*kargs), k2(*kargs)))
        log(f"phase 17 {kname} at Lq 256 in one launch, bit-equal to K2: "
            f"{same}")
        check(same, f"{kname} equals K2 bit for bit at Lq 256")
    del codes, scales, Q, qm, pm, Q256, qm256
    log(f"phase 17 K2b launch bound: the bare __launch_bounds__(256) of "
        f"maxsim_int8_defer.cu; ptxas registers (int8 mode, int8full): "
        f"{ptxas_registers(_cuda_build, 'maxsim_int8_defer')}")

    shapes = {}
    for docs, lp in ((INT8_DOCS, LP), (SHORT_DOCS, SHORT_LP)):
        codes, scales, pm8 = make_int8_pages(docs, gen, quantize_tokens_int8,
                                             chunk=max(1, 768_000 // lp),
                                             lp=lp)
        Q8, qm8, _ = planted_queries(
            lambda t: codes[t].float() * scales[t][..., None], docs, gen)
        shapes[lp] = (Q8, codes, scales, qm8, pm8)

    # the entry points, as a caller reaches K2b (deferred=True)
    kargs = shapes[LP]
    cm.reset_launch_counts()
    got = {k2b.__name__: k2(*kargs, deferred=True)
           for _, k2, k2b, _, _, _ in modes}
    torch.cuda.synchronize()
    counts = cm.launch_counts()
    for _, k2, k2b, _, _, _ in modes:
        check(bool(torch.equal(got[k2b.__name__], k2(*kargs))),
              f"{k2b.__name__} equals K2 on {INT8_DOCS} pages")
        check(counts[k2b.__name__] > 0, f"{k2b.__name__} launched")
    log(f"phase 17 entry points (deferred=True) on {INT8_DOCS} pages x {LP}:"
        f" bit-equal to K2; launches {counts}")
    del got

    kernels = []
    n = PLAIN_TIME_DOCS
    for kname, k2, k2b, plain, tol, peak in modes:
        times = {}
        for lp, args in shapes.items():
            t_k2 = cuda_ms(lambda: k2(*args), 7)
            t_k2b = cuda_ms(lambda: k2b(*args), 7)
            times[lp] = (t_k2b, t_k2)
            log(f"phase 17 time {kname} at Lp {lp} ({args[1].shape[0]} "
                f"pages): K2b {t_k2b[0]:.3f} ms median of 7 (spread "
                f"{t_k2b[1]:.3f}-{t_k2b[2]:.3f}), K2 {t_k2[0]:.3f} ms "
                f"({t_k2[1]:.3f}-{t_k2[2]:.3f}); {smi}")
        args = shapes[LP]
        pargs = (args[0], args[1][:n], args[2][:n], args[3], args[4][:n])
        plain_ms, _, _ = cuda_ms(lambda: plain(*pargs), 3)
        nd = args[4].shape[0]
        bms, by = bound(tensor_bytes(*args) + NQ * nd * 4,
                        valid_ops(args[3], args[4]), peak)
        a64 = shapes[SHORT_LP]
        b64, _ = bound(tensor_bytes(*a64) + NQ * a64[4].shape[0] * 4,
                       valid_ops(a64[3], a64[4]), peak)
        mma = {lp: valid_ops(a[3], a[4]) / MMA_SYNC_OPS[peak] * 1e3
               for lp, a in shapes.items()}
        log(f"phase 17 {kname}: bound {bms:.3f} ms by {by} ({peak} peak) "
            f"at Lp {LP}, {b64:.3f} ms at Lp {SHORT_LP}; the mma.sync "
            f"ceiling {mma[LP]:.3f} ms ({mma[LP] / times[LP][0][0]:.1%}), "
            f"{mma[SHORT_LP]:.3f} ms "
            f"({mma[SHORT_LP] / times[SHORT_LP][0][0]:.1%}); plain (K2's) "
            f"{plain_ms:.3f}"
            f" ms on the first {n} pages (median of 3); library: none")
        err, tol = parity[kname]
        (ms, lo, hi), k2_ms = times[LP][0], times[LP][1][0]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "evdr_tpu_torch/csrc/maxsim_int8_defer.cu",
            "replaces": "evdr_tpu/ops/pallas_maxsim.py:740",
            "launches": counts[k2b.__name__],
            "max_abs_err": err, "tol": tol, "ms": ms, "ms_min": lo,
            "ms_max": hi, "k2_ms": k2_ms, "ms_lp64": times[SHORT_LP][0][0],
            "k2_ms_lp64": times[SHORT_LP][1][0], "bound_ms_lp64": b64,
            "plain_ms": plain_ms, "plain_docs": n, "bound_ms": bms,
            "bound_by": by, "library_ms": None})
    return kernels


# ------------------------------------- every query length and width (19)


def post_concurrently(url, bodies):
    """POST each body to ``url`` from a thread of its own, all at once;
    returns [(status, reply)] in order."""
    replies = [None] * len(bodies)

    def one(i):
        req = urllib.request.Request(
            url, data=json.dumps(bodies[i]).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            replies[i] = (r.status, json.loads(r.read()))

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(bodies))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    return replies


def shapes_phase(cm, gen):
    """Phase 19: an index of D = 72 (not a multiple of the kernels' 16)
    on every tier (bf16; int8 and int4, each with and without
    quantize_queries; PQ at M = 8, with and without), built through
    RetrievalEngine.build, answering queries of 200 tokens (above K3's 128
    query-token rows a launch; K1, K2 and K4 take them in one launch of 256
    rows) through search_dense, each against
    the plain version on its own index; then tools/serve_http over the
    int8 engine, one request of 200 tokens coalesced with three of 32, all
    answered with search_dense's top-1."""
    from evdr_tpu_torch import RetrievalEngine
    from evdr_tpu_torch.data.packing import preprocess_queries
    from evdr_tpu_torch.tools.serve_http import make_server

    t0 = time.perf_counter()
    n, d = SHAPES_DOCS, SHAPES_D
    P = torch.empty((n, LP, d), dtype=torch.float32, device=DEVICE)
    for i in range(0, n, 1_000):
        c = min(1_000, n - i)
        P[i:i + c] = unit(torch.randn((c, LP, d), device=DEVICE,
                                      generator=gen))
    pm = torch.rand((n, LP), device=DEVICE, generator=gen) > 0.1
    P = P * pm[..., None]
    Q, qm, tgt = planted_queries(lambda t: P[t], n, gen, lq=SHAPES_LQ)
    cm.reset_launch_counts()
    tiers = [("bfloat16", False, cm.maxsim_plain, 2e-2),
             ("int8", True, cm.maxsim_int8full_plain, 5e-3),
             ("int8", False, cm.maxsim_int8_plain, 2e-2),
             ("int4", True, cm.maxsim_int4full_plain, 5e-3),
             ("int4", False, cm.maxsim_int4_plain, 2e-2),
             ("pq", True, cm.maxsim_pqfull_plain, 5e-3),
             ("pq", False, cm.maxsim_pq_plain, 2e-2)]
    rates, built = {}, {}
    for dtype, q8, plain, tol in tiers:
        label = dtype + ("+quantize_queries" if q8 else "")
        eng = RetrievalEngine(dtype=dtype, quantize_queries=q8,
                              pq_m=SHAPES_PQ_M)
        if dtype in built:  # one index a tier (PQ books train on the host)
            eng.index = built[dtype].index
        else:
            built[dtype] = eng.build(P, pm)
        ix = eng.index
        width = (ix.books.shape[0] * ix.books.shape[-1]
                 if ix.books is not None else ix.P.shape[-1])
        check(eng.dim == d and width % cm.D_GRANULE == 0 and width >= d,
              f"{label}: dim {eng.dim}, stored width {width}")
        rates[label] = check_engine(19, f"{label} (Lq {SHAPES_LQ}, D {d}, "
                                    f"stored {width})", eng, Q, qm, tgt,
                                    plain, tol)
    counts = cm.launch_counts()
    log(f"phase 19 launches: {counts}; by shape: "
        f"{sorted((k[0], k[3]) for k in cm.launch_shapes)}")
    for w in (cm.maxsim_cuda, cm.maxsim_cuda_int8, cm.maxsim_cuda_int8full,
              cm.maxsim_cuda_int4, cm.maxsim_cuda_int4full,
              cm.maxsim_cuda_pq, cm.maxsim_cuda_pqfull):
        check(counts[w.__name__] > 0, f"{w.__name__} launched in phase 19")
    check(any(k[0] == "maxsim_cuda" and k[3] == SHAPES_LQ
              for k in cm.launch_shapes)
          and not any(k[0] == "maxsim_cuda" and k[3] < SHAPES_LQ
                      for k in cm.launch_shapes),
          "K1 scored the 200-token queries in one launch")
    check(any(k[0] == "maxsim_cuda_pq" and k[3] == SHAPES_LQ - cm.ROW_CAP[
        "maxsim_pq"] for k in cm.launch_shapes),
        "K3 scored the 200-token queries in slices")

    # one HTTP group: a 200-token request beside three of 32 tokens
    eng_bf = built["bfloat16"]
    srv = make_server(eng_bf, port=0, batch_wait_ms=500.0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/search"
        lens = [SHAPES_LQ, 32, 32, 32]
        qs = [Q[i, :n_tok][qm[i, :n_tok]].cpu().numpy()
              for i, n_tok in enumerate(lens)]
        replies = post_concurrently(url, [
            {"queries": [q.tolist()], "k": K} for q in qs])
        check(all(r is not None and r[0] == 200 for r in replies),
              f"every request of the group answered: "
              f"{[None if r is None else r[0] for r in replies]}")
        grouped = max(r[1]["batched_with"] for r in replies)
        top1 = []
        for q, (_, reply) in zip(qs, replies):
            qobj = np.empty(1, dtype=object)
            qobj[0] = q
            Qh, qmh = preprocess_queries(qobj, None, length_multiple=8)
            _, idx = eng_bf.search_dense(Qh, qmh, k=K)
            top1.append(reply["docids"][0][0] == eng_bf.ids_for(idx)[0][0])
        log(f"phase 19 serve_http: requests of {lens} tokens answered "
            f"(coalesced up to {grouped} a group), top-1 equal to "
            f"search_dense: {top1}")
        check(grouped > 1 and all(top1), "HTTP group with a 200-token query")
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    log(f"phase 19: {time.perf_counter() - t0:.1f} s; search_dense q/s at "
        f"Lq {SHAPES_LQ}, D {d}: " + ", ".join(
            f"{k} {v:.1f}" for k, v in rates.items()))


# ------------------------------------------------- every width (phase 20)


def wide_pages(n, d, gen, chunk=1_000):
    """(n, LP, d) unit f32 tokens, ~10% invalid (zeroed), on the device."""
    P = torch.empty((n, LP, d), dtype=torch.float32, device=DEVICE)
    for i in range(0, n, chunk):
        c = min(chunk, n - i)
        P[i:i + c] = unit(torch.randn((c, LP, d), device=DEVICE,
                                      generator=gen))
    pm = torch.rand((n, LP), device=DEVICE, generator=gen) > 0.1
    return P * pm[..., None], pm


def fwd_entry(phase, kname, kern, plain, kargs, pargs, d, peak, src, repl,
              launches, err, tol, smi, extra=None):
    """Time one forward kernel (median of 7 CUDA-event timings) beside its
    bound at width ``d`` and its plain version on ``pargs`` (median of 3);
    returns its kernels-line entry."""
    ms, lo, hi = cuda_ms(lambda: kern(*kargs), 7)
    plain_ms, _, _ = cuda_ms(lambda: plain(*pargs), 3)
    qmask, pmask = kargs[-2], kargs[-1]
    if kargs[-1].dtype != torch.bool:  # K3: (Q, codes, qm, pm, books)
        qmask, pmask = kargs[2], kargs[3]
    nq, nd = kargs[0].shape[0], pmask.shape[0]
    ops = 2.0 * d * float(qmask.sum()) * float(pmask.sum())
    bms, by = bound(tensor_bytes(*kargs) + nq * nd * 4, ops, peak)
    plain_nd = (pargs[-1] if pargs[-1].dtype == torch.bool
                else pargs[3]).shape[0]
    log(f"phase {phase} time {kname}: {ms:.3f} ms median of 7 (spread "
        f"{lo:.3f}-{hi:.3f}) at {tuple(kargs[0].shape)} queries x {nd}x"
        f"{pmask.shape[1]} pages, D = {d}; bound {bms:.3f} ms by {by} ({peak} "
        f"peak; {bms / ms:.1%} of the time); plain {plain_ms:.3f} ms (median "
        f"of 3, on {plain_nd} pages); library: none; {launches} launches; "
        f"{smi}")
    return {"name": kname, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches, "max_abs_err": err, "tol": tol, "ms": ms,
            "ms_min": lo, "ms_max": hi, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None, "d": d,
            **(extra or {})}


def wide_phase(cm, ct, gen, smi):
    """Phase 20: every tier above the fast kernels' bound (D 256; float32
    192). An index of D = 320 on every tier (3,000 pages x 768 tokens; PQ
    at M = 16 with compact books of 20 dims, and the same codes with the
    books expanded to full width), 256 planted queries x 32 tokens through
    search_dense against the plain versions; K2b's wide entry points, bit
    for bit K2's; K1 float32 at D 200 and 320; MaxSimFn at D 320 in both
    modes (scores, M, dQ, dP against the plain pair, the wide K5 bit-equal
    to the wide K1, K6 on planted exact ties, two K6 calls bit-equal);
    each wide kernel's time beside its bound. Returns their kernels-line
    entries (launches from this phase's engines; K2b's, K5's and K6's from
    their entry points' calls, counts zeroed before each)."""
    from evdr_tpu_torch import RetrievalEngine
    from evdr_tpu_torch.ops.pq import encode_pq_device, expand_books, train_pq

    t0 = time.perf_counter()
    n, d = WIDE_DOCS, WIDE_D
    P, pm = wide_pages(n, d, gen)
    pm[7] = False                     # a doc with no valid token
    P[7] = 0.0
    Q, qm, tgt = planted_queries(lambda t: P[t], n, gen)
    books = train_pq(P[:300], pm[:300], m=WIDE_PQ_M, sample=PQ_SAMPLE,
                     seed=0)
    codes = encode_pq_device(P, books, pm)
    books_t = torch.as_tensor(books, device=DEVICE)
    # the same codes with full-width books: the sum decode's wide path
    books_ex = torch.as_tensor(expand_books(books, np.eye(d, dtype=np.float32)),
                               device=DEVICE)
    Qp, qmp, tgtp = planted_queries(lambda t: pq_tokens(codes[t], books_t),
                                    n, gen)
    log(f"phase 20 data: {n} pages x {LP} x {d} (unit, ~10% masked, doc 7 "
        f"empty), PQ books {tuple(books.shape)} on {PQ_SAMPLE} sampled "
        f"tokens and expanded {tuple(books_ex.shape)}, "
        f"{time.perf_counter() - t0:.1f} s")

    cm.reset_launch_counts()
    base = "cuda" if DEVICE == "cuda" else "plain"
    bf = RetrievalEngine(dtype="bfloat16").build(P, pm)
    i8q = RetrievalEngine(dtype="int8", quantize_queries=True).build(P, pm)
    i8 = RetrievalEngine.from_index(i8q.index.P, i8q.index.pmask, n,
                                    scales=i8q.index.scales, dtype="int8")
    i4q = RetrievalEngine(dtype="int4", quantize_queries=True).build(P, pm)
    i4 = RetrievalEngine.from_index(i4q.index.P, i4q.index.pmask, n,
                                    scales=i4q.index.scales, dtype="int4")
    pqq = RetrievalEngine(dtype="pq", quantize_queries=True).build_from_pq(
        codes, books, pm)
    pq = RetrievalEngine.from_index(pqq.index.P, pqq.index.pmask, n,
                                    books=pqq.index.books, dtype="pq")
    pqx = RetrievalEngine.from_index(pqq.index.P, pqq.index.pmask, n,
                                     books=books_ex, books_expanded=True,
                                     dtype="pq")
    check(all(e.dim == d for e in (bf, i8, i4, pq, pqx))
          and i8q.impl == base + "_q8" and pqq.impl == base + "_q8",
          "phase 20 engines: dim and impl")
    rates = {}
    for label, eng, q, m_, t_, plain, tol in (
            ("bfloat16", bf, Q, qm, tgt, cm.maxsim_plain, 2e-2),
            ("int8+quantize_queries", i8q, Q, qm, tgt,
             cm.maxsim_int8full_plain, 1e-3),
            ("int8", i8, Q, qm, tgt, cm.maxsim_int8_plain, 2e-2),
            ("int4+quantize_queries", i4q, Q, qm, tgt,
             cm.maxsim_int4full_plain, 1e-3),
            ("int4", i4, Q, qm, tgt, cm.maxsim_int4_plain, 2e-2),
            ("pq+quantize_queries", pqq, Qp, qmp, tgtp,
             cm.maxsim_pqfull_plain, 1e-3),
            ("pq", pq, Qp, qmp, tgtp, cm.maxsim_pq_plain, 2e-2),
            ("pq expanded books", pqx, Qp, qmp, tgtp, cm.maxsim_pq_plain,
             2e-2)):
        rates[label] = check_engine(20, f"{label} (D {d})", eng, q, m_, t_,
                                    plain, tol)
    torch.cuda.synchronize()
    funcs = ("evdr_maxsim_bf16_wide", "evdr_maxsim_int8_wide",
             "evdr_maxsim_int8full_wide", "evdr_maxsim_int4_wide",
             "evdr_maxsim_int4full_wide", "evdr_maxsim_pq_wide",
             "evdr_maxsim_pqfull_wide", "evdr_maxsim_pq_sum_wide")
    launches = {f: cm.func_launches(f) for f in funcs}
    log(f"phase 20 launches: {launches}; by shape: "
        f"{sorted((k[1], k[3], k[4]) for k in cm.launch_shapes)}")
    check(all(launches[f] > 0 for f in funcs)
          and not any(not k[1].endswith("_wide") for k in cm.launch_shapes),
          "phase 20 ran every wide function and no fast kernel")

    # K2b's wide path through its entry points: K2's wide scores bit for bit
    i8x = i8q.index
    k2_args = (Q, i8x.P, i8x.scales, qm, i8x.pmask)
    cm.reset_launch_counts()
    same = {}
    for mode, kern in (("int8", cm.maxsim_cuda_int8),
                       ("int8full", cm.maxsim_cuda_int8full)):
        same[mode] = bool(torch.equal(kern(*k2_args, deferred=True),
                                      kern(*k2_args)))
    defer_launches = {f: cm.func_launches(f) for f in (
        "evdr_maxsim_int8_defer_wide", "evdr_maxsim_int8full_defer_wide")}
    log(f"phase 20 K2b wide: bit-equal to K2 wide {same}; launches "
        f"{defer_launches}")
    check(all(same.values()) and all(defer_launches.values()),
          "K2b's wide path equals K2's")

    # K1 float32 at D 200 and 320, on the first 1,000 pages
    f32_err = {}
    for dd in WIDE_F32_DS:
        Pd = P[:1_000, :, :dd].contiguous()
        f32_err[dd] = parity_case(20, "maxsim_f32_wide", f"D {dd}",
                                  cm.maxsim_cuda_f32,
                                  lambda *a: cm.maxsim_plain(
                                      *a, compute=torch.float32),
                                  (Q[..., :dd].contiguous(), Pd, qm,
                                   pm[:1_000]), 1e-4, 7)
    del Pd

    train_errs, train_kargs = wide_train_checks(ct, cm, gen, d)

    # times at the engines' shapes (plain versions on the first 1,000 pages)
    pl = PLAIN_WIDE_DOCS
    i4x, pqx_ix = i4q.index, pqq.index
    bfx = bf.index
    fx = (Q, P, qm, pm)
    a_bf = (Q, bfx.P, qm, bfx.pmask)
    a_i8 = k2_args
    a_i4 = (Q, i4x.P, i4x.scales, qm, i4x.pmask)
    a_pq = (Qp, pqx_ix.P, qmp, pqx_ix.pmask, pqx_ix.books)
    a_ex = (Qp, pqx_ix.P, qmp, pqx_ix.pmask, books_ex)

    def cut(a):
        if a[-1].dtype == torch.bool:
            return a[:1] + tuple(x[:pl] for x in a[1:-2]) + (a[-2], a[-1][:pl])
        return (a[0], a[1][:pl], a[2], a[3][:pl], a[4])

    K1S, K2S = "evdr_tpu/ops/pallas_maxsim.py:433", \
        "evdr_tpu/ops/pallas_maxsim.py:686"
    cs = "evdr_tpu_torch/csrc/"
    timed = [
        ("maxsim_bf16_wide", cm.maxsim_cuda, cm.maxsim_plain, a_bf, "bf16",
         cs + "maxsim_bf16.cu", K1S, launches["evdr_maxsim_bf16_wide"]),
        ("maxsim_int8_wide", cm.maxsim_cuda_int8, cm.maxsim_int8_plain,
         a_i8, "bf16", cs + "maxsim_int8.cu", K2S,
         launches["evdr_maxsim_int8_wide"]),
        ("maxsim_int8full_wide", cm.maxsim_cuda_int8full,
         cm.maxsim_int8full_plain, a_i8, "int8", cs + "maxsim_int8.cu", K2S,
         launches["evdr_maxsim_int8full_wide"]),
        ("maxsim_int8_defer_wide", cm.maxsim_cuda_int8_deferred,
         cm.maxsim_int8_plain, a_i8, "bf16", cs + "maxsim_int8_defer.cu",
         "evdr_tpu/ops/pallas_maxsim.py:740",
         defer_launches["evdr_maxsim_int8_defer_wide"]),
        ("maxsim_int8full_defer_wide", cm.maxsim_cuda_int8full_deferred,
         cm.maxsim_int8full_plain, a_i8, "int8", cs + "maxsim_int8_defer.cu",
         "evdr_tpu/ops/pallas_maxsim.py:740",
         defer_launches["evdr_maxsim_int8full_defer_wide"]),
        ("maxsim_int4_wide", cm.maxsim_cuda_int4, cm.maxsim_int4_plain, a_i4,
         "bf16", cs + "maxsim_int4.cu", "evdr_tpu/ops/pallas_maxsim.py:1413",
         launches["evdr_maxsim_int4_wide"]),
        ("maxsim_int4full_wide", cm.maxsim_cuda_int4full,
         cm.maxsim_int4full_plain, a_i4, "int8", cs + "maxsim_int4.cu",
         "evdr_tpu/ops/pallas_maxsim.py:1413",
         launches["evdr_maxsim_int4full_wide"]),
        ("maxsim_pq_wide", cm.maxsim_cuda_pq, cm.maxsim_pq_plain, a_pq,
         "bf16", cs + "maxsim_pq.cu", "evdr_tpu/ops/pallas_maxsim.py:1109",
         launches["evdr_maxsim_pq_wide"]),
        ("maxsim_pqfull_wide", cm.maxsim_cuda_pqfull, cm.maxsim_pqfull_plain,
         a_pq, "int8", cs + "maxsim_pq.cu",
         "evdr_tpu/ops/pallas_maxsim.py:1109",
         launches["evdr_maxsim_pqfull_wide"]),
        ("maxsim_pq_sum_wide", cm.maxsim_cuda_pq, cm.maxsim_pq_plain, a_ex,
         "bf16", cs + "maxsim_pq.cu", "evdr_tpu/ops/pallas_maxsim.py:1109",
         launches["evdr_maxsim_pq_sum_wide"]),
    ]
    kernels = []
    for kname, kern, plain, kargs, peak, src, repl, n_l in timed:
        err = float((kern(*cut(kargs)) - plain(*cut(kargs))).abs().max())
        tol = 1e-3 if peak == "int8" else 2e-2
        check(err <= tol, f"{kname} against its plain version ({err})")
        kernels.append(fwd_entry(20, kname, kern, plain, kargs, cut(kargs), d,
                                 peak, src, repl, n_l, err, tol, smi))
    del a_bf, a_i8, a_i4, bf, i8q, i8, i4q, i4, pqq, pq, pqx, bfx, i8x, i4x
    torch.cuda.empty_cache()
    for dd in WIDE_F32_DS:
        fa = (Q[..., :dd].contiguous(), P[..., :dd].contiguous(), qm, pm)
        cm.reset_launch_counts()
        cm.maxsim_cuda_f32(*fa)
        nl = cm.func_launches("evdr_maxsim_f32_wide")
        kernels.append(fwd_entry(
            20, f"maxsim_f32_wide_d{dd}", cm.maxsim_cuda_f32,
            lambda *a: cm.maxsim_plain(*a, compute=torch.float32), fa,
            cut(fa), dd, "tf32", cs + "maxsim_f32.cu", K1S, nl, f32_err[dd],
            1e-4, smi))
        del fa
    kernels += wide_train_times(ct, cm, train_kargs, train_errs, d, smi)
    log(f"phase 20: {time.perf_counter() - t0:.1f} s; search_dense q/s at "
        f"D {d}: " + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()))
    return kernels


def wide_train_checks(ct, cm, gen, d):
    """Phase 20's MaxSimFn at D = ``d`` in both modes (STEP_NQ x LQ queries
    against 300 pages of the student's length), on tie-free data with an
    empty doc, against the plain K5/K6 pair; the wide K5 bit-equal to the
    wide K1; K6 on planted exact ties; two K6 calls bit-equal. Returns the
    errors and the timing phase's arguments per mode."""
    nd, lp = 300, -(-DOC_LEN[1] // MF)
    errs, kargs = {}, {}
    for dtype, rel_tol in ((torch.bfloat16, 1e-3), (torch.float32, 1e-4)):
        Q = unit(torch.randn((STEP_NQ, LQ, d), device=DEVICE, generator=gen))
        qm = torch.rand((STEP_NQ, LQ), device=DEVICE, generator=gen) > 0.15
        P = unit(torch.randn((nd, lp, d), device=DEVICE, generator=gen))
        pm = torch.rand((nd, lp), device=DEVICE, generator=gen) > 0.1
        qm[:, 0] = True
        pm[:, 0] = True
        pm[7] = False
        Q[0, 0] = P[1, 0]
        untie(Q, qm, P, pm, dtype=dtype)
        w = torch.randn((STEP_NQ, nd), device=DEVICE, generator=gen)
        cm.reset_launch_counts()
        Qg, Pg = Q.clone().requires_grad_(True), P.clone().requires_grad_(True)
        out = ct.MaxSimFn.apply(Qg, Pg, qm, pm, dtype)
        (out * w).sum().backward()
        torch.cuda.synchronize()
        sfx = "_f32" if dtype == torch.float32 else ""
        n_fwd = cm.func_launches(f"evdr_maxsim_fwd_train{sfx}_wide")
        n_bwd = cm.func_launches(f"evdr_maxsim_bwd{sfx}_wide")
        out_p, M_p = ct.maxsim_fwd_train_plain(Q, P, qm, pm, dtype)
        dq_p, dp_p = ct.maxsim_bwd_plain(Q, P, qm, pm, M_p, w, dtype)
        e_out = float((out.detach() - out_p).abs().max())
        e_g = max(rel_err(Qg.grad, dq_p), rel_err(Pg.grad, dp_p))
        a_g = max(float((Qg.grad - dq_p).abs().max()),
                  float((Pg.grad - dp_p).abs().max()))
        o5, M = ct.maxsim_cuda_fwd_train(Q, P, qm, pm, dtype)
        e_m = float((M - M_p).abs().max())
        same_k1 = bool(torch.equal(o5, cm.maxsim_cuda(Q, P, qm, pm, dtype)))
        # the times take the tie-free data (a zero query row, below, hits
        # every valid token: ~140 x 300 hits on one row's walk)
        kargs[dtype] = tuple(x.clone() for x in (Q, P, qm, pm, w))
        # exact ties: doc 1 holds its token 0 twice, query 0's first token
        # sits on it; the last query's first token is zero (ties with all)
        P[1, lp - 1] = P[1, 0]
        pm[1, lp - 1] = True
        Q[-1, 0] = 0.0
        M = ct.maxsim_cuda_fwd_train(Q, P, qm, pm, dtype)[1]
        dq, dp = ct.maxsim_cuda_bwd(Q, P, qm, pm, M, w, dtype)
        dq2, dp2 = ct.maxsim_cuda_bwd(Q, P, qm, pm, M, w, dtype)
        M_p = ct.maxsim_fwd_train_plain(Q, P, qm, pm, dtype)[1]
        dq_p, dp_p = ct.maxsim_bwd_plain(Q, P, qm, pm, M_p, w, dtype)
        e_t = max(rel_err(dq, dq_p), rel_err(dp, dp_p))
        tied = bool(torch.equal(dp[1, 0], dp[1, lp - 1]))
        twice = bool(torch.equal(dq, dq2) and torch.equal(dp, dp2))
        log(f"phase 20 MaxSimFn at D = {d} ({dtype}): launches K5 wide "
            f"{n_fwd}, K6 wide {n_bwd}; scores {e_out:.3e} (tol 1e-4), M "
            f"{e_m:.3e} (tol 1e-4), dQ/dP {e_g:.3e} relative (tol "
            f"{rel_tol:g}), {a_g:.3e} max abs, against the plain K5/K6 pair; "
            f"K5 wide scores bit-equal to K1 wide: {same_k1}; on exact ties "
            f"dQ/dP {e_t:.3e} relative, the duplicated token's copies equal: "
            f"{tied}; two K6 calls bit-equal: {twice}")
        check(n_fwd > 0 and n_bwd > 0 and e_out <= 1e-4 and e_m <= 1e-4
              and e_g <= rel_tol and e_t <= rel_tol and same_k1 and tied
              and twice, f"MaxSimFn at D = {d} ({dtype})")
        check(float(Pg.grad[7].abs().max()) == 0.0,
              f"the empty doc gets no gradient at D = {d} ({dtype})")
        errs[dtype] = (max(e_out, e_m), a_g, max(e_g, e_t), n_fwd, n_bwd)
    return errs, kargs


def wide_train_times(ct, cm, train_kargs, errs, d, smi):
    """Phase 20's wide K5 and K6 times in both modes, at MaxSimFn's
    shape, beside their bounds (K6: the recompute plus one page row per
    (query row, doc) into dQ and one query row into dP)."""
    kernels = []
    for dtype, peak in ((torch.bfloat16, "bf16"), (torch.float32, "tf32")):
        Q, P, qm, pm, w = train_kargs[dtype]
        nq, lq = Q.shape[:2]
        nd, lp = pm.shape
        M = ct.maxsim_cuda_fwd_train(Q, P, qm, pm, dtype)[1]
        e_fwd, a_g, rel, n_fwd, n_bwd = errs[dtype]
        ops = 2.0 * d * float(qm.sum()) * float(pm.sum())
        rows_docs = float(qm.sum()) * float(pm.any(dim=1).sum())
        sfx = "_f32" if dtype == torch.float32 else ""
        fwd = (Q, P, qm, pm)
        bwd = (Q, P, qm, pm, M, w)
        for kname, kern, plain, kargs, nbytes, n_ops, src, repl, n_l, err in (
                (f"maxsim_fwd_train{sfx}_wide",
                 lambda *a: ct.maxsim_cuda_fwd_train(*a, dtype),
                 lambda *a: ct.maxsim_fwd_train_plain(*a, dtype), fwd,
                 tensor_bytes(*fwd) + (nq + nq * lq) * nd * 4, ops,
                 "maxsim_f32.cu" if sfx else "maxsim_bf16.cu",
                 "evdr_tpu/ops/pallas_maxsim_bwd.py:84", n_fwd, e_fwd),
                (f"maxsim_bwd{sfx}_wide",
                 lambda *a: ct.maxsim_cuda_bwd(*a, dtype),
                 lambda *a: ct.maxsim_bwd_plain(*a, dtype), bwd,
                 tensor_bytes(*bwd) + (nq * lq + nd * lp) * d * 4,
                 ops + 4.0 * d * rows_docs, "maxsim_train.cu",
                 "evdr_tpu/ops/pallas_maxsim_bwd.py:168", n_bwd, a_g)):
            ms, lo, hi = cuda_ms(lambda: kern(*kargs), 7)
            plain_ms, _, _ = cuda_ms(lambda: plain(*kargs), 3)
            bms, by = bound(nbytes, n_ops, peak)
            log(f"phase 20 time {kname}: {ms:.3f} ms median of 7 (spread "
                f"{lo:.3f}-{hi:.3f}) at {nq}x{lq} queries x {nd}x{lp} "
                f"pages, D = {d}; bound {bms:.3f} ms by {by} ({peak} peak; "
                f"{bms / ms:.1%}); plain {plain_ms:.3f} ms (median of 3); "
                f"library: none; {n_l} launches; {smi}")
            entry = {"name": kname, "route": "cuda",
                     "source": "evdr_tpu_torch/csrc/" + src, "replaces": repl,
                     "launches": n_l, "max_abs_err": err,
                     "tol": 1e-4 if "fwd" in kname else None, "ms": ms,
                     "ms_min": lo, "ms_max": hi, "plain_ms": plain_ms,
                     "bound_ms": bms, "bound_by": by, "library_ms": None,
                     "d": d}
            if "bwd" in kname:
                entry.update(rel_err=rel,
                             rel_tol=1e-4 if sfx else 1e-3)
            kernels.append(entry)
    return kernels


# ------------------------------------------------- pruned search (phase 21)


def untied_agreement(vals_e, idx_e, idx_p, gap):
    """Whether the pruned ``idx_p`` (nq, k) equals the exact top-(k + 1)
    ``idx_e`` at every rank of the first k whose exact score stands more
    than ``gap`` from both neighbours' (untied); returns (agree, ranks
    compared)."""
    v = np.asarray(vals_e, np.float64)
    k = idx_p.shape[1]
    step = v[:, :-1] - v[:, 1:]               # rank r to rank r + 1
    above = np.concatenate([np.full((v.shape[0], 1), np.inf), step], 1)
    untied = (above[:, :k] > gap) & (step[:, :k] > gap)
    return (bool((idx_e[:, :k][untied] == idx_p[untied]).all()),
            int(untied.sum()))


def stored_tokens(ix, docs, d):
    """The f32 tokens of index ``ix``'s docs ``docs`` as the rerank scores
    them: dequantized int8 / int4, or PQ decoded from the f32 books."""
    from evdr_tpu_torch.ops.cuda_maxsim import unpack_int4_torch
    from evdr_tpu_torch.ops.pruned import _decode_pq

    T = ix.P[docs]
    if ix.books is not None:
        return _decode_pq(T, ix.books, d, "take")
    if T.dtype == torch.uint8:
        T = unpack_int4_torch(T, ix.pmask.shape[1])
    T = T.float()
    return T if ix.scales is None else T * ix.scales[docs][..., None]


def rerank_exact_err(ix, Q, qm, vals, idx):
    """Largest gap between the pruned rerank's scores and plain exact f32
    MaxSim (ops/maxsim.maxsim_torch, -1e4 fill) of the returned docs over
    the stored index, query by query."""
    from evdr_tpu_torch.ops.maxsim import maxsim_torch

    err = 0.0
    for q in range(Q.shape[0]):
        docs = torch.as_tensor(idx[q], device=Q.device)
        s = maxsim_torch(Q[q:q + 1], stored_tokens(ix, docs, Q.shape[-1]),
                         qm[q:q + 1], ix.pmask[docs])[0]
        err = max(err, float((s.cpu() - torch.as_tensor(vals[q])).abs().max()))
    return err


def exact_f32_top(ix, Q, qm, k):
    """Exact top-k (values, indices) over the stored index in f32, the
    semantics the rerank applies to its candidates."""
    from evdr_tpu_torch.ops.maxsim import maxsim_torch
    from evdr_tpu_torch.parallel.topk import _select_topk

    docs = torch.arange(ix.n_docs, device=Q.device)
    sc = maxsim_torch(Q, stored_tokens(ix, docs, Q.shape[-1]), qm,
                      ix.pmask[:ix.n_docs])
    v, i = _select_topk(sc, k)
    return v.cpu().numpy(), i.cpu().numpy()


def pruned_engine(label, kw, P, pm, Q, qm, smi):
    """One engine of phase 21 over the 50,000 pages: its build (the
    summary's own seconds measured apart), exact search, then at each
    candidate count the pruned search's q/s, recall@1 and @10 against the
    exact search, stage 1 (the summary scored by the serving kernels at Lp
    = PRUNE_K) and stage 2 (the exact rerank) timed apart by CUDA events,
    stage 1's launches by shape and its bound; the gates. Returns the
    report and stage 1's launches (a Counter by wrapper, function and
    shape)."""
    from evdr_tpu_torch import RetrievalEngine
    from evdr_tpu_torch.ops import cuda_maxsim as cm
    from evdr_tpu_torch.ops import pruned
    from evdr_tpu_torch.parallel.topk import _select_topk

    t0 = time.perf_counter()
    eng = RetrievalEngine(prune_centroids=PRUNE_K, normalize=False,
                          **kw).build(P, pm)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    ix, sx = eng.index, eng.summary
    n = eng.n_docs
    check(sx is not None and sx.n_docs == n and sx.P.shape[1] in (
        PRUNE_K, -(-PRUNE_K // 2)), f"{label}: summary index")
    eng.search_dense(Q, qm, k=K)
    t0 = time.perf_counter()
    ve, ie = eng.search_dense(Q, qm, k=K)
    exact_qps = Q.shape[0] / (time.perf_counter() - t0)
    peak = "int8" if eng.impl.endswith("_q8") else "bf16"
    s_ops = 2.0 * D * float(qm.sum()) * float(sx.pmask.sum())
    s_bytes = tensor_bytes(Q, qm, sx.P, sx.pmask) + Q.shape[0] * sx.n_pad * 4
    if sx.scales is not None:
        s_bytes += tensor_bytes(sx.scales)
    s_bound, s_by = bound(s_bytes, s_ops, peak)
    s1_ms, s1_lo, s1_hi = cuda_ms(lambda: pruned.candidate_scores(
        Q, qm, sx.P, sx.pmask, eng.impl, sx.scales), 7)
    sc = pruned.candidate_scores(Q, qm, sx.P, sx.pmask, eng.impl, sx.scales)
    report = {"engine": label, "build_s": t_build,
              "summary_dtype": str(sx.P.dtype).replace("torch.", ""),
              "exact_qps": exact_qps, "stage1_ms": s1_ms,
              "stage1_spread": [s1_lo, s1_hi], "stage1_bound_ms": s_bound,
              "stage1_bound_by": s_by, "stage1_share": s_bound / s1_ms,
              "by_candidates": {}}
    stage1 = Counter()
    on_kernel = ix.scales is not None and ix.P.dtype == torch.int8
    for nc in PRUNE_CANDS:
        cm.reset_launch_counts()
        eng.search_dense(Q, qm, k=K, n_candidates=nc)
        torch.cuda.synchronize()
        shapes = sorted(k_ + (v_,) for k_, v_ in cm.launch_shapes.items())
        stage1.update(cm.launch_shapes)
        n_rr = pruned.rerank_int8_cuda.launches
        report["stage2_launches"] = report.get("stage2_launches", 0) + n_rr
        check(n_rr == int(on_kernel), f"{label}: stage 2 launched the "
              f"rerank kernel {n_rr} times in one search (want "
              f"{int(on_kernel)})")
        t0 = time.perf_counter()
        vals, idx = eng.search_dense(Q, qm, k=K, n_candidates=nc)
        qps = Q.shape[0] / (time.perf_counter() - t0)
        cand = _select_topk(sc, nc)[1]
        chunk_q = pruned.rerank_chunk_q(nc, LP, D, ix.books, "take")
        s2_ms, s2_lo, s2_hi = cuda_ms(lambda: pruned.rerank_candidates(
            Q, qm, ix.P, ix.pmask, cand, K, scales=ix.scales,
            chunk_q=chunk_q, books=ix.books, pq_decode="take"), 3)
        r1 = pruned.pruned_recall(ie[:, :1], idx[:, :1])
        r10 = pruned.pruned_recall(ie, idx)
        err = rerank_exact_err(ix, Q, qm, vals, idx)
        report["by_candidates"][nc] = {
            "qps": qps, "recall_at_1": r1, "recall_at_10": r10,
            "stage2_ms": s2_ms, "stage2_spread": [s2_lo, s2_hi],
            "rerank_vs_exact_f32": err, "stage1_launches": shapes}
        log(f"phase 21 {label}, {nc} candidates ({nc / n:.0%}): {qps:.1f} "
            f"q/s (exact search {exact_qps:.1f}); recall@1 {r1:.4f}, "
            f"recall@10 {r10:.4f} against exact search; stage 1 "
            f"{s1_ms:.3f} ms (spread {s1_lo:.3f}-{s1_hi:.3f}; bound "
            f"{s_bound:.3f} ms by {s_by}, {s_bound / s1_ms:.1%}), stage 2 "
            f"{s2_ms:.3f} ms (spread {s2_lo:.3f}-{s2_hi:.3f}); the rerank's "
            f"scores against plain exact f32 MaxSim of the returned docs: "
            f"{err:.3e} (tol 1e-3); stage 1 launches by shape {shapes}; "
            f"{smi}")
        check(int(idx.max()) < n and idx.shape == (Q.shape[0], K),
              f"{label}: no pruned index >= n_docs")
        check(err <= 1e-3, f"{label}: rerank scores are exact MaxSim")
        check(all(s_[4] == sx.n_pad and s_[5] == sx.P.shape[1] * (
            2 if sx.P.dtype == torch.uint8 else 1) for s_ in shapes)
              and shapes, f"{label}: stage 1 ran the kernels on the summary")
    log(f"phase 21 {label}: build {t_build:.1f} s (summaries "
        f"{report['summary_dtype']}, {tensor_bytes(sx.P) / 1e6:.1f} MB)")
    if kw.get("quantize_queries"):
        # the benchmark cell's engine: stage 2's kernel at its shape
        report["rerank_kernel"] = rerank_kernel_entry(
            ix, Q, qm, _select_topk(sc, PRUNE_CELL_CANDS)[1], smi)
    del eng
    torch.cuda.empty_cache()
    return report, stage1


def rerank_kernel_entry(ix, Q, qm, cand, smi):
    """Stage 2's kernel (ops/pruned.rerank_int8_cuda) at the pruned
    benchmark cell's shape, on stage 1's candidates ``cand`` (nq, 416) of
    the int8 index ``ix``: median of 7 CUDA-event timings beside its bound
    (every input byte once: the candidates' codes, scales and mask,
    repeats counted, the queries, the ids, the scores; or three f16
    products per dim of each valid token pair at the f16 peak, 989 TFLOP/s
    as bf16's) and its
    plain version's time (_rerank_scores in rerank_chunk_q's blocks,
    median of 3), and the largest gap between the two (finite scores; the
    -inf ones equal). Returns the kernel table's entry (launches filled in
    by the caller)."""
    from evdr_tpu_torch.ops import pruned

    lp, d = ix.pmask.shape[1], Q.shape[-1]
    args = (Q, qm, ix.P, ix.pmask, cand, ix.scales)
    ms, lo, hi = cuda_ms(lambda: pruned.rerank_int8_cuda(*args), 7)
    chunk = pruned.rerank_chunk_q(cand.shape[1], lp, d)

    def plain():
        with pruned._f32_products():
            return torch.cat([pruned._rerank_scores(
                Q[s:s + chunk], qm[s:s + chunk], ix.P, ix.pmask,
                cand[s:s + chunk], ix.scales)
                for s in range(0, Q.shape[0], chunk)])

    plain_ms, _, _ = cuda_ms(plain, 3)
    got, want = pruned.rerank_int8_cuda(*args), plain()
    dead = want == -torch.inf
    check(torch.equal(got == -torch.inf, dead),
          "rerank kernel: -inf exactly where the plain version has it")
    err = float((got[~dead] - want[~dead]).abs().max())
    n_pick = cand.numel()
    nbytes = (n_pick * lp * (d + ix.scales.element_size() + 1)
              + tensor_bytes(Q, qm, cand) + n_pick * 4)
    pairs = float((qm.sum(1).float()[:, None]
                   * ix.pmask[cand].sum(-1).float()).sum())
    ops = 3 * 2.0 * d * pairs
    bms, by = bound(nbytes, ops, "bf16")
    distinct = int(cand.unique().numel())
    log(f"phase 21 time rerank_int8 (stage 2) at {Q.shape[0]}x{Q.shape[1]} "
        f"queries x {cand.shape[1]} candidates of {lp} x {d}: {ms:.3f} ms "
        f"median of 7 (spread {lo:.3f}-{hi:.3f}); bound {bms:.3f} ms by {by} "
        f"({bms / ms:.1%}; bytes {nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms, "
        f"operations {ops / PEAK_OPS['bf16'] * 1e3:.3f} ms at the f16 "
        f"peak); plain {plain_ms:.3f} ms (median of 3); max abs err "
        f"{err:.3e} (tol 1e-4); {distinct} distinct pages of {n_pick}; "
        f"library: none; {smi}")
    check(err <= 1e-4, "rerank kernel equals its plain version")
    return {"name": "rerank_int8", "route": "cuda",
            "source": "evdr_tpu_torch/csrc/rerank_int8.cu",
            "replaces": "none (XLA gather + einsum, "
                        "evdr_tpu/ops/pruned.py:81-147)",
            "launches": 0, "max_abs_err": err, "tol": 1e-4, "ms": ms,
            "ms_min": lo, "ms_max": hi, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by,
            "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_bound_ms": ops / PEAK_OPS["bf16"] * 1e3,
            "library_ms": None, "distinct_pages": distinct}


def pruned_full_cover(label, kw, P, pm, Q, qm):
    """The full-cover gate on PRUNE_FULL_DOCS pages: at n_candidates =
    n_docs the pruned top-K equals exact f32 MaxSim's over the stored index
    at every rank untied by more than 1e-3 (both f32; summation order
    alone), and the engine's own exact search (the kernels' numerics) at
    every rank untied by more than 5e-2. Returns the engine."""
    from evdr_tpu_torch import RetrievalEngine

    eng = RetrievalEngine(prune_centroids=PRUNE_K, normalize=False,
                          **kw).build(P, pm)
    n = eng.n_docs
    vals, idx = eng.search_dense(Q, qm, k=K, n_candidates=n)
    vf, if_ = exact_f32_top(eng.index, Q, qm, K + 1)
    ve, ie = eng.search_dense(Q, qm, k=K + 1)
    ok_f, n_f = untied_agreement(vf, if_, idx, 1e-3)
    ok_e, n_e = untied_agreement(ve, ie, idx, 5e-2)
    err = float(np.abs(vals - vf[:, :K]).max())
    log(f"phase 21 {label} at full cover ({n} pages, {Q.shape[0]} "
        f"queries): top-{K} equal to exact f32 MaxSim at {n_f} untied ranks: "
        f"{ok_f} (scores {err:.3e}); to the engine's exact search at {n_e} "
        f"ranks untied by 5e-2: {ok_e}")
    check(ok_f and ok_e and n_f > 0 and err <= 1e-3,
          f"{label}: pruned top-{K} at full cover is the exact top-{K}")
    return eng


def pruned_entry_points(eng, Q, qm, work):
    """A pruned PQ index through the files and CLIs: its codes and books
    written as a packed npz, loaded by RetrievalEngine.from_npz with
    prune_centroids (summaries from the decoded codes) and by
    tools/search.main with --prune_centroids / --n_candidates (rank 1
    equal to search_dense); tools/serve_http over the loaded engine
    reports pruned on /healthz and answers n_candidates requests."""
    from evdr_tpu_torch import RetrievalEngine
    from evdr_tpu_torch.data.packing import preprocess_queries
    from evdr_tpu_torch.tools import search
    from evdr_tpu_torch.tools.serve_http import make_server

    ix = eng.index
    n, nq, nc = eng.n_docs, min(64, Q.shape[0]), 200
    path = work / "pruned.pq.npz"
    np.savez(path, P_pq_codes=ix.P[:n].cpu().numpy(),
             P_pq_books=ix.books.cpu().numpy(),
             pmask=ix.pmask[:n].cpu().numpy(),
             doc_normalized=np.asarray(True),
             docid=np.asarray([f"page-{i}" for i in range(n)]),
             Q_norm=Q[:nq].cpu().numpy(), qmask=qm[:nq].cpu().numpy(),
             qid=np.asarray([f"q{i}" for i in range(nq)]))
    t0 = time.perf_counter()
    eng2 = RetrievalEngine.from_npz(path, dtype="pq",
                                    prune_centroids=PRUNE_K)
    t_load = time.perf_counter() - t0
    check(eng2.summary is not None and eng2.summary.P.dtype ==
          torch.bfloat16 and eng2.n_docs == n, "from_npz: pq + summaries")
    _, idx = eng2.search_dense(Q[:nq], qm[:nq], k=K, n_candidates=nc)
    direct = [r[0] for r in eng2.ids_for(idx)]
    run = work / "run.pruned.json"
    search.main(["--index", str(path), "--queries", str(path), "--dtype",
                 "pq", "--prune_centroids", str(PRUNE_K), "--n_candidates",
                 str(nc), "--k", str(K), "--format", "json", "--out",
                 str(run)])
    ranked = json.loads(run.read_text())
    cli = [next(iter(ranked[f"q{i}"])) for i in range(nq)]
    check(cli == direct, "pruned search CLI rank 1 equals search_dense")
    srv = make_server(eng2, port=0, default_candidates=nc)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        qs = [q[m].cpu().numpy() for q, m in zip(Q[:4], qm[:4])]
        body = json.dumps({"queries": [q.tolist() for q in qs], "k": K,
                           "n_candidates": nc}).encode()
        req = urllib.request.Request(url + "/search", data=body, headers={
            "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            reply = json.loads(r.read())
        qobj = np.empty(4, dtype=object)
        qobj[:] = qs
        Qh, qmh = preprocess_queries(qobj, None, length_multiple=8)
        _, idx_h = eng2.search_dense(Qh, qmh, k=K, n_candidates=nc)
        top1 = [r[0] for r in reply["docids"]] == [
            r[0] for r in eng2.ids_for(idx_h)]
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    log(f"phase 21 entry points: packed pq npz of {n} pages through "
        f"from_npz(prune_centroids={PRUNE_K}) {t_load:.1f} s (summaries "
        f"from the decoded codes); search CLI --n_candidates {nc} rank 1 "
        f"equal to search_dense: {cli == direct}; serve_http /healthz "
        f"{health}, /search top-1 equal: {top1}")
    check(health["pruned"] is True and top1, "serve_http over a pruned engine")


def pruned_phase(gen, smi, root):
    """Phase 21: pruned two-stage search. Float pages at phase 4's shape
    (50,000 x 768, D = 128, random unit tokens ~10% masked) and planted
    queries (256 x 32); engines with prune_centroids = PRUNE_K through
    build: int8 (int8 summaries: stage 1 on K2), the same with
    quantize_queries (K2's full mode), int8 with int4 summaries (K4), and
    pq (bf16 summaries: K1, the PLAID combination); each at 1% and 5%
    candidates (pruned_engine). The full-cover gate on the first
    PRUNE_FULL_DOCS pages for int8 and pq, and the pq index's files and
    CLIs. Random unit pages have no clusters for the summaries to find:
    the recall is reported, not gated."""
    from evdr_tpu_torch.ops import pruned

    t0 = time.perf_counter()
    P, pm = make_pages(PRUNE_DOCS, gen)
    pm[123] = False                   # a doc with no valid token
    Q, qm, _ = planted_queries(lambda t: P[t], PRUNE_DOCS, gen)
    t1 = time.perf_counter()
    S, sm = pruned.build_summary_tokens(P, pm, PRUNE_K)
    torch.cuda.synchronize()
    t_sum = time.perf_counter() - t1
    log(f"phase 21 data: {PRUNE_DOCS} pages x {LP} x {D}, {Q.shape[0]} "
        f"planted queries x {Q.shape[1]}; summary build (k-means, "
        f"{PRUNE_K} centres a page, 5 Lloyd steps) {t_sum:.2f} s, "
        f"{int(sm.sum())} occupied centres")
    del S, sm
    reports, stage1 = [], {}
    for label, kw in (("int8", dict(dtype="int8")),
                      ("int8+quantize_queries",
                       dict(dtype="int8", quantize_queries=True)),
                      ("int8, int4 summaries",
                       dict(dtype="int8", summary_dtype="int4")),
                      ("pq", dict(dtype="pq"))):
        rep, shapes = pruned_engine(label, kw, P, pm, Q, qm, smi)
        rep["summary_build_s"] = t_sum
        reports.append(rep)
        for (w, f, nq_, lq_, nd_, lp_), n_l in sorted(shapes.items()):
            stage1.setdefault((w, f), []).append(
                {"nq": nq_, "lq": lq_, "nd": nd_, "lp": lp_,
                 "launches": n_l})
    nf, nq = PRUNE_FULL_DOCS, 64
    Pf, pmf = P[:nf].clone(), pm[:nf].clone()
    del P, pm
    torch.cuda.empty_cache()
    pruned_full_cover("int8", dict(dtype="int8"), Pf, pmf, Q[:nq], qm[:nq])
    eng_pq = pruned_full_cover("pq", dict(dtype="pq"), Pf, pmf, Q[:nq],
                               qm[:nq])
    work = root / "build" / "chip_smoke_pruned"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        pruned_entry_points(eng_pq, Q, qm, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 21: {time.perf_counter() - t0:.1f} s")
    return reports, stage1


# ------------------------------------------- incremental serving (phase 22)


def inc_plan(n_main):
    """Phase 22's mutations on a main index of ``n_main`` rows: docids,
    the added pages' ids (part 3's first INC_UPSERT upsert main docids),
    the deleted docids (INC_DELETE main rows that are not upserted, and
    INC_DELETE added pages that do not upsert), the dead global rows (main
    rows first, then the added pages), the live rows and their ids in that
    order, and the planted targets: NQ/4 live main docs, NQ/4 live added
    pages, NQ/4 deleted docs (half main, half added) and the rest on the
    upserted pages."""
    per = INC_ADD // len(INC_ADD_LP)
    ups_pos = list(range(2 * per, 2 * per + INC_UPSERT))
    ups_main = [(7919 * j + 101) % n_main for j in range(INC_UPSERT)]
    main_ids = [f"m{i}" for i in range(n_main)]
    add_ids = [f"a{p}" for p in range(INC_ADD)]
    for p, u in zip(ups_pos, ups_main):
        add_ids[p] = main_ids[u]
    del_main, j = [], 0
    while len(del_main) < INC_DELETE:
        i = (104729 * j + 13) % n_main
        j += 1
        if i not in ups_main and i not in del_main:
            del_main.append(i)
    del_pos = [p for p in range(1, INC_ADD) if p not in ups_pos][::3][
        :INC_DELETE]
    dead = set(ups_main) | set(del_main) | {n_main + p for p in del_pos}
    live = [i for i in range(n_main + INC_ADD) if i not in dead]

    def gid(i):
        return main_ids[i] if i < n_main else add_ids[i - n_main]

    live_main = [i for i in live if i < n_main]
    live_add = [i for i in live if i >= n_main and i - n_main not in ups_pos]
    q4 = NQ // 4
    targets = ([live_main[(7919 * q + 3) % len(live_main)]
                for q in range(q4)]
               + [live_add[(7919 * q + 5) % len(live_add)] for q in range(q4)]
               + [del_main[q % INC_DELETE] for q in range(q4 // 2)]
               + [n_main + del_pos[q % INC_DELETE]
                  for q in range(q4 - q4 // 2)]
               + [n_main + ups_pos[q % INC_UPSERT]
                  for q in range(NQ - 3 * q4)])
    live_q = np.r_[0:2 * q4, 3 * q4:NQ]
    return {"n_main": n_main, "per": per, "main_ids": main_ids,
            "add_ids": add_ids, "deleted": [gid(i) for i in del_main]
            + [add_ids[p] for p in del_pos], "dead": dead, "live": live,
            "live_ids": [gid(i) for i in live], "targets": targets,
            "target_ids": [gid(t) for t in targets], "live_q": live_q}


def added_pages(gen):
    """The INC_ADD pages phase 22 adds: unit float tokens, ~10% masked, in
    parts of INC_ADD_LP tokens. Returns the parts as host arrays (what
    add() takes) and all of them padded to LP on the device."""
    per = INC_ADD // len(INC_ADD_LP)
    Pt = torch.zeros((INC_ADD, LP, D), dtype=torch.float32, device=DEVICE)
    pmt = torch.zeros((INC_ADD, LP), dtype=torch.bool, device=DEVICE)
    parts = []
    for j, lp in enumerate(INC_ADD_LP):
        x = unit(torch.randn((per, lp, D), device=DEVICE, generator=gen))
        m = torch.rand((per, lp), device=DEVICE, generator=gen) > 0.1
        Pt[j * per:(j + 1) * per, :lp] = x
        pmt[j * per:(j + 1) * per, :lp] = m
        parts.append((x.cpu().numpy(), m.cpu().numpy()))
    return parts, Pt, pmt


def plant(tokens, mask, gen):
    """Planted queries on given docs: each copies LQ of its doc's valid
    tokens, plus noise of norm ~0.5, ~15% of query tokens masked."""
    nq = tokens.shape[0]
    pos = torch.multinomial(mask.float() + 1e-6, LQ, replacement=True,
                            generator=gen)
    base = tokens[torch.arange(nq, device=DEVICE)[:, None], pos]
    noise = torch.randn(base.shape, device=DEVICE, generator=gen) * (
        0.5 / D ** 0.5)
    qm = torch.rand((nq, LQ), device=DEVICE, generator=gen) > 0.15
    qm[:, 0] = True
    return unit(base + noise), qm


def inc_queries(plan, main_tokens, main_pmask, Pt, pmt, gen):
    """Phase 22's planted queries: main targets from ``main_tokens`` (the
    stored tokens, dequantized or decoded), added ones from the pages."""
    t = torch.as_tensor(plan["targets"], device=DEVICE)
    is_main = t < plan["n_main"]
    tm, ta = t[is_main], t[~is_main] - plan["n_main"]
    tok = torch.empty((t.shape[0], LP, D), device=DEVICE)
    msk = torch.empty((t.shape[0], LP), dtype=torch.bool, device=DEVICE)
    tok[is_main], msk[is_main] = main_tokens(tm), main_pmask[tm]
    tok[~is_main], msk[~is_main] = Pt[ta], pmt[ta]
    return plant(tok, msk, gen)


def qps(eng, Q, qm, **kw):
    """search_dense queries/s of one timed call after a warm one."""
    eng.search_dense(Q, qm, k=K, **kw)
    t0 = time.perf_counter()
    eng.search_dense(Q, qm, k=K, **kw)
    return Q.shape[0] / (time.perf_counter() - t0)


def mutate(eng, plan, parts):
    """The adds (four calls), the first search (the lazy tail build) and
    the deletes, each timed on the host clock; returns the times."""
    t0 = time.perf_counter()
    for j, (x, m) in enumerate(parts):
        eng.add(x, m, docids=plan["add_ids"][j * plan["per"]:
                                             (j + 1) * plan["per"]])
    t_add = time.perf_counter() - t0
    check(eng.tail is None and eng.n_docs == plan["n_main"] + INC_ADD
          - INC_UPSERT, "adds are pending until the next search")
    q = torch.zeros((1, 8, D), device=DEVICE)
    q[:, :, 0] = 1.0
    t0 = time.perf_counter()
    eng.search_dense(q, torch.ones((1, 8), dtype=torch.bool, device=DEVICE),
                     k=K)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_del = eng.delete(plan["deleted"])
    t_del = time.perf_counter() - t0
    check(n_del == 2 * INC_DELETE and eng.n_docs == len(plan["live"]),
          f"deleted {n_del}, n_docs {eng.n_docs}")
    check(eng.tail.n_docs == INC_ADD and eng.tail.n_pad % 64 == 0
          and eng.tail.pmask.shape[1] == LP, "tail: rows and Lp unified")
    return {"add_ms": t_add * 1e3, "first_search_s": t_first,
            "delete_ms": t_del * 1e3}


def top_agree(ref_vals, ref_ids, ids, vals, gap, tol):
    """Whether ``ids``/``vals`` (nq, K) equal the reference's top-(K + 1)
    ids at every rank of the first K untied by more than ``gap`` and its
    scores within ``tol``; returns (agree, untied ranks, bit-equal)."""
    v = np.asarray(ref_vals, np.float64)
    step = v[:, :-1] - v[:, 1:]
    above = np.concatenate([np.full((v.shape[0], 1), np.inf), step], 1)
    untied = (above[:, :K] > gap) & (step[:, :K] > gap)
    same = np.asarray([a[:K] for a in ref_ids]) == np.asarray(ids)
    err = float(np.abs(np.asarray(ref_vals)[:, :K] - vals).max())
    bit = bool(same.all()) and bool(
        (np.asarray(ref_vals)[:, :K] == vals).all())
    return bool(same[untied].all()) and err <= tol, int(untied.sum()), bit


def inc_gates(label, eng, plan, vals, idx, gate_recall=True):
    """No deleted doc returned (by row and by id) and, with
    ``gate_recall``, recall@1 of the live targets 1.0. Returns the ids and
    recall@1."""
    ids = eng.ids_for(idx)
    dead_rows = np.fromiter(plan["dead"], np.int64)
    check(not np.isin(idx, dead_rows).any(), f"{label}: a deleted row "
          "was returned")
    deleted = set(plan["deleted"])
    check(not deleted & {x for row in ids for x in row},
          f"{label}: a deleted docid was returned")
    lq = plan["live_q"]
    r1 = float(np.mean([ids[q][0] == plan["target_ids"][q] for q in lq]))
    check(r1 == 1.0 or not gate_recall,
          f"{label}: recall@1 on the live targets {r1}")
    return ids, r1


def merged_tail_share(eng, Q, qm):
    """CUDA-event medians of the merged top-k and of its tail scoring
    alone, on the engine's own operands: (merged ms, tail ms)."""
    from evdr_tpu_torch.parallel.topk import (_local_scores,
                                              _single_device_merged_topk)

    Qd, qmd = eng._queries(Q, qm)
    ix, tl = eng.index, eng.tail
    alive = eng._alive_mask()
    m_ms, _, _ = cuda_ms(lambda: _single_device_merged_topk(
        Qd, qmd, ix.P, ix.pmask, tl.P, tl.pmask, alive, K, eng.impl,
        ix.n_docs, tl.n_docs, scales_m=ix.scales, scales_t=tl.scales,
        books=ix.books), 7)
    t_ms, _, _ = cuda_ms(lambda: _local_scores(
        Qd, qmd, tl.P, tl.pmask, eng.impl, tl.scales, ix.books), 7)
    return m_ms, t_ms


def inc_engine(label, eng, plan, parts, Q, qm):
    """One engine of phase 22: q/s before the adds, the mutations, then
    the merged search with the counts set to 0 just before it (its
    launches by shape), its q/s, the gates, the tail's share. Returns
    (report, vals, idx, launches)."""
    from evdr_tpu_torch.ops import cuda_maxsim as cm

    rep = {"engine": label, "qps_before_add": qps(eng, Q, qm)}
    rep.update(mutate(eng, plan, parts))
    cm.reset_launch_counts()
    vals, idx = eng.search_dense(Q, qm, k=K)
    torch.cuda.synchronize()
    launches = [{"func": f, "nq": nq_, "lq": lq_, "nd": nd_, "lp": lp_,
                 "launches": n} for (w, f, nq_, lq_, nd_, lp_), n in
                sorted(cm.launch_shapes.items())]
    check(vals.shape == (Q.shape[0], K) and np.isfinite(vals).all(),
          f"{label}: merged output shape, finite")
    check(sorted(x["nd"] for x in launches) == sorted(
        [eng.index.n_pad, eng.tail.n_pad]), f"{label}: one launch on the "
        f"main index and one on the tail: {launches}")
    _, rep["recall_at_1_live"] = inc_gates(label, eng, plan, vals, idx)
    rep["qps_with_tail"] = qps(eng, Q, qm)
    m_ms, t_ms = merged_tail_share(eng, Q, qm)
    rep.update(merged_ms=m_ms, tail_ms=t_ms, tail_share=t_ms / m_ms)
    return rep, vals, idx, launches


def fresh_gate(label, rep, eng, fresh, plan, Q, qm, vals, idx):
    """The merged top-K against a fresh engine built from the live corpus
    in the same order: ids equal at every rank untied by more than 1e-6,
    scores within 1e-5 (bit-equal is logged)."""
    fv, fi = fresh.search_dense(Q, qm, k=K + 1)
    ok, n_untied, bit = top_agree(fv, fresh.ids_for(fi), eng.ids_for(idx),
                                  vals, 1e-6, 1e-5)
    rep.update(fresh_untied_ranks=n_untied, fresh_bit_equal=bit)
    check(ok and n_untied > 0, f"{label}: merged top-{K} equals a fresh "
          "engine's")


def compact_and_save(label, eng, Q, qm, vals, idx, work, eager):
    """compact() (timed) keeps the top-K; save_npz (timed), then
    from_npz(mmap=True) and, with ``eager``, from_npz() (each timed) give
    the same top-K as the compacted engine."""
    from evdr_tpu_torch import RetrievalEngine

    ids0 = eng.ids_for(idx)
    rep = {}
    t0 = time.perf_counter()
    eng.compact()
    torch.cuda.synchronize()
    rep["compact_s"] = time.perf_counter() - t0
    check(eng.tail is None and not eng._tombstones
          and eng.index.n_docs == eng.n_docs, f"{label}: compacted")
    v1, i1 = eng.search_dense(Q, qm, k=K + 1)
    ok, n_untied, bit = top_agree(v1, eng.ids_for(i1), ids0, vals, 1e-6,
                                  1e-5)
    rep["compact_bit_equal"] = bit
    check(ok and n_untied > 0, f"{label}: compact keeps the results")
    path = work / f"{label.replace('+', '_')}.npz"
    t0 = time.perf_counter()
    eng.save_npz(path)
    rep["save_s"] = time.perf_counter() - t0
    rep["file_gb"] = path.stat().st_size / 1e9
    kw = dict(dtype=eng.dtype, pq_m=eng.pq_m,
              quantize_queries=eng.impl.endswith("_q8"))
    for mmap in (True, False) if eager else (True,):
        t0 = time.perf_counter()
        e2 = RetrievalEngine.from_npz(path, mmap=mmap, **kw)
        torch.cuda.synchronize()
        rep["load_mmap_s" if mmap else "load_eager_s"] = (
            time.perf_counter() - t0)
        v2, i2 = e2.search_dense(Q, qm, k=K)
        same = e2.ids_for(i2) == eng.ids_for(i1[:, :K]) and bool(
            (v2 == v1[:, :K]).all())
        check(same and e2.n_docs == eng.n_docs, f"{label}: from_npz("
              f"mmap={mmap}) of the saved file gives the same top-{K}")
        del e2
    path.unlink()
    return rep


def inc_int8(gen, plan, parts, Pt, pmt, work):
    """Phase 22's int8 engines (K2 full and K2) over INC_DOCS pages built
    from codes, sharing one index; each takes the mutations."""
    from evdr_tpu_torch import RetrievalEngine
    from evdr_tpu_torch.ops.quantize import quantize_tokens_int8

    codes, scales, pm = make_int8_pages(INC_DOCS, gen, quantize_tokens_int8)
    eq = RetrievalEngine(dtype="int8", quantize_queries=True,
                         normalize=False).build_from_codes(
        codes, scales, pm, docids=plan["main_ids"])
    del codes, scales
    ix = eq.index
    ei = RetrievalEngine.from_index(ix.P, ix.pmask, ix.n_docs,
                                    scales=ix.scales, docids=ix.docids,
                                    dtype="int8", normalize=False)
    Q, qm = inc_queries(plan, lambda t: ix.P[t].float()
                        * ix.scales[t][..., None], ix.pmask, Pt, pmt, gen)
    out = {}
    for label, eng in (("int8+quantize_queries", eq), ("int8", ei)):
        out[label] = inc_engine(label, eng, plan, parts, Q, qm)
    keep = torch.as_tensor([i for i in plan["live"] if i < INC_DOCS],
                           device=DEVICE)
    keep_t = torch.as_tensor([i - INC_DOCS for i in plan["live"]
                              if i >= INC_DOCS], device=DEVICE)
    tc, ts = quantize_tokens_int8(Pt, pmt)
    check(torch.equal(tc[:INC_ADD], ei.tail.P[:INC_ADD]),
          "int8 tail codes: those of the added pages")
    fq = RetrievalEngine(dtype="int8", quantize_queries=True,
                         normalize=False).build_from_codes(
        torch.cat([ix.P[keep], tc[keep_t]]),
        torch.cat([ix.scales[keep], ts[keep_t]]),
        torch.cat([ix.pmask[keep], pmt[keep_t]]), docids=plan["live_ids"])
    fi = RetrievalEngine.from_index(
        fq.index.P, fq.index.pmask, fq.index.n_docs, scales=fq.index.scales,
        docids=fq.index.docids, dtype="int8", normalize=False)
    del tc, ts
    for label, eng, fresh in (("int8+quantize_queries", eq, fq),
                              ("int8", ei, fi)):
        rep, vals, idx, _ = out[label]
        fresh_gate(label, rep, eng, fresh, plan, Q, qm, vals, idx)
    del fq, fi
    torch.cuda.empty_cache()
    rep, vals, idx, _ = out["int8"]
    rep.update(compact_and_save("int8", ei, Q, qm, vals, idx, work,
                                "int8" in INC_EAGER))
    del eq, ei, ix
    torch.cuda.empty_cache()
    return out


def inc_bf16_int4(cm, gen, plan_bf, plan, parts, Pt, pmt, work):
    """Phase 22's bf16 engine (K1, INC_BF16_DOCS pages through build) and
    int4 engine (K4, INC_DOCS pages from packed codes), each against a
    fresh build of its live corpus."""
    from evdr_tpu_torch import RetrievalEngine
    from evdr_tpu_torch.ops.int4 import quantize_tokens_int4

    out = {}
    Pf, pmf = make_pages(INC_BF16_DOCS, gen)
    eb = RetrievalEngine(dtype="bfloat16", normalize=False).build(
        Pf, pmf, docids=plan_bf["main_ids"])
    del Pf
    bx = eb.index
    Q, qm = inc_queries(plan_bf, lambda t: bx.P[t].float(), bx.pmask, Pt,
                        pmt, gen)
    rep, vals, idx, launches = inc_engine("bfloat16", eb, plan_bf, parts,
                                          Q, qm)
    n = INC_BF16_DOCS
    keep = torch.as_tensor([i for i in plan_bf["live"] if i < n],
                           device=DEVICE)
    keep_t = torch.as_tensor([i - n for i in plan_bf["live"] if i >= n],
                             device=DEVICE)
    fresh = RetrievalEngine(dtype="bfloat16", normalize=False).build(
        torch.cat([bx.P[keep].float(), Pt[keep_t]]),
        torch.cat([bx.pmask[keep], pmt[keep_t]]), docids=plan_bf["live_ids"])
    fresh_gate("bfloat16", rep, eb, fresh, plan_bf, Q, qm, vals, idx)
    del fresh
    rep.update(compact_and_save("bfloat16", eb, Q, qm, vals, idx, work,
                                "bfloat16" in INC_EAGER))
    out["bfloat16"] = (rep, vals, idx, launches)
    del eb, bx
    torch.cuda.empty_cache()

    packed, sc, pm4 = make_int8_pages(INC_DOCS, gen, quantize_tokens_int4,
                                      rows=(LP + 1) // 2, dtype=torch.uint8)
    e4 = RetrievalEngine(dtype="int4", normalize=False).build_from_codes4(
        packed, sc, pm4, docids=plan["main_ids"])
    del packed, sc
    ix = e4.index
    Q, qm = inc_queries(plan, lambda t: cm.unpack_int4_torch(
        ix.P[t], LP).float() * ix.scales[t][..., None], ix.pmask, Pt, pmt,
        gen)
    rep, vals, idx, launches = inc_engine("int4", e4, plan, parts, Q, qm)
    keep = torch.as_tensor([i for i in plan["live"] if i < INC_DOCS],
                           device=DEVICE)
    keep_t = torch.as_tensor([i - INC_DOCS for i in plan["live"]
                              if i >= INC_DOCS], device=DEVICE)
    tc, ts = quantize_tokens_int4(Pt, pmt)
    fresh = RetrievalEngine(dtype="int4", normalize=False).build_from_codes4(
        torch.cat([ix.P[keep], tc[keep_t]]),
        torch.cat([ix.scales[keep], ts[keep_t]]),
        torch.cat([ix.pmask[keep], pmt[keep_t]]), docids=plan["live_ids"])
    del tc, ts
    fresh_gate("int4", rep, e4, fresh, plan, Q, qm, vals, idx)
    del fresh
    rep.update(compact_and_save("int4", e4, Q, qm, vals, idx, work,
                                "int4" in INC_EAGER))
    out["int4"] = (rep, vals, idx, launches)
    del e4, ix
    torch.cuda.empty_cache()
    return out


def inc_pq(cm, gen, seed, plan, parts, Pt, pmt, work):
    """Phase 22's pq engine (K3, compact books, M = PQ_M) over INC_DOCS
    pages: books from a token sample, codes encoded on the device; the
    merged top-K held to the plain version on the stored main and tail
    codes (64 queries): ids at every rank untied by more than 2e-2,
    scores within 2e-2 (the tolerance of phase 13)."""
    from evdr_tpu_torch import RetrievalEngine
    from evdr_tpu_torch.ops.pq import encode_pq_device, train_pq
    from evdr_tpu_torch.parallel.topk import _select_topk

    Pc, pmc = make_pages(min(1_000, INC_DOCS), gen)
    books = train_pq(Pc, pmc, m=PQ_M, sample=PQ_SAMPLE, seed=seed)
    codes = torch.empty((INC_DOCS, LP, PQ_M), dtype=torch.uint8,
                        device=DEVICE)
    pmq = torch.empty((INC_DOCS, LP), dtype=torch.bool, device=DEVICE)
    for i in range(0, INC_DOCS, 1_000):
        if i:
            Pc, pmc = make_pages(min(1_000, INC_DOCS - i), gen)
        codes[i:i + Pc.shape[0]] = encode_pq_device(Pc, books, pmc)
        pmq[i:i + Pc.shape[0]] = pmc
    del Pc, pmc
    eng = RetrievalEngine(dtype="pq", normalize=False).build_from_pq(
        codes, books, pmq, docids=plan["main_ids"])
    del codes
    ix = eng.index
    Q, qm = inc_queries(plan, lambda t: pq_tokens(ix.P[t], ix.books),
                        ix.pmask, Pt, pmt, gen)
    rep, vals, idx, launches = inc_engine("pq", eng, plan, parts, Q, qm)
    nq = 64
    tl = eng.tail
    sc = torch.cat([
        cm.maxsim_pq_plain(Q[:nq], ix.P, qm[:nq], ix.pmask,
                           ix.books)[:, :ix.n_docs],
        cm.maxsim_pq_plain(Q[:nq], tl.P, qm[:nq], tl.pmask,
                           tl.books)[:, :tl.n_docs]], dim=1)
    sc = sc.masked_fill(~eng._alive_mask()[None, :], -torch.inf)
    pv, pi = _select_topk(sc, K + 1)
    ok, n_untied, _ = top_agree(pv.cpu().numpy(), eng.ids_for(pi.cpu()),
                                eng.ids_for(idx[:nq]), vals[:nq], 2e-2,
                                2e-2)
    rep["plain_untied_ranks"] = n_untied
    check(ok and n_untied > 0, "pq: merged top-K against the plain version "
          "on main + tail")
    rep.update(compact_and_save("pq", eng, Q, qm, vals, idx, work,
                                "pq" in INC_EAGER))
    del eng, ix, tl
    torch.cuda.empty_cache()
    return {"pq": (rep, vals, idx, launches)}


def inc_pruned(gen, parts, Pt, pmt, work):
    """Phase 22's pruned int8 engine (prune_centroids = PRUNE_K) on
    INC_PRUNE_DOCS float pages, with the mutations: at INC_PRUNE_CANDS
    candidates and at n_candidates = n_docs no deleted doc returned, and
    at n_docs its top-K equals its exact merged search at every rank
    untied by more than 5e-2 (stage 2 reranks main candidates in f32, the
    tail is scored by the kernel); then compact rebuilds the summaries,
    and the server takes over the compacted engine (http_incremental)."""
    from evdr_tpu_torch import RetrievalEngine

    plan = inc_plan(INC_PRUNE_DOCS)
    P, pm = make_pages(INC_PRUNE_DOCS, gen)
    eng = RetrievalEngine(dtype="int8", prune_centroids=PRUNE_K,
                          normalize=False).build(P, pm,
                                                 docids=plan["main_ids"])
    Q, qm = inc_queries(plan, lambda t: P[t], pm, Pt, pmt, gen)
    rep = {"engine": "int8 pruned", **mutate(eng, plan, parts)}
    n = eng.n_docs
    for nc in (INC_PRUNE_CANDS, n):
        t0 = time.perf_counter()
        vals, idx = eng.search_dense(Q, qm, k=K, n_candidates=nc)
        rep[f"s_at_{nc}"] = time.perf_counter() - t0
        check(idx.shape == (Q.shape[0], K), "pruned output shape")
        # random pages have no clusters for the summaries to find: the
        # recall at INC_PRUNE_CANDS is reported, at full cover gated
        _, rep[f"recall_at_1_live_{nc}"] = inc_gates(
            f"pruned at {nc}", eng, plan, vals, idx, gate_recall=nc == n)
    ve, ie = eng.search_dense(Q, qm, k=K + 1)
    ok, n_untied = untied_agreement(ve, ie, idx, 5e-2)
    rep["full_cover_untied_ranks"] = n_untied
    check(ok and n_untied > 0, "pruned at full cover equals the exact "
          "merged search")
    old = eng.summary
    t0 = time.perf_counter()
    eng.compact()
    rep["compact_s"] = time.perf_counter() - t0
    check(eng.summary is not old and eng.summary.n_docs == n,
          "pruned compact rebuilt the summaries")
    v2, i2 = eng.search_dense(Q, qm, k=K, n_candidates=n)
    ids = eng.ids_for(i2)
    r1 = float(np.mean([ids[q][0] == plan["target_ids"][q]
                        for q in plan["live_q"]]))
    rep["recall_at_1_live_after_compact"] = r1
    check(r1 == 1.0 and not set(plan["deleted"]) & {
        x for row in ids for x in row}, "pruned after compact")
    http_incremental(eng, Q, qm, work)
    return rep


def http_incremental(eng, Q, qm, work):
    """tools/serve_http with --save_dir over ``eng``: POST /add of a page
    (a query on it finds it at rank 1), /delete of the top doc of a query
    (gone from its results), /save (the file reloads with the same
    top-K)."""
    from evdr_tpu_torch import RetrievalEngine
    from evdr_tpu_torch.tools.serve_http import make_server

    srv = make_server(eng, port=0, save_dir=str(work))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()

    def post(path, obj):
        req = urllib.request.Request(url + path, data=json.dumps(
            obj).encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        n0 = eng.n_docs
        page = unit(torch.randn((64, D), device=DEVICE)).cpu().numpy()
        added = post("/add", {"documents": [page.tolist()],
                              "docids": ["http-page"]})
        q = [page[:LQ].tolist()]
        hit = post("/search", {"queries": q, "k": K})["docids"][0][0]
        top = post("/search", {"queries": [Q[0][qm[0]].cpu().numpy(
            ).tolist()], "k": K})["docids"][0]
        deleted = post("/delete", {"docids": [top[0]]})
        after = post("/search", {"queries": [Q[0][qm[0]].cpu().numpy(
            ).tolist()], "k": K})["docids"][0]
        saved = post("/save", {"path": "http.npz"})
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    e2 = RetrievalEngine.from_npz(work / "http.npz", dtype=eng.dtype,
                                  mmap=True)
    v1, i1 = eng.search_dense(Q, qm, k=K)
    v2, i2 = e2.search_dense(Q, qm, k=K)
    same = e2.ids_for(i2) == eng.ids_for(i1) and bool((v1 == v2).all())
    log(f"phase 22 serve_http --save_dir: /add {added}, /search of the "
        f"added page rank 1 {hit!r}, /delete of {top[0]!r} {deleted}, gone "
        f"from its results: {top[0] not in after}, /save {saved}; reloaded "
        f"top-{K} equal: {same}")
    check(added == {"added": 1, "n_docs": n0 + 1} and hit == "http-page"
          and deleted == {"deleted": 1, "n_docs": n0}
          and top[0] not in after and saved["n_docs"] == n0 and same,
          "serve_http add/delete/search/save")
    (work / "http.npz").unlink()
    del e2


def rss_tool(root):
    """scripts/torch_measure_rss.py on RSS_DOCS int8 pages: eager and
    memory-mapped loads, each in its own process on the card."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, str(root / "scripts" / "torch_measure_rss.py"),
         "--n_docs", str(RSS_DOCS), "--lp", str(LP), "--dim", str(D),
         "--device", DEVICE], cwd=str(root), capture_output=True,
        text=True, timeout=600)
    check(out.returncode == 0, f"torch_measure_rss.py failed: "
          f"{out.stderr[-2000:]}")
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    rep["wall_s"] = time.perf_counter() - t0
    return rep


def check_rss(rep):
    """The mmap load streams: its peak anonymous RSS stays within a few
    stream chunks of its baseline (a whole anonymous copy of the file
    would exceed that many times over), measured on pages the tool could
    tell from mapped file pages."""
    from evdr_tpu_torch.parallel.sharded_index import STREAM_CHUNK_BYTES

    e, m = rep["eager"], rep["mmap"]
    bound = 4 * STREAM_CHUNK_BYTES / 1e6 + 256.0
    check(bound < rep["file_mb"] / 4, f"RSS file too small for the mmap "
          f"bound: {rep['file_mb']:.1f} MB against {bound:.1f} MB")
    check(e["rss_source"] == m["rss_source"] and m["rss_source"] in (
        "status", "smaps"), f"RSS source {m['rss_source']!r}")
    check(m["peak_anon_above_baseline_mb"] < bound
          and m["n_docs"] == e["n_docs"] == RSS_DOCS,
          f"mmap load's anonymous peak "
          f"+{m['peak_anon_above_baseline_mb']:.1f} MB under the "
          f"{bound:.1f} MB bound (4 stream chunks + 256 MB)")


def incremental_phase(cm, gen, seed, smi, root):
    """Phase 22: incremental serving at the serving shape. Returns the
    reports and the merged searches' launches by kernels-line entry."""
    t0 = time.perf_counter()
    work = root / "build" / "chip_smoke_incremental"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    plan = inc_plan(INC_DOCS)
    parts, Pt, pmt = added_pages(gen)
    try:
        engines = inc_int8(gen, plan, parts, Pt, pmt, work)
        engines.update(inc_bf16_int4(cm, gen, inc_plan(INC_BF16_DOCS), plan,
                                     parts, Pt, pmt, work))
        engines.update(inc_pq(cm, gen, seed, plan, parts, Pt, pmt, work))
        pruned_rep = inc_pruned(gen, parts, Pt, pmt, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for label, (rep, _, _, launches) in engines.items():
        log(f"phase 22 {label}: search_dense {rep['qps_before_add']:.1f} q/s "
            f"before add, {rep['qps_with_tail']:.1f} with the tail and "
            f"tombstones; 4 adds {rep['add_ms']:.1f} ms, first search "
            f"after them (the tail build) {rep['first_search_s']:.3f} s, "
            f"delete of {2 * INC_DELETE} {rep['delete_ms']:.1f} ms; merged "
            f"top-k {rep['merged_ms']:.3f} ms, of it the tail's scores "
            f"{rep['tail_ms']:.3f} ms ({rep['tail_share']:.1%}); recall@1 "
            f"on the live targets {rep['recall_at_1_live']:.4f}; launches "
            f"{launches}; {smi}")
        extra = {k: v for k, v in rep.items() if k.startswith(
            ("fresh", "plain", "compact", "save", "load", "file"))}
        log(f"phase 22 {label} gates and maintenance: {extra}")
    log(f"phase 22 pruned: {pruned_rep}")
    rss = rss_tool(root)
    log(f"phase 22 host memory ({RSS_DOCS} int8 pages, "
        f"{rss['file_mb']:.1f} MB file): eager peak RssAnon "
        f"+{rss['eager']['peak_anon_above_baseline_mb']:.1f} MB, RssFile "
        f"+{rss['eager']['peak_file_above_baseline_mb']:.1f} MB, ru_maxrss "
        f"{rss['eager']['ru_maxrss_mb']:.1f} MB, load "
        f"{rss['eager']['load_s']:.2f} s; mmap peak RssAnon "
        f"+{rss['mmap']['peak_anon_above_baseline_mb']:.1f} MB, RssFile "
        f"+{rss['mmap']['peak_file_above_baseline_mb']:.1f} MB, ru_maxrss "
        f"{rss['mmap']['ru_maxrss_mb']:.1f} MB, load "
        f"{rss['mmap']['load_s']:.2f} s (above each process's baseline "
        f"with its CUDA context up; from /proc/self/"
        f"{rss['mmap']['rss_source']}); {smi}")
    check_rss(rss)
    reports = [rep for rep, _, _, _ in engines.values()]
    reports += [pruned_rep, {"rss": rss}]
    by_entry = {"int8+quantize_queries": "maxsim_int8full",
                "int8": "maxsim_int8", "bfloat16": "maxsim_bf16",
                "int4": "maxsim_int4", "pq": "maxsim_pq"}
    launches = {by_entry[k]: v[3] for k, v in engines.items()}
    log(f"phase 22: {time.perf_counter() - t0:.1f} s")
    return reports, launches


# ------------------------------------------ multi-device serving (phase 23)


def mesh_device():
    """The card's first device by index (a mesh names its devices)."""
    return "cuda:0" if DEVICE == "cuda" else DEVICE


def mesh_search(cm, eng, Q, qm, **kw):
    """One search_dense with the launch counts set to 0 just before it:
    (vals, idx, {wrapper: launches}, [launch shapes])."""
    cm.reset_launch_counts()
    vals, idx = eng.search_dense(Q, qm, k=K, **kw)
    torch.cuda.synchronize()
    shapes = [{"func": f, "nq": nq_, "lq": lq_, "nd": nd_, "lp": lp_,
               "launches": n} for (w, f, nq_, lq_, nd_, lp_), n in
              sorted(cm.launch_shapes.items())]
    return vals, idx, {k: v for k, v in cm.launch_counts().items() if v}, \
        shapes


def same_results(label, one, eng, ref, got):
    """Top-K ids (as docids) and scores of ``got`` equal ``ref``'s bit for
    bit."""
    (v1, i1), (v2, i2) = ref, got
    same_ids = one.ids_for(i1) == eng.ids_for(i2)
    bit = bool(v1.shape == v2.shape and (v1 == v2).all())
    check(same_ids and bit, f"{label}: mesh top-{K} ids equal "
          f"{same_ids}, scores bit-equal {bit} to the one-shard engine")


def merge_share(eng, Q, qm):
    """CUDA-event medians of a mesh top-k and of its shards' scoring
    alone (the rest: the -inf of the padding, the local top-k, the
    gather and the merge): (top-k ms, scores ms, merge share)."""
    from evdr_tpu_torch.parallel.topk import _shard_scores, sharded_topk

    Qd, qmd = eng._queries(Q, qm)
    t_all, _, _ = cuda_ms(lambda: sharded_topk(Qd, qmd, eng.index, K,
                                               eng.impl), 5)
    t_sc, _, _ = cuda_ms(lambda: _shard_scores(Qd, qmd, eng.index,
                                               eng.impl), 5)
    return t_all, t_sc, 1.0 - t_sc / t_all


def mesh_tier(cm, label, wrapper, one, eng, Q, qm, n_launch):
    """A mesh engine against its tier's one-shard engine: the mesh search
    with the counts set to 0 (``wrapper`` launched ``n_launch`` times,
    once a shard), ids and scores bit-equal, q/s of both, the merge's
    share. Returns (report, launches)."""
    ref = one.search_dense(Q, qm, k=K)
    vals, idx, counts, shapes = mesh_search(cm, eng, Q, qm)
    check(counts == {wrapper.__name__: n_launch}, f"{label}: one launch a "
          f"shard of {wrapper.__name__}: {counts}")
    same_results(label, one, eng, ref, (vals, idx))
    rep = {"tier": label, "qps_one_shard": qps(one, Q, qm),
           "qps_mesh": qps(eng, Q, qm)}
    rep["topk_ms"], rep["scores_ms"], rep["merge_share"] = merge_share(
        eng, Q, qm)
    return rep, {"tier": label, "launches": counts[wrapper.__name__],
                 "shapes": shapes}


def mesh_int8(cm, gen, m4, m22):
    """Phase 23 (a), int8: K2 in both modes on a 4-shard mesh and K2 on a
    2 x 2 mesh over INT8_DOCS pages, against the one-shard engines; then
    phase 22's mutations on the 4-shard engine against the one-shard
    merged search."""
    from evdr_tpu_torch import RetrievalEngine
    from evdr_tpu_torch.ops.quantize import quantize_tokens_int8

    plan = inc_plan(INT8_DOCS)
    ids = plan["main_ids"]
    codes, scales, pm = make_int8_pages(INT8_DOCS, gen, quantize_tokens_int8)
    kw = dict(dtype="int8", normalize=False)
    one = RetrievalEngine(**kw).build_from_codes(codes, scales, pm,
                                                 docids=ids)
    ix = one.index
    one_q8 = RetrievalEngine.from_index(
        ix.P, ix.pmask, ix.n_docs, scales=ix.scales, docids=ix.docids,
        quantize_queries=True, **kw)
    e4 = RetrievalEngine(mesh=m4, **kw).build_from_codes(codes, scales, pm,
                                                         docids=ids)
    e4q = RetrievalEngine(mesh=m4, quantize_queries=True,
                          **kw).build_from_codes(codes, scales, pm,
                                                 docids=ids)
    e22 = RetrievalEngine(mesh=m22, **kw).build_from_codes(codes, scales,
                                                           pm, docids=ids)
    del codes, scales, pm
    check(e4.index.n_pad == -(-INT8_DOCS // 256) * 256
          and e22.index.n_pad == -(-INT8_DOCS // 128) * 128,
          "mesh layouts: padded to n_shards x 64")
    Q, qm, _ = planted_queries(lambda t: ix.P[t].float()
                               * ix.scales[t][..., None], INT8_DOCS, gen)
    out = [mesh_tier(cm, "int8", cm.maxsim_cuda_int8, one, e4, Q, qm, 4),
           mesh_tier(cm, "int8+quantize_queries", cm.maxsim_cuda_int8full,
                     one_q8, e4q, Q, qm, 4),
           mesh_tier(cm, "int8 2x2", cm.maxsim_cuda_int8, one, e22, Q, qm,
                     4)]
    del e4q, e22, one_q8
    torch.cuda.empty_cache()
    parts, Pt, pmt = added_pages(gen)
    t = {}
    for label, e in (("one", one), ("mesh", e4)):
        t0 = time.perf_counter()
        for j, (x, m) in enumerate(parts):
            e.add(x, m, docids=plan["add_ids"][j * plan["per"]:
                                              (j + 1) * plan["per"]])
        e.delete(plan["deleted"])
        e.search_dense(Q[:1], qm[:1], k=K)       # the lazy tail build
        t[label] = time.perf_counter() - t0
    check(e4.tail.parts is not None and e4.n_docs == one.n_docs
          == len(plan["live"]), "mesh tail on the shards")
    Qi, qmi = inc_queries(plan, lambda t_: ix.P[t_].float()
                          * ix.scales[t_][..., None], ix.pmask, Pt, pmt, gen)
    ref = one.search_dense(Qi, qmi, k=K)
    vals, idx, counts, _ = mesh_search(cm, e4, Qi, qmi)
    check(counts == {"maxsim_cuda_int8": 8}, f"mesh merged search: the "
          f"main's 4 shards and the tail's 4: {counts}")
    same_results("int8 mutations", one, e4, ref, (vals, idx))
    _, r1 = inc_gates("mesh int8 mutations", e4, plan, vals, idx)
    inc = {"tier": "int8 mutations", "add_delete_first_search_s": t,
           "recall_at_1_live": r1, "qps_one_shard": qps(one, Qi, qmi),
           "qps_mesh": qps(e4, Qi, qmi)}
    del one, e4, ix
    torch.cuda.empty_cache()
    return out, inc


def mesh_pruned(cm, gen, m4):
    """Phase 23 (a), pruned int8 on PRUNE_FULL_DOCS pages: the mesh engine
    over the one-shard engine's codes and summaries; at INC_PRUNE_CANDS
    candidates and at all of them ids and scores bit-equal, each shard
    launching stage 1 (K2) and stage 2 (the rerank kernel) once."""
    from evdr_tpu_torch import RetrievalEngine
    from evdr_tpu_torch.parallel.sharded_index import (build_sharded_index,
                                                       pad_index_dim)

    n = PRUNE_FULL_DOCS
    P, pm = make_pages(n, gen)
    kw = dict(dtype="int8", prune_centroids=PRUNE_K, normalize=False)
    one = RetrievalEngine(**kw).build(P, pm)
    ix, s = one.index, one.summary
    em = RetrievalEngine(mesh=m4, **kw).build_from_codes(
        ix.P[:n], ix.scales[:n], ix.pmask[:n])
    em.summary = pad_index_dim(build_sharded_index(
        s.P[:n], s.pmask[:n], m4, dtype="int8", scales=s.scales[:n]))
    Q, qm, _ = planted_queries(lambda t: P[t], n, gen)
    del P
    rep = {"tier": "int8 pruned", "docs": n}
    for nc in (INC_PRUNE_CANDS, n):
        ref = one.search_dense(Q, qm, k=K, n_candidates=nc)
        vals, idx, counts, _ = mesh_search(cm, em, Q, qm, n_candidates=nc)
        check(counts == {"maxsim_cuda_int8": 4, "rerank_int8_cuda": 4},
              f"pruned: one stage-1 and one stage-2 launch a shard: "
              f"{counts}")
        same_results(f"int8 pruned at {nc}", one, em, ref, (vals, idx))
        rep[f"qps_one_shard_{nc}"] = qps(one, Q, qm, n_candidates=nc)
        rep[f"qps_mesh_{nc}"] = qps(em, Q, qm, n_candidates=nc)
    del one, em
    torch.cuda.empty_cache()
    return rep


def mesh_tiers(cm, gen, m4):
    """Phase 23 (a): int4 (K4) and PQ at M = PQ_M (K3, compact books) over
    INT4_DOCS / PQ_DOCS pages, bf16 (K1) over BF16_DOCS, each on the
    4-shard mesh against its one-shard engine, one tier at a time."""
    from evdr_tpu_torch import RetrievalEngine
    from evdr_tpu_torch.ops.int4 import quantize_tokens_int4

    out = []
    packed, sc, pm = make_int8_pages(INT4_DOCS, gen, quantize_tokens_int4,
                                     rows=(LP + 1) // 2, dtype=torch.uint8)
    kw = dict(dtype="int4", normalize=False)
    one = RetrievalEngine(**kw).build_from_codes4(packed, sc, pm)
    em = RetrievalEngine(mesh=m4, **kw).build_from_codes4(packed, sc, pm)
    del packed, sc, pm
    ix = one.index
    Q, qm, _ = planted_queries(lambda t: cm.unpack_int4_torch(
        ix.P[t], LP).float() * ix.scales[t][..., None], INT4_DOCS, gen)
    out.append(mesh_tier(cm, "int4", cm.maxsim_cuda_int4, one, em, Q, qm,
                         4))
    del one, em, ix
    torch.cuda.empty_cache()

    books = unit(torch.randn((PQ_M, 256, D // PQ_M), device=DEVICE,
                             generator=gen)) / PQ_M ** 0.5
    codes = torch.randint(0, 256, (PQ_DOCS, LP, PQ_M), device=DEVICE,
                          generator=gen, dtype=torch.uint8)
    pm = torch.rand((PQ_DOCS, LP), device=DEVICE, generator=gen) > 0.1
    kw = dict(dtype="pq", pq_m=PQ_M, normalize=False)
    one = RetrievalEngine(**kw).build_from_pq(codes, books, pm)
    em = RetrievalEngine(mesh=m4, **kw).build_from_pq(codes, books, pm)
    del codes, pm
    Q, qm, _ = planted_queries(lambda t: pq_tokens(one.index.P[t], books),
                               PQ_DOCS, gen)
    out.append(mesh_tier(cm, "pq", cm.maxsim_cuda_pq, one, em, Q, qm, 4))
    del one, em
    torch.cuda.empty_cache()

    Pf, pmf = make_pages(BF16_DOCS, gen)
    kw = dict(dtype="bfloat16", normalize=False)
    one = RetrievalEngine(**kw).build(Pf, pmf)
    em = RetrievalEngine(mesh=m4, **kw).build(Pf, pmf)
    Q, qm, _ = planted_queries(lambda t: Pf[t], BF16_DOCS, gen)
    del Pf, pmf
    out.append(mesh_tier(cm, "bfloat16", cm.maxsim_cuda, one, em, Q, qm,
                         4))
    del one, em
    torch.cuda.empty_cache()
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_nccl(one, Q, qm, codes, scales, pm, ids):
    """Phase 23 (c): a one-process NCCL group of 2 shards on the card
    (its candidates and score blocks all-gathered by NCCL): search and
    score_all bit-equal to the one-shard engine. Returns the q/s."""
    import torch.distributed as dist

    from evdr_tpu_torch import RetrievalEngine
    from evdr_tpu_torch.parallel.multihost import (global_doc_mesh,
                                                   init_multihost)

    init_multihost(f"localhost:{free_port()}", 1, 0, "nccl")
    try:
        mesh = global_doc_mesh(2, device=mesh_device())
        check(mesh.backend == "nccl" and mesh.multiprocess, "NCCL mesh")
        en = RetrievalEngine(dtype="int8", mesh=mesh,
                             normalize=False).build_from_codes(
            codes, scales, pm, docids=ids)
        same_results("NCCL group", one, en, one.search_dense(Q, qm, k=K),
                     en.search_dense(Q, qm, k=K))
        check(bool((one.score_all(Q[:16], qm[:16])
                    == en.score_all(Q[:16], qm[:16])).all()),
              "NCCL score_all bit-equal")
        rate = qps(en, Q, qm)
        del en
    finally:
        dist.destroy_process_group()
    return rate


def http_json(url, path, obj=None, timeout=300):
    req = urllib.request.Request(
        url + path, data=None if obj is None else json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def mesh_http(one, Q, qm, gen, work, root):
    """Phase 23 (b): two tools/serve_http --multihost processes on the
    card over gloo, 2 shards each, serving the packed int8 file of
    ``one`` (memory-mapped, each process reading its shards' rows):
    /healthz, /search, /add, /delete, /search, /save, every answer equal
    to ``one`` after the same calls; SIGINT to process 0 stops both."""
    import signal

    from evdr_tpu_torch import RetrievalEngine
    from evdr_tpu_torch.data.packing import preprocess_queries

    path = work / "mesh.npz"
    t0 = time.perf_counter()
    one.save_npz(path)
    t_save = time.perf_counter() - t0
    port, cport = free_port(), free_port()
    logs = [work / f"serve{i}.log" for i in range(2)]
    cmds = [[sys.executable, "-m", "evdr_tpu_torch.tools.serve_http",
             "--index", str(path), "--dtype", "int8", "--device",
             mesh_device(), "--multihost", "--coordinator",
             f"localhost:{cport}", "--num_processes", "2", "--process_id",
             str(i), "--dist_backend", "gloo", "--local_shards", "2",
             "--port", str(port), "--warm", "1", "--save_dir", str(work)]
            for i in range(2)]
    url = f"http://127.0.0.1:{port}"
    n = MESH_HTTP_NQ
    queries = [Q[i][qm[i]].cpu().numpy().tolist() for i in range(n)]
    qobj = np.empty(n, dtype=object)
    qobj[:] = [np.asarray(q, np.float32) for q in queries]
    Qh, qmh = preprocess_queries(qobj, None, length_multiple=8)
    new = unit(torch.randn((4, 256, D), device=DEVICE, generator=gen)
               ).cpu().numpy()
    new_ids = ["new0", "new1", "f10", "new3"]
    dead = ["f3", f"f{MESH_FILE_DOCS - 5}", "new1", "nope"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=open(log, "w"),
                              stderr=subprocess.STDOUT, cwd=str(root))
             for c, log in zip(cmds, logs)]
    deadline = time.monotonic() + MESH_SPAWN_S
    rep = {"save_s": t_save}
    try:
        while True:
            check(all(p.poll() is None for p in procs)
                  and time.monotonic() < deadline, "serve_http --multihost "
                  "up: " + " | ".join(x.read_text()[-2000:] for x in logs))
            try:
                health = http_json(url, "/healthz", timeout=10)
                break
            except OSError:
                time.sleep(0.5)
        rep["ready_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        got = [http_json(url, "/search", {"queries": queries, "k": K})]
        rep["search_s"] = time.perf_counter() - t1
        added = http_json(url, "/add", {"documents": new.tolist(),
                                        "docids": new_ids})
        deleted = http_json(url, "/delete", {"docids": dead})
        got.append(http_json(url, "/search", {"queries": queries, "k": K}))
        saved = http_json(url, "/save", {"path": "mesh_snap.npz"})
        procs[0].send_signal(signal.SIGINT)
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    check(rcs == [0, 0], f"serve_http --multihost exit codes {rcs}: "
          + " | ".join(x.read_text()[-2000:] for x in logs))
    rep["wall_s"] = time.perf_counter() - t0
    nd = one.n_docs
    check(health["mesh"] == {"shards": 4, "processes": 2,
                             "backend": "gloo"} and health["n_docs"] == nd,
          f"/healthz {health}")
    want = [one.search_dense(Qh, qmh, k=K)]
    one.add(new, np.ones(new.shape[:2], bool), docids=new_ids,
            normalize=True)
    one.delete(dead)
    want.append(one.search_dense(Qh, qmh, k=K))
    for reply, (v, i) in zip(got, want):
        check(reply["docids"] == one.ids_for(i) and np.array_equal(
            np.asarray(reply["scores"], np.float32), v),
              "HTTP answers equal the one-process engine's")
    check(added == {"added": 4, "n_docs": nd + 3}
          and deleted == {"deleted": 3, "n_docs": nd}
          and saved["n_docs"] == nd, f"/add {added}, /delete {deleted}, "
          f"/save {saved}")
    back = RetrievalEngine.from_npz(work / "mesh_snap.npz", mmap=True,
                                    dtype="int8")
    v2, i2 = back.search_dense(Qh, qmh, k=K)
    check(back.ids_for(i2) == one.ids_for(want[-1][1])
          and np.array_equal(v2, want[-1][0]), "the saved file reloads "
          "with the same top-K")
    del back
    return rep


def mesh_processes(cm, gen, root):
    """Phase 23 (c) then (b) on one MESH_FILE_DOCS-page int8 corpus."""
    from evdr_tpu_torch import RetrievalEngine
    from evdr_tpu_torch.ops.quantize import quantize_tokens_int8

    work = root / "build" / "chip_smoke_mesh"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        n = MESH_FILE_DOCS
        codes, scales, pm = make_int8_pages(n, gen, quantize_tokens_int8)
        ids = [f"f{i}" for i in range(n)]
        one = RetrievalEngine(dtype="int8", normalize=False
                              ).build_from_codes(codes, scales, pm,
                                                 docids=ids)
        ix = one.index
        Q, qm, _ = planted_queries(lambda t: ix.P[t].float()
                                   * ix.scales[t][..., None], n, gen)
        t0 = time.perf_counter()
        rep = {"nccl_qps": mesh_nccl(one, Q, qm, codes, scales, pm, ids),
               "nccl_s": time.perf_counter() - t0,
               "one_process_qps": qps(one, Q, qm)}
        del codes, scales, pm
        torch.cuda.empty_cache()
        rep["http"] = mesh_http(one, Q, qm, gen, work, root)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return rep


def mesh_phase(cm, gen, smi, root):
    """Phase 23: multi-device serving. Returns the reports and the mesh
    searches' launches by kernels-line entry."""
    from evdr_tpu_torch.parallel.mesh import mesh_of

    t0 = time.perf_counter()
    dev = mesh_device()
    m4 = mesh_of([dev] * MESH_SHARDS)
    m22 = mesh_of([dev] * MESH_SHARDS, dp=2)
    tiers, inc = mesh_int8(cm, gen, m4, m22)
    pruned = mesh_pruned(cm, gen, m4)
    tiers += mesh_tiers(cm, gen, m4)
    t_a = time.perf_counter() - t0
    procs = mesh_processes(cm, gen, root)
    for rep, launches in tiers:
        log(f"phase 23 {rep['tier']} on {MESH_SHARDS} shards of {dev}: "
            f"{rep['qps_mesh']:.1f} q/s against {rep['qps_one_shard']:.1f} "
            f"on one shard; mesh top-k {rep['topk_ms']:.3f} ms, of it the "
            f"shards' scores {rep['scores_ms']:.3f} ms (merge share "
            f"{rep['merge_share']:.1%}); ids and scores bit-equal; "
            f"launches {launches['launches']}; {smi}")
    log(f"phase 23 int8 mutations (phase 22's plan on the 4-shard mesh): "
        f"{inc}; bit-equal to the one-shard merged search; {smi}")
    log(f"phase 23 pruned: {pruned}; bit-equal; {smi}")
    log(f"phase 23 processes: NCCL group of 1 process x 2 shards "
        f"{procs['nccl_qps']:.1f} q/s ({procs['one_process_qps']:.1f} "
        f"one shard); serve_http --multihost (2 gloo processes x 2 shards, "
        f"{MESH_FILE_DOCS} pages): {procs['http']}; {smi}")
    by_entry = {"int8": "maxsim_int8", "int8 2x2": "maxsim_int8",
                "int8+quantize_queries": "maxsim_int8full",
                "int4": "maxsim_int4", "pq": "maxsim_pq",
                "bfloat16": "maxsim_bf16"}
    launches = {}
    for rep, ln in tiers:
        launches.setdefault(by_entry[rep["tier"]], []).append(ln)
    reports = [rep for rep, _ in tiers] + [inc, pruned, procs]
    log(f"phase 23: {time.perf_counter() - t0:.1f} s ((a) {t_a:.1f} s)")
    return reports, launches


# ------------------------------------------- multi-GPU training (phase 24)


def mesh_train_cfg(kw, name, steps, eval_every, shards=MESH_SHARDS, **over):
    """Phase 8's flags on a mesh of ``shards`` with --score_impl auto."""
    from evdr_tpu_torch.train.config import TrainConfig

    return TrainConfig(**dict(kw, name=name, score_impl="auto",
                              eval_impl="auto", max_steps=steps,
                              eval_every=eval_every, mesh_docs=shards,
                              **over))


def run_lines(cfg, key=None):
    """{(step, key): value} of a run's train.log: train and eval losses and
    metrics."""
    d = Path(cfg.out_root) / cfg.name / f"mf{MF}" / (key or FIXTURE_KEY)
    keys = ("train/total loss", "eval/eval loss", "eval/NDCG@5",
            "eval/Recall@1")
    return {(r["step"], k): r[k] for r in eval_lines(d / "train.log")
            for k in keys if k in r}


def series_drift(ref, got):
    """The largest difference of two runs' common log values: relative for
    losses, absolute for the metrics, and which (step, key) it is at."""
    out = {"loss_rel": 0.0, "metric_abs": 0.0}
    for key in sorted(set(ref) & set(got)):
        a, b = ref[key], got[key]
        if "loss" in key[1]:
            d, slot = abs(b - a) / max(abs(a), 1e-12), "loss_rel"
        else:
            d, slot = abs(b - a), "metric_abs"
        if d >= out[slot]:
            out[slot], out[slot + "_at"] = d, list(key)
    return out


def mesh_first_step(cm, bundle, kw, mesh, label, **over):
    """One step from the init on one device and on ``mesh`` (the same batch
    and seed; both on their precomputed teacher tables, K1 float32 by
    --score_impl auto): the loss, the updated rows, the tables. Returns
    the report and both steps (their next steps are traced).
    """
    from evdr_tpu_torch.train.harness import (MeshStudent,
                                              _precompute_teacher_scores,
                                              build_train_step,
                                              index_stream, init_student,
                                              make_optimizer)
    from evdr_tpu_torch.utils.prng import PRNGSequence

    cfg = mesh_train_cfg(kw, label, 1, 1, shards=mesh.size, **over)
    one_cfg = dataclasses.replace(cfg, mesh_docs=0)
    param0, pm_s, _ = init_student(cfg, FIXTURE_KEY, bundle, MF)
    bundle.sc_t_train = _precompute_teacher_scores(
        bundle.Q_train, bundle.qmask_train, bundle.P_teacher_norm,
        bundle.pmask_teacher, chunk_q=256, chunk_p=cfg.chunk_p,
        impl=cfg.score_impl)
    p1 = param0.clone().requires_grad_(True)
    step1 = build_train_step(one_cfg, bundle, pm_s,
                             make_optimizer(one_cfg, p1))
    ms = MeshStudent(cfg, bundle, mesh, param0, pm_s)
    step2 = ms.build_step(cfg, make_optimizer(cfg, ms.params))
    stream = index_stream(int(bundle.Q_train.shape[0]), STEP_NQ, cfg.seed)
    seeds = PRNGSequence(cfg.seed)
    idx, seed = next(stream), seeds.next()
    l1 = float(step1(idx, seed)["total_loss"])
    l2 = float(step2(idx, seed)["total_loss"])
    n = bundle.n_docs
    full = torch.cat([p.detach() for p in ms.params])[:n]
    table = torch.cat(ms.sct_train, dim=1)[:, :n]
    rep = {"loss_one": l1, "loss_mesh": l2,
           "loss_rel": abs(l2 - l1) / abs(l1),
           "param_max_abs": float((full - p1.detach()).abs().max()),
           "table_max_abs": float((table - bundle.sc_t_train).abs().max())}
    bundle.sc_t_train = None
    check(rep["loss_rel"] <= 1e-5 and rep["param_max_abs"] <= 2e-5,
          f"phase 24 {label}: the first mesh step equals the one-device "
          f"step (loss rtol 1e-5, rows atol 2e-5): {rep}")
    check(rep["table_max_abs"] <= 1e-5, f"phase 24 {label}: the sharded "
          f"teacher table equals the one-device table: {rep}")
    return rep, step1, step2


def mesh_trace(step, stream, seeds, work, label):
    """MESH_TRACE_STEPS steps inside utils.timing.trace_ctx: from the Chrome
    trace, the kernels' count, their busy share of the traced window (the
    union of their intervals over the window's span) and the five kernels
    of most time; device_memory_report()'s peak."""
    from evdr_tpu_torch.utils.timing import device_memory_report, trace_ctx

    tdir = work / f"trace_{label}"
    with trace_ctx(tdir):
        for _ in range(MESH_TRACE_STEPS):
            step(next(stream), seeds.next())
        torch.cuda.synchronize()
    events = json.loads((tdir / "trace.json").read_text())["traceEvents"]
    check(len(events) > 0, f"trace_ctx wrote a trace of the {label} steps")
    timed = [e for e in events if "ts" in e and "dur" in e]
    kern = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e.get("name", "")) for e in timed
                  if e.get("cat") == "kernel")
    busy, end = 0.0, None
    for a, b, _ in kern:
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    span = (max(float(e["ts"]) + float(e["dur"]) for e in timed)
            - min(float(e["ts"]) for e in timed)) if timed else 0.0
    by_name = Counter()
    for a, b, name in kern:
        by_name[name[:60]] += b - a
    mem = device_memory_report()
    return {"steps": MESH_TRACE_STEPS, "kernel_events": len(kern),
            "window_ms": span / 1e3, "kernel_busy_ms": busy / 1e3,
            "busy_share": busy / span if span else None,
            "top_kernels_ms": {k: v / 1e3 for k, v in
                               by_name.most_common(5)},
            "peak_bytes": max(v["peak_bytes_in_use"] for v in mem.values())
            if mem else None}


def mesh_batches(kw):
    """The index stream and seeds the traced steps draw from (the run's)."""
    from evdr_tpu_torch.train.harness import index_stream
    from evdr_tpu_torch.utils.prng import PRNGSequence

    return (index_stream(TRAIN_Q, STEP_NQ, kw["seed"]),
            PRNGSequence(kw["seed"]))


def mesh_train_run(cm, cfg, mesh):
    """run_training on ``mesh`` with the launch counts set to 0 just before
    it: (wall s, counts, K1 float32 launches by shape, log lines)."""
    from evdr_tpu_torch.train.harness import run_training

    cm.reset_launch_counts()
    t0 = time.perf_counter()
    run_training(cfg, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in cm.launch_counts().items() if v}
    return wall, counts, launch_shapes(cm, "maxsim_cuda_f32"), run_lines(cfg)


def log_rates(cfg):
    """steps/s between log lines with no eval between them, and the median
    eval ms/query, from a run's train.log."""
    d = Path(cfg.out_root) / cfg.name / f"mf{MF}" / FIXTURE_KEY
    rows = eval_lines(d / "train.log")
    t = {r["step"]: r["time_sec"] for r in rows if "train/total loss" in r}
    ev = [r["eval/latency"] for r in rows if "eval/NDCG@5" in r]
    hi = min(cfg.eval_every, cfg.max_steps)
    return (hi - 20) / (t[hi] - t[20]), statistics.median(ev)


def mesh_processes_train(kw, work, root):
    """Phase 24 (c): two ``evdr_tpu_torch.train.cli`` processes on the one
    card over gloo, 2 shards each (--mesh_docs 4 --local_shards 2),
    MESH_PROC_STEPS steps. The CLI finds the fixture through the built-in
    key 'shift' (links named shiftproject_test_* to phase 8's files); the
    follower gets its own --out_root, which must stay unwritten. Returns
    (process 0's config, wall s)."""
    data = Path(kw["query_root"])
    stem = f"{FIXTURE_KEY}_test"
    for rel in ("{}_dump_all.npz", "{}_query.npz",
                f"S3E_init/mf{MF}/{{}}.npz"):
        link = data / rel.format("shiftproject_test")
        if not link.exists():
            link.symlink_to(Path(rel.format(stem)).name)
    port = free_port()
    logs = [work / f"train{i}.log" for i in range(2)]
    outs = [work / f"procs{i}" for i in range(2)]
    cmds = [[sys.executable, "-m", "evdr_tpu_torch.train.cli",
             "--datasets", "shift", "--query_root", str(data),
             "--teacher_root", str(data), "--init_root", kw["init_root"],
             "--mfs", str(MF), "--out_root", str(outs[i]), "--name", "procs",
             "--seed", str(kw["seed"]), "--score_impl", "auto",
             "--eval_impl", "auto", "--max_steps", str(MESH_PROC_STEPS),
             "--eval_every", str(EVAL_EVERY), "--mesh_docs",
             str(MESH_SHARDS), "--local_shards", str(MESH_SHARDS // 2),
             "--coordinator", f"localhost:{port}", "--num_processes", "2",
             "--process_id", str(i), "--dist_backend", "gloo", "--device",
             mesh_device()] for i in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=open(log, "w"),
                              stderr=subprocess.STDOUT, cwd=str(root))
             for c, log in zip(cmds, logs)]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, MESH_SPAWN_S - (time.perf_counter()
                                                     - t0)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    check(rcs == [0, 0], f"two training CLI processes exit codes {rcs}: "
          + " | ".join(x.read_text()[-2000:] for x in logs))
    check(not outs[1].exists(), "the follower process wrote nothing")
    cfg = mesh_train_cfg(dict(kw, out_root=str(outs[0])), "procs",
                         MESH_PROC_STEPS, EVAL_EVERY)
    return cfg, time.perf_counter() - t0


def mesh_train_nccl(kw):
    """Phase 24 (d): a one-process NCCL group of 2 shards trains
    MESH_NCCL_STEPS steps; the same run on mesh_of([card] * 2) is the
    reference. Returns (both log series, NCCL run s)."""
    import torch.distributed as dist

    from evdr_tpu_torch.parallel.mesh import mesh_of
    from evdr_tpu_torch.parallel.multihost import (global_doc_mesh,
                                                   init_multihost)
    from evdr_tpu_torch.train.harness import run_training

    cfgs = [mesh_train_cfg(kw, name, MESH_NCCL_STEPS, MESH_NCCL_STEPS,
                           shards=2) for name in ("nccl", "nccl_ref")]
    t0 = time.perf_counter()
    init_multihost(f"localhost:{free_port()}", 1, 0, "nccl")
    try:
        mesh = global_doc_mesh(2, device=mesh_device())
        check(mesh.backend == "nccl" and mesh.multiprocess, "NCCL mesh")
        run_training(cfgs[0], mesh=mesh)
    finally:
        dist.destroy_process_group()
    wall = time.perf_counter() - t0
    run_training(cfgs[1], mesh=mesh_of([mesh_device()] * 2))
    return run_lines(cfgs[0]), run_lines(cfgs[1]), wall


def qat_artifact_serves(cm, cfg, bundle):
    """The hardtoken + QAT int4 run's artifact through
    RetrievalEngine.from_npz(dtype='int4'): its best npz where an eval
    improved on step 0, else the export at its last step (``save_period``;
    the int4 engine quantizes it exactly as the QAT step's STE did).
    search_dense's rank 1 equals K4's plain version on the engine's index
    but for near-ties."""
    from evdr_tpu_torch import RetrievalEngine

    d = Path(cfg.out_root) / cfg.name / f"mf{MF}" / FIXTURE_KEY
    path = d / "best_ndcg5.npz"
    if not path.exists():
        path = d / f"compressed_ep{cfg.max_steps}.npz"
    eng = RetrievalEngine.from_npz(path, dtype="int4", device=DEVICE)
    Q, qm = bundle.Q_test[:NQ], bundle.qmask_test[:NQ]
    vals, idx = eng.search_dense(Q, qm, k=K)
    ix = eng.index
    plain = cm.maxsim_int4_plain(Q, ix.P, ix.scales, qm,
                                 ix.pmask)[:, :ix.n_docs]
    rows = torch.arange(Q.shape[0], device=plain.device)
    top1 = torch.as_tensor(np.asarray(idx[:, 0]), device=plain.device)
    gap = float((plain[rows, plain.argmax(dim=1)] - plain[rows, top1]).max())
    check(np.isfinite(vals).all() and gap < 1e-4, f"the QAT int4 artifact "
          f"serves: rank 1 against K4's plain version, gap {gap}")
    return {"file": path.name, "n_docs": eng.n_docs, "rank1_gap": gap}


def mesh_train_phase(cm, bundle, kw, phase8, smi, work, root):
    """Phase 24: multi-GPU training on a mesh of the card. Returns the
    report and (a)'s K1 float32 launches for the kernels line."""
    from evdr_tpu_torch.parallel.mesh import mesh_of

    t_start = time.perf_counter()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()  # the trace's peak is phase 24's
    m4 = mesh_of([mesh_device()] * MESH_SHARDS)
    rep = {}
    # (a) the first step against one device, a traced few, then the run
    rep["first_step"], step1, step = mesh_first_step(cm, bundle, kw, m4,
                                                     "a")
    # the same batches traced on one device and on the mesh
    rep["trace_one"] = mesh_trace(step1, *mesh_batches(kw), work, "one")
    rep["trace"] = mesh_trace(step, *mesh_batches(kw), work, "mesh")
    del step, step1
    torch.cuda.empty_cache()
    cfg_a = mesh_train_cfg(kw, "mesh", TRAIN_STEPS, EVAL_EVERY)
    wall, counts_a, shapes, lines_a = mesh_train_run(cm, cfg_a, m4)
    rows = -(-TRAIN_DOCS // MESH_SHARDS)
    n_evals = TRAIN_STEPS // EVAL_EVERY + 1
    want = MESH_SHARDS * (-(-TRAIN_Q // 256) + -(-TEST_Q // 256) + n_evals)
    check(counts_a == {"maxsim_cuda_f32": want}
          and all(x["nd"] == rows for x in shapes),
          f"phase 24 (a): K1 float32 launched on every shard (teacher "
          f"tables and evals, {want} launches of {rows} pages): {counts_a}, "
          f"{shapes}")
    drift_a = series_drift(phase8["lines"], lines_a)
    steps_s, eval_ms = log_rates(cfg_a)
    rep["a"] = {"wall_s": wall, "launches": counts_a, "steps_s": steps_s,
                "eval_ms_per_query": eval_ms, "phase8_steps_s":
                phase8["steps_s"], "phase8_eval_ms": phase8["eval_ms"],
                "drift_vs_phase8": drift_a}
    step0 = [(0, k) for k in ("eval/NDCG@5", "eval/Recall@1")]
    check(all(lines_a[k] == phase8["lines"][k] for k in step0),
          "phase 24 (a): the step-0 metrics equal phase 8's")
    check(drift_a["loss_rel"] <= MESH_LOSS_RTOL
          and drift_a["metric_abs"] <= MESH_METRIC_ATOL,
          f"phase 24 (a): the eval and train series match phase 8's "
          f"(losses rtol {MESH_LOSS_RTOL}, metrics atol "
          f"{MESH_METRIC_ATOL}): {drift_a}")
    t_a = time.perf_counter() - t_start
    log(f"phase 24 (a) {MESH_SHARDS} shards of {mesh_device()}, "
        f"{TRAIN_STEPS} steps: first step {rep['first_step']}; traced "
        f"steps on the mesh {rep['trace']}, on one device "
        f"{rep['trace_one']}; {steps_s:.1f} steps/s (phase 8: "
        f"{phase8['steps_s']:.1f}), eval {eval_ms:.4f} ms/query (phase 8: "
        f"{phase8['eval_ms']:.4f}); drift against phase 8 {drift_a}; "
        f"launches {counts_a}; run {wall:.1f} s, (a) {t_a:.1f} s; {smi}")

    # (b) hardtoken + QAT int4 and mixup on the 4-shard mesh
    t0 = time.perf_counter()
    rep["b_first_step"], *_ = mesh_first_step(
        cm, bundle, kw, m4, "b", aug="hardtoken", qat="int4")
    torch.cuda.empty_cache()
    rep["b"] = {}
    for name, over in (("hardtoken_int4", dict(
            aug="hardtoken", qat="int4", save_period=MESH_TRAIN_STEPS_AUG)),
                       ("mixup", dict(aug="mixup"))):
        cfg = mesh_train_cfg(kw, f"mesh_{name}", MESH_TRAIN_STEPS_AUG,
                             MESH_TRAIN_STEPS_AUG, **over)
        wall, counts, _, lines = mesh_train_run(cm, cfg, m4)
        vals = list(lines.values())
        check(len(vals) >= 4 and all(np.isfinite(v) for v in vals),
              f"phase 24 (b) {name}: finite losses and metrics")
        rep["b"][name] = {"wall_s": wall, "launches": counts,
                          "last": {f"{k[1]}@{k[0]}": v for k, v in
                                   lines.items()
                                   if k[0] == MESH_TRAIN_STEPS_AUG}}
        if name == "hardtoken_int4":
            rep["b"][name]["artifact"] = qat_artifact_serves(cm, cfg, bundle)
    t_b = time.perf_counter() - t0
    torch.cuda.empty_cache()
    log(f"phase 24 (b): first step {rep['b_first_step']}; runs {rep['b']}; "
        f"{t_b:.1f} s")

    # (c) two processes on the one card over gloo
    cfg_c, t_c = mesh_processes_train(kw, work, root)
    lines_c = run_lines(cfg_c, "shift")
    early = {k: v for k, v in lines_a.items() if k[0] <= MESH_PROC_STEPS}
    common = set(early) & set(lines_c)
    drift_c = series_drift(early, lines_c)
    check(len(common) >= 4 and drift_c["loss_rel"] <= MESH_LOSS_RTOL
          and drift_c["metric_abs"] <= MESH_METRIC_ATOL,
          f"phase 24 (c): process 0's train.log equals (a)'s first "
          f"{MESH_PROC_STEPS} steps ({sorted(common)}): {drift_c}")
    rep["c"] = {"wall_s": t_c, "compared": len(common), "drift": drift_c}
    log(f"phase 24 (c) two CLI processes (gloo, 2 shards each): "
        f"{rep['c']}")

    # (d) NCCL in one process
    if torch.cuda.is_available():
        nccl, ref, t_d = mesh_train_nccl(kw)
        drift_d = series_drift(ref, nccl)
        check(set(nccl) == set(ref) and drift_d["loss_rel"] <= MESH_LOSS_RTOL
              and drift_d["metric_abs"] <= MESH_METRIC_ATOL,
              f"phase 24 (d): the NCCL group's run equals the one-process "
              f"mesh's: {drift_d}")
        rep["d"] = {"wall_s": t_d, "bit_equal": nccl == ref,
                    "drift": drift_d}
        log(f"phase 24 (d) NCCL group of 1 process x 2 shards: {rep['d']}")
    rep["times_s"] = {"a": t_a, "b": t_b, "c": t_c,
                      "all": time.perf_counter() - t_start}
    log(f"phase 24: {rep['times_s']['all']:.1f} s ((a) {t_a:.1f}, (b) "
        f"{t_b:.1f}, (c) {t_c:.1f} s)")
    n = counts_a["maxsim_cuda_f32"]
    return rep, {"launches": n, "shards": MESH_SHARDS,
                 "per_shard": n // MESH_SHARDS, "shapes": shapes}


# ------------------------------------------------- training, the rest (18)


def qat_run(cm, work, seed, name, flags):
    """One phase-18 trainer run through the CLI on phase 8's fixture.
    Returns (its output directory, the log's eval lines, steps/s before and
    after step EVAL_EVERY, the median eval ms/query, CLI wall seconds)."""
    from evdr_tpu_torch.train import cli

    data = work / "data"
    argv = ["--datasets", FIXTURE_KEY, "--query_root", str(data),
            "--teacher_root", str(data), "--init_root",
            str(data / "S3E_init"), "--mfs", str(MF), "--out_root",
            str(work / "results"), "--name", name, "--seed", str(seed),
            "--score_impl", "pallas", "--eval_impl", "auto", "--max_steps",
            str(TRAIN_STEPS), "--eval_every", str(EVAL_EVERY), *flags]
    if DEVICE != "cuda":
        argv += ["--device", DEVICE]
    cm.reset_launch_counts()
    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out_dir = work / "results" / name / f"mf{MF}" / FIXTURE_KEY
    log_path = out_dir / "train.log"
    rows = eval_lines(log_path)
    evals = [r for r in rows if "eval/NDCG@5" in r]
    t = {r["step"]: r["time_sec"] for r in rows if "train/total loss" in r}
    # steps/s between log lines with no eval between them: before the
    # eval at EVAL_EVERY and after it
    rates = ((EVAL_EVERY - 20) / (t[EVAL_EVERY] - t[20]),
             (TRAIN_STEPS - EVAL_EVERY - 20)
             / (t[TRAIN_STEPS] - t[EVAL_EVERY + 20]))
    eval_ms = statistics.median(r["eval/latency"] for r in evals)
    last = log_path.read_text().rstrip().splitlines()[-1]
    check(re.search(r"\{.*\"summary/best_ndcg5\".*\}\s*$", last) is not None,
          f"{name}: train.log ends with the summary/best_ndcg5 line")
    nd0, nd_end = evals[0]["eval/NDCG@5"], evals[-1]["eval/NDCG@5"]
    log(f"phase 18 run {name} ({' '.join(flags)}): {TRAIN_STEPS} steps in "
        f"{wall:.1f} s of CLI wall time; eval NDCG@5 step 0 {nd0:.5f} -> "
        f"step {evals[-1]['step']} {nd_end:.5f}; {rates[0]:.1f} steps/s "
        f"(steps 20-{EVAL_EVERY}), {rates[1]:.1f} steps/s (steps "
        f"{EVAL_EVERY + 20}-{TRAIN_STEPS}), eval {eval_ms:.4f} ms/query "
        f"(median of {len(evals)}); launches {cm.launch_counts()}")
    check(nd_end > nd0, f"{name}: NDCG@5 rose from step 0 ({nd0} -> "
                        f"{nd_end})")
    return out_dir


def rest_of_training(cm, work, seed, bundle):
    """Phase 18: (a) hardtoken + QAT int4, (b) mixup + QAT pq switched on at
    half the steps, through the CLI; (b)'s best npz serves its codebooks
    through RetrievalEngine.from_npz."""
    from evdr_tpu_torch import RetrievalEngine
    from evdr_tpu_torch.data.npz_io import load_payload
    from evdr_tpu_torch.data.packing import l2_normalize, preprocess_docs
    from evdr_tpu_torch.ops.pq import decode_pq, encode_with_books

    t0 = time.perf_counter()
    log("phase 18: QAT opq is not run on the card: each refit is a host "
        "train_opq of ~62 s (PERF.md §5); its branch differs from pq only in "
        "_fit_qat_books and qdq_pq's expanded books, both held against the "
        "JAX package on the CPU (tests/test_torch_qat.py, "
        "tests/test_torch_train_qat.py)")
    qat_run(cm, work, seed, "hardtoken_int4",
            ["--aug", "hardtoken", "--qat", "int4"])
    out_dir = qat_run(cm, work, seed, "mixup_pq",
                      ["--aug", "mixup", "--qat", "pq", "--qat_start_frac",
                       "0.5"])
    path = out_dir / "best_ndcg5.npz"
    payload = load_payload(path)
    check(payload.get("qat_books") is not None,
          "mixup_pq: best_ndcg5.npz carries qat_books")
    books = np.asarray(payload["qat_books"], np.float32)
    eng = RetrievalEngine.from_npz(path, dtype="pq")
    check(np.array_equal(eng.index.books.cpu().numpy(), books)
          and not eng.index.books_expanded, "from_npz serves the qat_books")
    Q, qm = bundle.Q_test, bundle.qmask_test
    _, idx = eng.search_dense(Q, qm, k=K)
    top1 = torch.from_numpy(idx[:, 0]).to(DEVICE)
    rows = torch.arange(Q.shape[0], device=DEVICE)
    # the serving path's own numerics: K3's plain version on the engine's
    # index (books quantized to int8 with one global scale, bf16 queries)
    ix = eng.index
    plain = cm.maxsim_pq_plain(Q, ix.P, qm, ix.pmask, ix.books)[:, :ix.n_docs]
    gap_plain = plain[rows, plain.argmax(dim=1)] - plain[rows, top1]
    same_plain = float((gap_plain == 0).float().mean())
    # ... and the f32 scoring of the exported reconstruction (f32 books)
    P, pm, _ = preprocess_docs(payload["documents"],
                               payload.get("doc_attnmask"),
                               payload.get("doc_imgmask"))
    Pn = l2_normalize(P * pm[..., None].astype(np.float32))
    codes = encode_with_books(Pn, books, pm)
    rec = decode_pq(codes, books)
    served = ix.P[:codes.shape[0], :codes.shape[1]].cpu().numpy()
    check(np.array_equal(served, codes), "the engine serves the codes of the "
                                         "exported reconstruction")
    f32 = cm.maxsim_plain(Q, torch.from_numpy(rec).to(DEVICE), qm,
                          torch.from_numpy(pm).to(DEVICE),
                          compute=torch.float32)
    gap = f32[rows, f32.argmax(dim=1)] - f32[rows, top1]
    same = float((gap == 0).float().mean())
    # where the two picks differ, their f32 scores must lie within what K3's
    # rounding can move a score: the books to int8 (one global scale s, so
    # each decoded dim moves <= s/2) and the queries to bf16; summed over a
    # query's valid tokens, twice (both picks move)
    s_books = float(np.abs(books).max()) / 127.0
    r_max = float(np.linalg.norm(rec, axis=-1).max())
    Qb = Q.to(torch.bfloat16).float()
    bound_q = ((Qb.abs().sum(-1) * (s_books / 2)
                + (Q - Qb).norm(dim=-1) * r_max) * qm).sum(1)
    slack = float((gap - 2 * bound_q).max())
    log(f"phase 18 mixup_pq artifact: qat_books {books.shape} served by "
        f"from_npz(dtype='pq') with the exported reconstruction's codes; "
        f"search_dense rank 1 equals K3's plain "
        f"version for {same_plain:.4f} of {Q.shape[0]} test queries (the rest"
        f" within {float(gap_plain.max()):.2e}, tol 1e-4), and the f32 "
        f"scoring of the exported reconstruction for {same:.4f}; the others "
        f"are near-ties: f32 gap up to {float(gap.max()):.2e}, each within "
        f"the int8-book and bf16 rounding bound (largest gap - bound "
        f"{slack:.2e}, tol 1e-4); phase 18 {time.perf_counter() - t0:.1f} s")
    check(float(gap_plain.max()) < 1e-4,
          "pq engine rank 1 equals K3's plain version but for near-ties")
    check(slack <= 1e-4, "pq engine rank 1 against the f32 scoring of the "
                         "reconstruction, but for near-ties")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

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
            if "Used " in ln and " registers" in ln]
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
    parity = {kname: (parity_case(3, kname, "serving shape", kern, plain,
                                  kargs, tol, 7), tol)
              for kname, (kern, plain, kargs, tol) in parity_cases.items()}
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
        e2e[label] = check_engine(4, label, eng, Q, qm, tgt, plain, tol)

    # 5. entry point: the HTTP server over the bf16 engine
    check_http(5, eng_bf, Qb, qmb)
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
    design = dict(cm.bf16_config(D), registers=ptxas_registers(
        _cuda_build, "maxsim_bf16", "Lb0E"))
    log(f"phase 6 K1 bf16 design at D = {D}: {design} (wgmma m64n"
        f"{design['tile_tokens']}k16 from TMA-loaded shared memory, one "
        f"producer warp; registers per instantiation, before setmaxnreg)")
    wg_design = dict(cm.int8full_wg_config(D), registers=ptxas_registers(
        _cuda_build, "maxsim_int8", "maxsim_int8full_wg"))
    log(f"phase 6 K2 int8full design at D = {D}, Lp {LP}: "
        f"{cm.int8full_func(LP, D)} {wg_design} (wgmma m64n"
        f"{wg_design['tile_tokens']}k32 s8 from TMA-loaded shared memory)")
    for kname, kern, plain, kargs, peak, src, repl, wrapper in timed:
        ms, lo, hi = cuda_ms(lambda: kern(*kargs), 7)
        plain_ms, _, _ = cuda_ms(lambda: plain(*kargs), 3)
        qmask, pmask = kargs[-2], kargs[-1]
        out_bytes = kargs[0].shape[0] * pmask.shape[0] * 4
        bms, by = bound(tensor_bytes(*kargs) + out_bytes,
                        valid_ops(qmask, pmask), peak)
        if kname in ("maxsim_bf16", "maxsim_int8full"):
            ceiling = "it issues wgmma, so no mma.sync ceiling"
        else:
            mma_ms = valid_ops(qmask, pmask) / MMA_SYNC_OPS[peak] * 1e3
            ceiling = (f"the mma.sync ceiling {mma_ms:.3f} ms, "
                       f"{mma_ms / ms:.1%}")
        nd = pmask.shape[0]
        log(f"phase 6 time {kname}: {ms:.3f} ms median of 7 (spread "
            f"{lo:.3f}-{hi:.3f}) at {NQ}x{LQ} queries x {nd}x{LP} pages; "
            f"bound {bms:.3f} ms by {by} ({bms / ms:.1%} of the time; "
            f"{ceiling}); plain {plain_ms:.3f} ms (median of 3); library: "
            f"none; {smi}")
        err, tol = parity[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": repl,
            "launches": counts[wrapper.__name__], "max_abs_err": err,
            "tol": tol, "ms": ms, "ms_min": lo, "ms_max": hi,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None})
        if kname == "maxsim_bf16":
            kernels[-1]["design"] = design
        if kname == "maxsim_int8full":
            # the wgmma kernel beside the mma.sync loop it replaced at Lp
            # >= 64, on the same operands
            mma_ms, mlo, mhi = cuda_ms(lambda: int8full_mma(cm, *kargs), 7)
            check(torch.equal(kern(*kargs), int8full_mma(cm, *kargs)),
                  "K2 int8full's wgmma kernel equals the mma.sync loop bit "
                  "for bit")
            log(f"phase 6 time maxsim_int8full mma.sync loop: {mma_ms:.3f} "
                f"ms median of 7 (spread {mlo:.3f}-{mhi:.3f}), the wgmma "
                f"kernel {ms:.3f} ms ({mma_ms / ms:.2f}x), scores bit-equal")
            kernels[-1].update(design=wg_design, mma_sync_ms=mma_ms)
    log("phase 6 search_dense end to end: " + ", ".join(
        f"{k} {v:.1f} q/s" for k, v in e2e.items()))
    del eng_q8, eng_i8, eng_bf, idx8, bfx, i8, bf, Q8, Qb, timed, kargs
    torch.cuda.empty_cache()

    # 7-10. training; its fixture stays on disk for phases 18 and 24
    work = Path(root) / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        train_kernels, bundle, phase8 = training_phases(cm, ct, gen,
                                                        args.seed, smi, work)
        kernels += train_kernels
        torch.cuda.empty_cache()

        # 11-15. the capacity tiers
        kernels += tier_phases(cm, gen, args.seed, smi, Path(root))
        torch.cuda.empty_cache()

        # 16-17. K5/K6 in float32 mode, K2b
        t0 = time.perf_counter()
        kernels += f32_train_phase(cm, ct, gen, smi)
        k6_widths_and_ties(ct, gen)
        torch.cuda.empty_cache()
        kernels += defer_phase(cm, gen, smi)
        torch.cuda.empty_cache()
        log(f"phases 16-17: {time.perf_counter() - t0:.1f} s")

        # 18. the rest of training
        rest_of_training(cm, work, args.seed, bundle)
        torch.cuda.empty_cache()

        # 19. every query length and width
        shapes_phase(cm, gen)
        torch.cuda.empty_cache()

        # 20. every token width: the wide functions
        kernels += wide_phase(cm, ct, gen, smi)
        torch.cuda.empty_cache()

        # 21. pruned two-stage search; stage 1's launches at Lp = PRUNE_K join
        # the entries of the kernels it ran; stage 2's kernel is an entry of
        # its own, with the int8 engines' launches
        reports, stage1 = pruned_phase(gen, smi, Path(root))
        rerank = next(r.pop("rerank_kernel") for r in reports
                      if "rerank_kernel" in r)
        rerank["launches"] = sum(r["stage2_launches"] for r in reports)
        kernels.append(rerank)
        log("phase 21 report: " + json.dumps(reports))
        by_name = {"maxsim_cuda": "maxsim_bf16", "maxsim_cuda_int8":
                   "maxsim_int8", "maxsim_cuda_int8full": "maxsim_int8full",
                   "maxsim_cuda_int4": "maxsim_int4"}
        for (wrapper, func), shapes in stage1.items():
            entry = next(k for k in kernels if k["name"] == by_name[wrapper])
            entry.setdefault("pruned_stage1_launches", []).extend(
                dict(x, func=func) for x in shapes)
        check(set(stage1) == {("maxsim_cuda", "evdr_maxsim_bf16"),
                              ("maxsim_cuda_int8", "evdr_maxsim_int8"),
                              ("maxsim_cuda_int8full", "evdr_maxsim_int8full"),
                              ("maxsim_cuda_int4", "evdr_maxsim_int4")},
              f"stage 1 ran K1, K2 (both modes) and K4 at Lp {PRUNE_K}: "
              f"{sorted(stage1)}")
        torch.cuda.empty_cache()

        # 22. incremental serving; the merged searches' launches join the
        # entries of the kernels they ran
        reports, inc_launches = incremental_phase(cm, gen, args.seed, smi,
                                                  Path(root))
        log("phase 22 report: " + json.dumps(reports))
        for kname, shapes in inc_launches.items():
            entry = next(k for k in kernels if k["name"] == kname)
            entry["incremental_launches"] = shapes
            check(sum(x["launches"] for x in shapes) >= 2,
                  f"{kname} ran on the merged main + tail path")
        check(set(inc_launches) == {"maxsim_bf16", "maxsim_int8",
                                    "maxsim_int8full", "maxsim_int4",
                                    "maxsim_pq"},
              f"phase 22 ran K1, K2 (both modes), K4 and K3: "
              f"{sorted(inc_launches)}")
        torch.cuda.empty_cache()

        # 23. multi-device serving; the mesh searches' launches join the
        # entries of the kernels they ran
        reports, mesh_launches = mesh_phase(cm, gen, smi, Path(root))
        log("phase 23 report: " + json.dumps(reports))
        for kname, tiers in mesh_launches.items():
            entry = next(k for k in kernels if k["name"] == kname)
            entry["sharded_launches"] = tiers
        check(set(mesh_launches) == {"maxsim_bf16", "maxsim_int8",
                                     "maxsim_int8full", "maxsim_int4",
                                     "maxsim_pq"},
              f"phase 23 ran K1, K2 (both modes), K4 and K3 on the mesh: "
              f"{sorted(mesh_launches)}")

        # 24. multi-GPU training on phase 8's fixture; its K1 float32
        # launches join that kernel's entry
        torch.cuda.empty_cache()
        report, mesh_train = mesh_train_phase(cm, bundle, phase8["kw"],
                                              phase8, smi, work, Path(root))
        log("phase 24 report: " + json.dumps(report))
        entry = next(k for k in kernels if k["name"] == "maxsim_f32")
        entry["mesh_train_launches"] = mesh_train
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phases 1-24: {time.perf_counter() - t_start:.1f} s")
    for k in kernels:
        k["share_of_bound"] = k["bound_ms"] / k["ms"]
    n_k = 15 + 17
    check(len(kernels) == n_k and all(k["launches"] > 0 for k in kernels),
          f"{n_k} kernels, each launched on its path: "
          f"{[(k['name'], k['launches']) for k in kernels]}")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
