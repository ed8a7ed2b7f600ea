#!/usr/bin/env python3
"""Drive the torch port's serving path on one NVIDIA GPU and hold every CUDA
kernel against its plain PyTorch version.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout; it needs one CUDA device, ``nvcc`` and
``nvidia-smi``, and no network. Phases, one report line each:

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
   the end-to-end search_dense rate.

Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. Any failure raises: the script exits nonzero and prints no result
line. Launch counts in the kernels line come from phases 4 and 5 only.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}  # dense tensor-core peaks
NQ, LQ, D, LP = 256, 32, 128, 768
PARITY_DOCS, INT8_DOCS, BF16_DOCS = 1_000, 50_000, 10_000
K = 10


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
    for w in cm.KERNEL_WRAPPERS:
        check(counts[w.__name__] > 0, f"{w.__name__} never launched on the "
                                      "main path")

    # 6. times at the main path's shapes ---------------------------------
    def valid_ops(qmask, pmask):
        return 2.0 * D * float(qmask.sum()) * float(pmask.sum())

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

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
