#!/usr/bin/env python3
"""Time the torch port's kernels of several checkouts on one GPU, in
turns, to compare kernel versions within one call.

    python3 scripts/torch_kernel_ab.py ROOT_A ROOT_B ROOT_B ROOT_A \
        [--docs N] [--lp LP] [--only NAME,...]

Each ROOT is the root of a checkout that holds ``evdr_tpu_torch/``. Each
runs in a process of its own (the packages share a name), builds its
kernels from its own ``csrc/`` into its own ``build/``, and prints one JSON
line: the root, each library's ptxas register counts, a hash of each of
its kernels' SASS (``cuobjdump -sass``; equal hashes across roots mean the
same machine code), each wgmma kernel's configuration, and, per kernel,
the median of 7 CUDA-event timings and a hash of its output (equal hashes
across roots mean bit-equal scores).
Inputs are made on the device from seed 0, with ~10% invalid tokens:
- K1 bf16, K2 int8 and int8full, K2b's two modes where the checkout has
  them (whether each equals K2 bit for bit goes to ``checks``), and K4
  int4 and int4full over the same pages packed to int4, at 256 x 32
  queries against N x LP pages (default 20,000 x 768; D = 128). Where the
  checkout has K2 int8full's wgmma kernel, ``maxsim_int8full`` times the
  wrapper's route and ``maxsim_int8full_mma`` the mma.sync loop on the same
  operands, whether the two agree bit for bit goes to ``checks`` and the
  wgmma kernel's configuration (``int8full_wg_config``) to ``designs``;
- K3 over the same N x LP pages as PQ codes (M = 16): pq and pqfull with
  compact (16, 256, 8) books, pq with expanded (16, 256, 128) books;
- K1 float32 at the trainer's two shapes: the eval (1,000 x 32 queries
  against 1,000 x 137 pages) and the teacher precompute (256 x 32 against
  1,000 x 768), checked bit-equal to K5 float32's scores;
- K5 and K6 in both modes at the train step's shape (32 x 32 queries
  against 1,000 x 154 pages) and at 256 x 32 queries (eight chunks of K6),
  K6 on K5's M and a random upstream gradient; their output hashes cover
  scores and M, dQ and dP; K5 bf16's scores checked bit-equal to K1's.
``--only`` keeps the kernels whose names start with one of the given
prefixes (e.g. ``maxsim_pq,maxsim_f32``). The card's name and power limit
come first. After the roots, one ``compare`` line against the first root:
for each library whether its SASS hashes are the first root's, and how
many of the first root's kernels have their machine code, by hash, among
this root's kernels of the library (``sass_kept``; a kernel whose name
changed, a template flag or a parameter added at the end, still counts),
with the names of those that do not (``sass_lost``); for each root whose
K1 bf16 output hash differs from the first root's, the largest score
difference and the top-1 and top-10 agreement (the share of queries whose
best doc is the same; the mean share of the first root's ten best docs
among the root's ten best); for each K5 timing whose output differs, the
largest difference of its scores and M; for each K6 timing whose output
hash differs, the largest difference of dQ and of dP relative to the first
root's largest magnitude.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

import numpy as np

NQ, LQ, D = 256, 32, 128
PQ_M = 16
F32_SHAPES = {"eval": (1_000, 137, 1_000), "teacher": (256, 768, 1_000)}
# K5/K6: (queries, page tokens, pages) at the train step and at 256 queries
TRAIN_SHAPES = {"step": (32, 154, 1_000), "256q": (256, 154, 1_000)}
LIBS = ("maxsim_bf16", "maxsim_int8", "maxsim_int8_defer", "maxsim_int4",
        "maxsim_train", "maxsim_f32", "maxsim_pq")


def sass_hashes(lib_path) -> dict:
    """Each kernel's (mangled) name in a library -> a 12-hex-digit hash of
    its SASS (instructions only, without addresses and encodings)."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    kernels = {}
    for ln in out.splitlines():
        if "Function :" in ln:
            # an anonymous namespace's mangled name carries a hash of the
            # source's path, which differs between checkouts
            name = re.sub(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "(anon)",
                          ln.split("Function :")[1].strip())
            kernels[name] = h = hashlib.sha1()
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?);", ln)
        if m and kernels:
            h.update(m.group(1).strip().encode())
    return {k: v.hexdigest()[:12] for k, v in sorted(kernels.items())}


def one(root: str, docs: int, lp: int, only=None, save=None) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from evdr_tpu_torch.ops import _cuda_build
    from evdr_tpu_torch.ops import cuda_maxsim as cm
    from evdr_tpu_torch.ops import cuda_maxsim_train as ct
    from evdr_tpu_torch.ops.int4 import quantize_tokens_int4
    from evdr_tpu_torch.ops.quantize import quantize_tokens_int8

    if not cm.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {cm.__file__}, not from {root}")
    torch.set_float32_matmul_precision("highest")
    libs = [n for n in LIBS if n in _cuda_build.LIBRARIES]
    _cuda_build.build_all(libs)
    regs = {n: [ln.split("Used ")[1].split(" registers")[0]
                for ln in _cuda_build.build_log(n).splitlines()
                if "Used " in ln and " registers" in ln]
            for n in libs}
    sass = {n: sass_hashes(_cuda_build.library_path(n)) for n in libs}
    gen = torch.Generator(device="cuda").manual_seed(0)

    def unit(x):
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)

    def rand_mask(*shape):
        return torch.rand(shape, device="cuda", generator=gen) > 0.1

    Q = unit(torch.randn((NQ, LQ, D), device="cuda", generator=gen))
    qm = torch.rand((NQ, LQ), device="cuda", generator=gen) > 0.15
    codes = torch.empty((docs, lp, D), dtype=torch.int8, device="cuda")
    scales = torch.empty((docs, lp), dtype=torch.float32, device="cuda")
    Pb = torch.empty((docs, lp, D), dtype=torch.bfloat16, device="cuda")
    packed = torch.empty((docs, (lp + 1) // 2, D), dtype=torch.uint8,
                         device="cuda")
    scales4 = torch.empty((docs, lp), dtype=torch.float32, device="cuda")
    pm = rand_mask(docs, lp)
    step = max(1, 768_000 // lp)
    for i in range(0, docs, step):
        x = unit(torch.randn((min(step, docs - i), lp, D), device="cuda",
                             generator=gen)) * pm[i:i + step, :, None]
        codes[i:i + step], scales[i:i + step] = quantize_tokens_int8(
            x, pm[i:i + step])
        packed[i:i + step], scales4[i:i + step] = quantize_tokens_int4(
            x, pm[i:i + step])
        Pb[i:i + step] = x.to(torch.bfloat16)
    pq_codes = torch.randint(0, 256, (docs, lp, PQ_M), dtype=torch.uint8,
                             device="cuda", generator=gen)
    compact = torch.randn((PQ_M, 256, D // PQ_M), device="cuda",
                          generator=gen) * 0.3
    expanded = torch.randn((PQ_M, 256, D), device="cuda", generator=gen) * 0.1
    train = {}
    for name, (nq, plp, nd) in TRAIN_SHAPES.items():
        Qt = unit(torch.randn((nq, LQ, D), device="cuda", generator=gen))
        qmt = torch.rand((nq, LQ), device="cuda", generator=gen) > 0.15
        Pt = unit(torch.randn((nd, plp, D), device="cuda", generator=gen))
        g = torch.randn((nq, nd), device="cuda", generator=gen)
        train[name] = (Qt, Pt, qmt, rand_mask(nd, plp), g)
    f32 = {}
    for name, (nq, plp, nd) in F32_SHAPES.items():
        Qf = unit(torch.randn((nq, LQ, D), device="cuda", generator=gen))
        qmf = torch.rand((nq, LQ), device="cuda", generator=gen) > 0.15
        Pf = unit(torch.randn((nd, plp, D), device="cuda", generator=gen))
        f32[name] = (Qf, Pf, qmf, rand_mask(nd, plp))

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(7):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)

    def digest(t):
        return hashlib.sha1(t.contiguous().cpu().numpy().tobytes()
                            ).hexdigest()[:12]

    i8 = (Q, codes, scales, qm, pm)
    i4 = (Q, packed, scales4, qm, pm)
    calls = {
        "maxsim_bf16": lambda: cm.maxsim_cuda(Q, Pb, qm, pm),
        "maxsim_int8": lambda: cm.maxsim_cuda_int8(*i8),
        "maxsim_int8full": lambda: cm.maxsim_cuda_int8full(*i8),
        "maxsim_int4": lambda: cm.maxsim_cuda_int4(*i4),
        "maxsim_int4full": lambda: cm.maxsim_cuda_int4full(*i4),
        "maxsim_pq": lambda: cm.maxsim_cuda_pq(Q, pq_codes, qm, pm, compact),
        "maxsim_pqfull": lambda: cm.maxsim_cuda_pqfull(Q, pq_codes, qm, pm,
                                                       compact),
        "maxsim_pq_expanded": lambda: cm.maxsim_cuda_pq(Q, pq_codes, qm, pm,
                                                        expanded)}
    for name, args in f32.items():
        calls[f"maxsim_f32_{name}"] = lambda a=args: cm.maxsim_cuda_f32(*a)
    k6_out = {}
    for name, (Qt, Pt, qmt, pmt, g) in train.items():
        for sfx, cd in (("", torch.bfloat16), ("_f32", torch.float32)):
            M = ct.maxsim_cuda_fwd_train(Qt, Pt, qmt, pmt, cd)[1]
            calls[f"maxsim_fwd_train{sfx}_{name}"] = (
                lambda a=(Qt, Pt, qmt, pmt, cd): ct.maxsim_cuda_fwd_train(*a))
            calls[f"maxsim_bwd{sfx}_{name}"] = (
                lambda a=(Qt, Pt, qmt, pmt, M, g, cd): ct.maxsim_cuda_bwd(*a))
            k6_out[f"maxsim_bwd{sfx}_{name}"] = Qt.numel()
    checks, designs = {}, {"maxsim_bf16": cm.bf16_config(D)}
    if hasattr(cm, "int8full_wg_config"):
        def int8full_mma():
            # the mma.sync loop on the operands the wrapper hands its route
            qk, qw = cm.quantize_queries_int8(Q, qm)
            out = torch.empty((NQ, docs), device="cuda")
            cm.call_kernel("maxsim_int8", "evdr_maxsim_int8full",
                           (qk, qw, codes, scales, pm, out), NQ, LQ, docs,
                           lp, D, aligned=(qk, codes))
            return out

        calls["maxsim_int8full_mma"] = int8full_mma
        checks[f"maxsim_int8full ({cm.int8full_func(lp, D)}) == mma.sync"] \
            = bool(torch.equal(cm.maxsim_cuda_int8full(*i8), int8full_mma()))
        designs["maxsim_int8full"] = cm.int8full_wg_config(D)
    if hasattr(cm, "maxsim_cuda_int8_deferred"):
        for k2, k2b in ((cm.maxsim_cuda_int8, cm.maxsim_cuda_int8_deferred),
                        (cm.maxsim_cuda_int8full,
                         cm.maxsim_cuda_int8full_deferred)):
            checks[f"{k2b.__name__} == K2"] = bool(torch.equal(k2(*i8),
                                                             k2b(*i8)))
            calls[k2b.__name__] = lambda k=k2b: k(*i8)
    for name, args in f32.items():
        checks[f"maxsim_f32_{name} == K5 f32"] = bool(torch.equal(
            cm.maxsim_cuda_f32(*args), ct.maxsim_cuda_fwd_train_f32(*args)[0]))
    for name, (Qt, Pt, qmt, pmt, _) in train.items():
        checks[f"maxsim_fwd_train_{name} == K1"] = bool(torch.equal(
            cm.maxsim_cuda(Qt, Pt, qmt, pmt),
            ct.maxsim_cuda_fwd_train(Qt, Pt, qmt, pmt)[0]))
    if only:
        calls = {k: v for k, v in calls.items() if k.startswith(tuple(only))}
    times, outs, kept = {}, {}, {}
    for name, fn in calls.items():
        out = fn()
        if isinstance(out, tuple):  # K5: scores, M; K6: dQ, dP
            out = torch.cat([x.flatten() for x in out])
        outs[name] = digest(out)
        if name == "maxsim_bf16" or name.startswith("maxsim_fwd_train"):
            kept[name] = out.cpu().numpy()
        elif name in k6_out:
            n = k6_out[name]
            kept[name + ".dq"] = out[:n].cpu().numpy()
            kept[name + ".dp"] = out[n:].cpu().numpy()
        times[name] = ms(fn)
    if save:
        np.savez(save, **kept)
    return {"root": root, "docs": docs, "lp": lp, "registers": regs,
            "sass": sass, "designs": designs, "ms": times, "out_sha1": outs,
            "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--docs", type=int, default=20_000)
    ap.add_argument("--lp", type=int, default=768)
    ap.add_argument("--only", default="")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--save", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        only = [x for x in args.only.split(",") if x]
        print(json.dumps(one(args.one, args.docs, args.lp, only, args.save)),
              flush=True)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, root in enumerate(args.roots):
            save = os.path.join(tmp, f"{i}.npz")
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--one", root, "--docs", str(args.docs),
                                "--lp", str(args.lp), "--only", args.only,
                                "--save", save],
                               capture_output=True, text=True, timeout=900)
            if r.returncode != 0:
                print(r.stderr, file=sys.stderr)
                return r.returncode
            print(r.stdout.strip(), flush=True)
            results.append(json.loads(r.stdout.strip().splitlines()[-1]))
        if results:
            print(json.dumps(compare(results, tmp)), flush=True)
    return 0


def agreement(a, b) -> dict:
    """Score difference and top-1 / top-10 agreement of (nq, nd) scores
    ``b`` against ``a``."""
    k = min(10, a.shape[1])
    top_a = np.argsort(-a, axis=1, kind="stable")[:, :k]
    top_b = np.argsort(-b, axis=1, kind="stable")[:, :k]
    return {"max_abs_diff": float(np.abs(a - b).max()),
            "top1": float(np.mean(top_a[:, 0] == top_b[:, 0])),
            "top10": float(np.mean([len(set(x) & set(y)) / k
                                    for x, y in zip(top_a, top_b)]))}


def compare(results, tmp) -> dict:
    """Each root against the first: SASS hashes per library, and which of
    the first root's kernels keep their machine code; where K1 bf16's
    output differs, its agreement; where a K5 output differs, its largest
    difference; where a K6 output differs, its largest relative
    difference."""
    first = results[0]
    out = {"compare_to": first["root"], "roots": []}
    ref = np.load(os.path.join(tmp, "0.npz"))

    def short(name):
        return name.split("(anon)")[-1][:48]

    for i, r in enumerate(results):
        kept, lost = {}, {}
        for n, kernels in first["sass"].items():
            mine = set(r["sass"].get(n, {}).values())
            gone = [short(k) for k, h in kernels.items() if h not in mine]
            kept[n] = f"{len(kernels) - len(gone)}/{len(kernels)}"
            if gone:
                lost[n] = gone
        row = {"root": r["root"], "sass_equal": {
            n: r["sass"].get(n) == first["sass"].get(n) for n in r["sass"]},
            "sass_kept": kept, "sass_lost": lost}
        got = np.load(os.path.join(tmp, f"{i}.npz"))
        for name, h in r["out_sha1"].items():
            if h == first["out_sha1"].get(name):
                continue
            if name == "maxsim_bf16":
                row[name] = agreement(ref[name], got[name])
            elif name.startswith("maxsim_fwd_train") and name in ref.files:
                row[name] = float(np.abs(got[name] - ref[name]).max())
            elif name + ".dq" in got.files and name + ".dq" in ref.files:
                row[name] = {part: float(
                    np.abs(got[f"{name}.{part}"] - ref[f"{name}.{part}"]).max()
                    / np.abs(ref[f"{name}.{part}"]).max())
                    for part in ("dq", "dp")}
        out["roots"].append(row)
    return out


if __name__ == "__main__":
    sys.exit(main())
