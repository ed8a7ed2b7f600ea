#!/usr/bin/env python3
"""Time the torch port's serving kernels (K1 bf16, K2 int8, K2 int8full,
and K2b's two modes where the checkout has them) of several checkouts on
one GPU, in turns, to compare kernel versions within one call.

    python3 scripts/torch_kernel_ab.py ROOT_A ROOT_B ROOT_B ROOT_A \
        [--docs N] [--lp LP]

Each ROOT is the root of a checkout that holds ``evdr_tpu_torch/``. Each
runs in a process of its own (the packages share a name), builds its
kernels from its own ``csrc/`` into its own ``build/``, and prints one JSON
line: the root, each library's ptxas register counts, a hash of each of
its kernels' SASS (``cuobjdump -sass``; equal hashes across roots mean the
same machine code), and the median of 7 CUDA-event timings of each kernel
at 256 x 32 queries against N x LP pages (default 20,000 x 768; D = 128),
made on the device from seed 0, with ~10% invalid tokens. K2b's times are
checked bit-equal to K2's scores. The card's name and power limit come
first.
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

NQ, LQ, D = 256, 32, 128


def sass_hashes(lib_path) -> list:
    """Sorted 12-hex-digit hashes of the SASS of each kernel in a library
    (instructions only, without addresses and encodings)."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    kernels = []
    for ln in out.splitlines():
        if "Function :" in ln:
            kernels.append(hashlib.sha1())
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?);", ln)
        if m and kernels:
            kernels[-1].update(m.group(1).strip().encode())
    return sorted(h.hexdigest()[:12] for h in kernels)


def one(root: str, docs: int, lp: int) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from evdr_tpu_torch.ops import _cuda_build
    from evdr_tpu_torch.ops import cuda_maxsim as cm
    from evdr_tpu_torch.ops.quantize import quantize_tokens_int8

    if not cm.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {cm.__file__}, not from {root}")
    libs = [n for n in ("maxsim_bf16", "maxsim_int8", "maxsim_int8_defer")
            if n in _cuda_build.LIBRARIES]
    _cuda_build.build_all(libs)
    regs = {n: [ln.split("Used ")[1].split(" registers")[0]
                for ln in _cuda_build.build_log(n).splitlines()
                if "registers" in ln]
            for n in libs}
    sass = {n: sass_hashes(_cuda_build.library_path(n)) for n in libs}
    gen = torch.Generator(device="cuda").manual_seed(0)

    def unit(x):
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)

    Q = unit(torch.randn((NQ, LQ, D), device="cuda", generator=gen))
    qm = torch.rand((NQ, LQ), device="cuda", generator=gen) > 0.15
    codes = torch.empty((docs, lp, D), dtype=torch.int8, device="cuda")
    scales = torch.empty((docs, lp), dtype=torch.float32, device="cuda")
    Pb = torch.empty((docs, lp, D), dtype=torch.bfloat16, device="cuda")
    pm = torch.rand((docs, lp), device="cuda", generator=gen) > 0.1
    step = max(1, 768_000 // lp)
    for i in range(0, docs, step):
        x = unit(torch.randn((min(step, docs - i), lp, D), device="cuda",
                             generator=gen)) * pm[i:i + step, :, None]
        codes[i:i + step], scales[i:i + step] = quantize_tokens_int8(
            x, pm[i:i + step])
        Pb[i:i + step] = x.to(torch.bfloat16)

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

    i8 = (Q, codes, scales, qm, pm)
    times = {
        "maxsim_bf16": ms(lambda: cm.maxsim_cuda(Q, Pb, qm, pm)),
        "maxsim_int8": ms(lambda: cm.maxsim_cuda_int8(*i8)),
        "maxsim_int8full": ms(lambda: cm.maxsim_cuda_int8full(*i8))}
    if hasattr(cm, "maxsim_cuda_int8_deferred"):
        for k2, k2b in ((cm.maxsim_cuda_int8, cm.maxsim_cuda_int8_deferred),
                        (cm.maxsim_cuda_int8full,
                         cm.maxsim_cuda_int8full_deferred)):
            if not torch.equal(k2(*i8), k2b(*i8)):
                raise RuntimeError(f"{k2b.__name__} differs from K2")
            times[k2b.__name__] = ms(lambda: k2b(*i8))
    return {"root": root, "docs": docs, "lp": lp, "registers": regs,
            "sass": sass, "ms": times}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--docs", type=int, default=20_000)
    ap.add_argument("--lp", type=int, default=768)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(one(args.one, args.docs, args.lp)), flush=True)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    for root in args.roots:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", root, "--docs", str(args.docs),
                            "--lp", str(args.lp)],
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            print(r.stderr, file=sys.stderr)
            return r.returncode
        print(r.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
