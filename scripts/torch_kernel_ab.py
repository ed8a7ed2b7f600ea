#!/usr/bin/env python3
"""Time the torch port's serving kernels (K1 bf16, K2 int8, K2 int8full) of
several checkouts on one GPU, in turns, to compare kernel versions within
one call.

    python3 scripts/torch_kernel_ab.py ROOT_A ROOT_B ROOT_B ROOT_A [--docs N]

Each ROOT is the root of a checkout that holds ``evdr_tpu_torch/``. Each
runs in a process of its own (the packages share a name), builds its
kernels from its own ``csrc/`` into its own ``build/``, and prints one JSON
line: the root, each library's ptxas register counts, and the median of 7
CUDA-event timings of each kernel at 256 x 32 queries against N x 768
pages (D = 128), made on the device from seed 0, with ~10% invalid tokens.
The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

NQ, LQ, D, LP = 256, 32, 128, 768


def one(root: str, docs: int) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from evdr_tpu_torch.ops import _cuda_build
    from evdr_tpu_torch.ops import cuda_maxsim as cm
    from evdr_tpu_torch.ops.quantize import quantize_tokens_int8

    if not cm.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {cm.__file__}, not from {root}")
    _cuda_build.build_all(["maxsim_bf16", "maxsim_int8"])
    regs = {n: [ln.split("Used ")[1].split(" registers")[0]
                for ln in _cuda_build.build_log(n).splitlines()
                if "registers" in ln]
            for n in ("maxsim_bf16", "maxsim_int8")}
    gen = torch.Generator(device="cuda").manual_seed(0)

    def unit(x):
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)

    Q = unit(torch.randn((NQ, LQ, D), device="cuda", generator=gen))
    qm = torch.rand((NQ, LQ), device="cuda", generator=gen) > 0.15
    codes = torch.empty((docs, LP, D), dtype=torch.int8, device="cuda")
    scales = torch.empty((docs, LP), dtype=torch.float32, device="cuda")
    Pb = torch.empty((docs, LP, D), dtype=torch.bfloat16, device="cuda")
    pm = torch.rand((docs, LP), device="cuda", generator=gen) > 0.1
    for i in range(0, docs, 1000):
        x = unit(torch.randn((min(1000, docs - i), LP, D), device="cuda",
                             generator=gen)) * pm[i:i + 1000, :, None]
        codes[i:i + 1000], scales[i:i + 1000] = quantize_tokens_int8(
            x, pm[i:i + 1000])
        Pb[i:i + 1000] = x.to(torch.bfloat16)

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

    return {"root": root, "docs": docs, "registers": regs, "ms": {
        "maxsim_bf16": ms(lambda: cm.maxsim_cuda(Q, Pb, qm, pm)),
        "maxsim_int8": ms(lambda: cm.maxsim_cuda_int8(Q, codes, scales, qm,
                                                      pm)),
        "maxsim_int8full": ms(lambda: cm.maxsim_cuda_int8full(
            Q, codes, scales, qm, pm))}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--docs", type=int, default=20_000)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(one(args.one, args.docs)), flush=True)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    for root in args.roots:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", root, "--docs", str(args.docs)],
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            print(r.stderr, file=sys.stderr)
            return r.returncode
        print(r.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
