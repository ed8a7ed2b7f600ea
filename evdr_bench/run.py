"""Run one cell of the benchmark once and print its result line.

    python3 evdr_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``evdr_tpu_torch``. Exits nonzero,
and prints no result, without enough CUDA devices for the cell, without the
program, or when JAX or the JAX package was loaded. The last line of
standard output is the JSON result; the compared numbers, each beside its
limit, are also the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def cache_env(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own nvcc builds already go to ``build/`` there), and no JAX
    pulled in by a library."""
    cache = root / "build" / "evdr_bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int) -> None:
    print(f"evdr_bench: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> None:
    args = parse(argv)
    cache_env(ROOT)
    sys.path.insert(0, str(ROOT))
    import torch

    from evdr_bench import check, harness

    bench_file = ROOT / "BENCHMARK.json"
    if not bench_file.is_file():
        fail("BENCHMARK.json is missing", 2)
    cell = harness.find_cell(harness.load_json(bench_file), args.workload)
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} CUDA device(s); "
             f"{torch.cuda.device_count()} available", 3)
    if not (ROOT / "evdr_tpu_torch").is_dir():
        fail("the program (evdr_tpu_torch) is not in the checkout", 4)
    torch.set_num_threads(4)
    ctx = harness.Context(cell, args.seed, args.seconds, bool(args.trace),
                          device="cuda", t_start=T_START)
    torch.cuda.init()
    ctx.mark("imports and CUDA context")
    out = harness.run_cell(ctx)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        fail(f"modules that no run may load were loaded: {bad}", 5)
    correct, checks = check.judge(out.numbers,
                                  cell["traffic"].get("limits"))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out.memory_peak_bytes}
    line = harness.result(ctx, out, correct, checks, device)
    prev = 0.0
    for phase, t in ctx.marks:
        print(f"setup {phase}: {t - prev:.3f} s", file=sys.stderr)
        prev = t
    print(f"setup peak memory: {ctx.setup_peak_bytes} bytes",
          file=sys.stderr)
    for name, value in out.obs.items():
        if isinstance(value, (int, float)):
            print(f"observed {name}: {value!r}", file=sys.stderr)
    for name, value in out.numbers.items():
        if name not in checks:
            print(f"reading {name}: {value!r} (not compared)",
                  file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
