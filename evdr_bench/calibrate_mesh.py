"""The control and a planted fault of a mesh cell (``drivers/closed_mesh``),
whose corpus no process holds, so ``calibrate.py``'s serving control,
which makes the whole corpus, cannot read it:

- ``--control-seeds``: the reference at int4 put in the program's place
  (its top-k over every page), compared with the reference at the
  configuration's precision as a run's answers are;
- ``--faults dropped_shard``, on the control seeds: one run of the cell a
  seed with the program's merge leaving the first shard's candidates out.

    python3 evdr_bench/calibrate_mesh.py --workload <name> \
        --control-seeds 3,4 [--faults dropped_shard] [--seconds 3]

One JSON line a reading on standard output.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from evdr_bench.run import cache_env  # noqa: E402

FAULTS = ("dropped_shard",)


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` planted for the block:
    ``dropped_shard`` makes the mesh's merge (``parallel/topk.
    merge_shard_topk``) see no candidate of the first shard."""
    import torch

    from evdr_tpu_torch.parallel import topk

    if fault not in FAULTS:
        raise ValueError(f"no mesh fault {fault!r}")
    plain = topk.merge_shard_topk

    def dropped(vals, gidx, mesh, k, nq):
        vals = [torch.full_like(v, -torch.inf) if i == 0 else v
                for i, v in enumerate(vals)]
        return plain(vals, gidx, mesh, k, nq)

    topk.merge_shard_topk = dropped
    try:
        yield
    finally:
        topk.merge_shard_topk = plain


def control(cell: dict, seed: int, device: str) -> dict:
    """The int4 reference's top-k against the configuration's reference,
    on ``check_queries`` queries of the seed."""
    import torch

    from evdr_bench import check, harness

    drv = harness.driver("closed_mesh")
    ctx = harness.Context(cell, seed, 0.0, False, device=device)
    devs = list(drv.make_mesh(ctx).devices)
    tr = cell["traffic"]
    k = int(tr["k"])
    Q, qmask = drv.make_queries(ctx, int(tr["check_queries"]), devs)
    ref = drv.reference_scores(ctx, Q, qmask, devs)
    low = drv.reference_scores(ctx, Q, qmask, devs, levels_of="int4")
    vals, idx = torch.sort(low, dim=1, descending=True, stable=True)
    return check.topk_gaps(vals[:, :k].cpu(), idx[:, :k].cpu(), ref, k,
                           exact=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="a mesh cell's control")
    p.add_argument("--workload", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cache_env(ROOT)
    import torch

    from evdr_bench import harness

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("calibrate_mesh: no CUDA device")
    cell = harness.find_cell(harness.load_json(ROOT / "BENCHMARK.json"),
                             args.workload)
    cell["traffic"] = dict(cell["traffic"], limits=None)
    faults = [f for f in args.faults.split(",") if f]
    if not set(faults) <= set(FAULTS):
        sys.exit(f"calibrate_mesh: --faults takes {FAULTS}")
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        for kind in ["control"] + faults:
            t = time.perf_counter()
            if kind == "control":
                numbers = control(cell, seed, args.device)
            else:
                with planted(kind):
                    numbers = harness.run_cell(harness.Context(
                        cell, seed, args.seconds, False,
                        device=args.device)).numbers
            print(json.dumps({"kind": kind, "seed": seed, "numbers": numbers,
                              "seconds": time.perf_counter() - t}),
                  flush=True)


if __name__ == "__main__":
    main()
