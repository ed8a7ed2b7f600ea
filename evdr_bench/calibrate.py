"""The readings that set the limits of ``correct``, in one process:

- ``--seeds``: the program's compared numbers, one run of the cell a seed
  (a window of ``--seconds``);
- ``--control-seeds``: the control's, the reference put in the program's
  place at the precision below the configuration's (int4 for an int8
  index and int8 queries; TF32 for float32 training), compared with the
  reference as a run's answers are;
- ``--faults``, on the control seeds: for training, faults planted in the
  reference put in the program's place: ``half_batch`` (each step's loss
  over half its batch), ``altered_token`` (one query token of the first
  batch replaced); for pruned search, a fault planted in the program:
  ``arbitrary_candidates`` (stage 1 picks arbitrary pages), one run of the
  cell a seed.

    python3 evdr_bench/calibrate.py --workload <name> --seeds 1,2 \
        --seconds 3 --control-seeds 3,4,5 [--faults half_batch]

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

TRAINING_FAULTS = ("half_batch", "altered_token")
SERVING_FAULTS = ("arbitrary_candidates",)


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` planted for the block:
    ``arbitrary_candidates`` gives every page a random stage-1 score
    (pages stage 1 rules out stay out), so pruned search reranks arbitrary
    pages."""
    import torch

    from evdr_tpu_torch.ops import pruned

    if fault not in SERVING_FAULTS:
        raise ValueError(f"no serving fault {fault!r}")
    plain = pruned.candidate_scores

    def arbitrary(*args, **kwargs):
        sc = plain(*args, **kwargs)
        return torch.where(torch.isfinite(sc), torch.rand_like(sc), sc)

    pruned.candidate_scores = arbitrary
    try:
        yield
    finally:
        pruned.candidate_scores = plain


def serving_control(cell: dict, seed: int, device: str) -> dict:
    import torch

    from evdr_bench import check, harness, serving

    ctx = harness.Context(cell, seed, 0.0, False, device=device)
    tr = cell["traffic"]
    P, pmask, Q, qmask = serving.make_inputs(ctx, int(tr["check_queries"]))
    del P, pmask
    ctx.free()
    k = int(tr["k"])
    ref = serving.reference_scores(ctx, Q, qmask)
    low = serving.reference_scores(ctx, Q, qmask, levels_of="int4")
    vals, idx = torch.sort(low, dim=1, descending=True, stable=True)
    return check.topk_gaps(vals[:, :k].cpu(), idx[:, :k].cpu(), ref, k,
                           exact=not tr.get("n_candidates"))


def train_readings(cell: dict, seed: int, device: str, kind: str) -> dict:
    """The control (``kind`` 'control') or a planted fault against the
    reference on the run's first batches."""
    import numpy as np
    import torch

    from evdr_bench import gen, harness, reference

    ctx = harness.Context(cell, seed, 0.0, False, device=device)
    tr = harness.driver("train")
    P, pmask, Q, qmask, p0, pm_s = tr.make_inputs(ctx)
    b = int(cell["traffic"]["q_batch"])
    perm = np.random.default_rng(seed).permutation(Q.shape[0])
    batches = [perm[i * b:(i + 1) * b] for i in range(tr.CHECKED_STEPS)]
    hp = tr.ref_hp(cell["config"])
    ref = reference.train_reference(P, pmask, Q, qmask, batches, p0, pm_s,
                                    hp)
    Qf, fb, tf32 = Q, batches, False
    if kind == "control":
        tf32 = True
    elif kind == "half_batch":
        fb = [x[:b // 2] for x in batches]
    elif kind == "altered_token":
        Qf = Q.clone()
        g = gen.generator(seed, "fault", device=Q.device)
        Qf[int(batches[0][0]), 0] = gen.unit(
            torch.randn((Q.shape[-1],), generator=g, device=Q.device))
    got = reference.train_reference(P, pmask, Qf, qmask, fb, p0, pm_s, hp,
                                    tf32=tf32)
    return tr.gaps(got, ref)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="readings for the limits")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cache_env(ROOT)
    import torch

    from evdr_bench import harness

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA device")
    cell = harness.find_cell(harness.load_json(ROOT / "BENCHMARK.json"),
                             args.workload)
    cell["traffic"] = dict(cell["traffic"], limits=None)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds:
        ctx = harness.Context(cell, seed, args.seconds, False,
                              device=args.device)
        out = harness.run_cell(ctx)
        print(json.dumps({"kind": "program", "seed": seed,
                          "numbers": out.numbers, "e2e": out.e2e,
                          "setup_s": ctx.setup_s}), flush=True)
        del out, ctx
    training = cell["traffic"]["driver"] == "train"
    faults = TRAINING_FAULTS if training else SERVING_FAULTS
    kinds = ["control"] + [f for f in args.faults.split(",") if f]
    if not set(kinds[1:]) <= set(faults):
        sys.exit(f"calibrate: --faults takes {faults} for this cell")
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        for kind in kinds:
            t = time.perf_counter()
            if training:
                numbers = train_readings(cell, seed, args.device, kind)
            elif kind == "control":
                numbers = serving_control(cell, seed, args.device)
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
