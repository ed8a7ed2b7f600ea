"""Find the highest rate an open-loop cell sustains: one run of the cell's
own driver at each offered rate, in one process.

    python3 evdr_bench/sweep.py --workload <openloop cell> --seed <n> \
        --rates 600,800,1000 --seconds 10

One JSON line a rate: requests offered and failed, the answered rate
(``search_qps``), ``search_p95_ms`` (from when each request was due), how
late the sender ran, the batcher's mean group, and the compared numbers. A
rate is sustained while the answered rate keeps up with the offered one and
p95 stays within a few dispatches; past it the queue grows through the
window. The cell offers a fixed share of the highest sustained rate
(``PERF.md``).
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from evdr_bench.run import cache_env  # noqa: E402


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="open-loop rate sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    cache_env(ROOT)
    from evdr_bench import harness

    cell = harness.find_cell(harness.load_json(ROOT / "BENCHMARK.json"),
                             args.workload)
    group = harness.reader("batcher.group_size")
    for rate in [float(r) for r in args.rates.split(",")]:
        at_rate = dict(cell, traffic=dict(cell["traffic"], rate=rate))
        ctx = harness.Context(at_rate, args.seed, args.seconds, False)
        out = harness.run_cell(ctx)
        print(json.dumps({
            "rate": rate, "offered": out.attempted, "failed": out.failed,
            **out.e2e,
            "sender_late_ms_p95": out.obs["sender_late_ms_p95"],
            "mean_group": group.read(out.obs), "numbers": out.numbers}),
            flush=True)


if __name__ == "__main__":
    main()
