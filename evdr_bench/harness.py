"""The harness: finds a cell's files by the names in ``BENCHMARK.json``,
times its set-up and window, and assembles the result line.

A cell (``workloads`` entry) names a configuration (``configs`` entry,
whose ``file`` holds its sizes) and a traffic mix, the data file
``traffic/<traffic>.json``, whose ``driver`` names the module
``drivers/<driver>.py`` that plays it. A per-layer metric ``<name>`` is read
by ``metrics/<name>.py`` (``read(obs) -> float | None``). Nothing here
knows a cell, a mix or a metric by name.

A driver's ``run(ctx)`` makes the inputs, builds, warms up, calls
``ctx.setup_done()``, runs its loop inside ``ctx.window()``, checks what
the loop produced against the reference and returns an ``Outcome``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names that no run may have loaded by the window's close
FORBIDDEN = ("jax", "jaxlib", "flax", "evdr_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return _module(BENCH_DIR / "drivers" / f"{name}.py",
                   f"evdr_bench_driver_{name}")


def reader(metric: str):
    return _module(BENCH_DIR / "metrics" / f"{metric}.py",
                   "evdr_bench_metric_" + metric.replace(".", "_"))


def find_cell(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, traffic mix and metrics."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return {
        "workload": w,
        "config": load_json(root / conf["file"]),
        "traffic": load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
    }


@dataclass
class Outcome:
    """What a driver hands back: end-to-end values, counts, the compared
    numbers, and observations for the per-layer readers."""
    e2e: dict
    attempted: int
    failed: int
    numbers: dict
    memory_peak_bytes: int
    obs: dict = field(default_factory=dict)


class Window:
    def __init__(self):
        self.t0 = time.perf_counter()
        self.seconds = None

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0


class Context:
    """One run of one cell: its files, seed, length, device and clocks."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", t_start: Optional[float] = None):
        self.cell = cell
        self.config = cell["config"]
        self.traffic = cell["traffic"]
        self.seed = int(seed)
        self.trace = bool(trace)
        # a traced run profiles a window of at most trace_seconds
        self.seconds = (min(float(seconds),
                            float(self.traffic.get("trace_seconds", seconds)))
                        if trace else float(seconds))
        self.device = device
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.setup_s = None
        self.setup_peak_bytes = 0
        self.traces: list = []
        # (phase, seconds since the process started) of the set-up
        self.marks: list = []

    def mark(self, phase: str) -> None:
        """The end of a set-up phase, for the set-up breakdown."""
        self.sync()
        self.marks.append((phase, time.perf_counter() - self.t_start))

    def sync(self) -> None:
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()

    def setup_done(self) -> None:
        """The end of set-up: ``setup_s`` is read, and the device's peak
        memory starts again, so ``memory_peak`` reads what the served
        deployment holds in the window, not set-up's transients."""
        self.mark("warm-up")
        self.setup_s = self.marks[-1][1]
        if self.device != "cpu":
            import torch

            self.setup_peak_bytes = int(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()

    def span(self, name: str):
        """A benchmark span around a call into a layer (traced runs)."""
        if not self.trace:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def window(self):
        """The measured window: its length ends once the device is done."""
        from evdr_bench.trace import WINDOW_SPAN, profiled

        if self.setup_s is None:
            raise RuntimeError("the driver opened its window before "
                               "ending its set-up")
        with profiled(self.trace and self.device != "cpu", self.traces):
            with self.span(WINDOW_SPAN):
                w = Window()
                yield w
                self.sync()
                w.seconds = w.elapsed()

    def memory_peak(self) -> int:
        """The device's peak memory since set-up ended."""
        if self.device == "cpu":
            return 0
        import torch

        return int(torch.cuda.max_memory_allocated())

    def free(self) -> None:
        import gc

        gc.collect()
        if self.device != "cpu":
            import torch

            torch.cuda.empty_cache()


def run_cell(ctx: Context) -> Outcome:
    return driver(ctx.traffic["driver"]).run(ctx)


def forbidden_modules(modules) -> list:
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def result(ctx: Context, out: Outcome, correct: bool, checks: dict,
           device: dict) -> dict:
    """The result line: ``--trace 0`` carries the cell's end-to-end
    metrics, ``--trace 1`` its per-layer metrics (those whose reader finds
    something to read)."""
    metrics, breakdown = {}, None
    summary = ctx.traces[0] if ctx.traces else None
    if not ctx.trace:
        values = dict(out.e2e, setup_s=ctx.setup_s)
        for m in ctx.cell["end_to_end"]:
            v = values.get(m["name"])
            if v is None or not math.isfinite(v):
                raise RuntimeError(f"metric {m['name']} was not measured")
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        obs = dict(out.obs, trace=summary)
        for m in ctx.cell["per_layer"]:
            v = reader(m["name"]).read(obs)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if summary is not None:
            device = dict(device, busy_s=summary.busy_s,
                          window_s=summary.window_s)
            breakdown = {"device_ops": [list(x) for x in summary.device_ops],
                         "idle_gaps": [list(x) for x in summary.idle_gaps]}
    line = {"correct": bool(correct), "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics,
            "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    # a missing answer reads infinite: null in the JSON line
    line["checks"] = {n: {k: (v if v is None or math.isfinite(v) else None)
                          for k, v in c.items()} for n, c in checks.items()}
    return line
