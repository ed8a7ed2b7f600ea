"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds,
through the program's plain versions."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the sizes a test run holds: (config overrides, traffic overrides)
TINY = {
    "config": {"n_pages": 1100, "page_tokens": 24, "dim": 32},
    "closed": {"batch": 8, "pool_batches": 2, "check_queries": 12,
               "n_candidates": 64},
    "openloop": {"rate": 150, "pool_queries": 64, "check_queries": 12},
    "train": {"q_batch": 8},
    "train_config": {"n_pages": 40, "questions_per_page": 5},
}


def tiny(workload: str) -> dict:
    """The cell ``workload`` of BENCHMARK.json at a test run's size."""
    from evdr_bench import harness

    cell = copy.deepcopy(harness.find_cell(
        harness.load_json(ROOT / "BENCHMARK.json"), workload))
    drv = cell["traffic"]["driver"]
    cell["config"].update(TINY["config"])
    if drv == "train":
        cell["config"].update(TINY["train_config"])
    for key, value in TINY[drv].items():
        if key in cell["traffic"]:
            cell["traffic"][key] = value
    return cell
