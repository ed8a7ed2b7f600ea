"""Results reporter: train.log tree -> per-mf summary sheets (.xlsx + .csv).

The torch port's copy of ``evdr_tpu/tools/report.py`` (stdlib only). Console script: ``evdr-report-torch``.

Behavior parity with reference ``summary_results.py``: walks
``<root>/<setting>/mf<k>/<dataset>/train.log``, extracts the LAST
``summary/best_ndcg5`` JSON line (reverse scan of the tail), normalizes [0,1]
metrics to percent, and emits one sheet per mf with per-dataset ``N@5``/
``R@1`` columns plus averages. Output is a dependency-free .xlsx (see
``evdr_tpu_torch.tools.xlsx``) plus per-mf CSVs.
"""

from __future__ import annotations

import argparse
import csv
import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional

from evdr_tpu_torch.tools.xlsx import write_xlsx

SUMMARY_RE = re.compile(r"(\{.*\"summary/best_ndcg5\".*\})\s*$")
TAIL_LINES = 3000


def parse_train_log(train_log: Path) -> Optional[Dict[str, float]]:
    """Last summary/best_ndcg5 line -> {"N@5": pct, "R@1": pct, "step": int}."""
    if not train_log.exists():
        return None
    try:
        lines = train_log.read_text(encoding="utf-8", errors="ignore").splitlines()
    except OSError:
        return None
    for line in reversed(lines[-TAIL_LINES:]):
        m = SUMMARY_RE.search(line.strip())
        if not m:
            continue
        try:
            obj = json.loads(m.group(1))
        except json.JSONDecodeError:
            continue
        d = obj.get("summary/best_ndcg5")
        if not isinstance(d, dict):
            continue
        ndcg, recall = d.get("NDCG@5"), d.get("Recall@1")
        if ndcg is None or recall is None:
            continue
        ndcg, recall = float(ndcg), float(recall)
        if 0.0 <= ndcg <= 1.0:
            ndcg *= 100.0
        if 0.0 <= recall <= 1.0:
            recall *= 100.0
        out = {"N@5": ndcg, "R@1": recall}
        step = d.get("step", d.get("epoch"))
        if step is not None:
            out["step"] = int(step)
        return out
    return None


def collect_results(root) -> Dict[str, Dict[str, Dict[str, Dict[str, float]]]]:
    """-> {mf: {setting: {dataset: {"N@5":, "R@1":}}}}"""
    root = Path(root)
    out: Dict = defaultdict(lambda: defaultdict(dict))
    for log in sorted(root.glob("*/mf*/*/train.log")):
        dataset = log.parent.name
        mf = log.parent.parent.name          # "mf5"
        setting = log.parent.parent.parent.name
        metrics = parse_train_log(log)
        if metrics is not None:
            out[mf][setting][dataset] = metrics
    return out


def build_sheets(collected) -> Dict[str, list]:
    sheets = {}
    for mf in sorted(collected, key=lambda s: int(s[2:]) if s[2:].isdigit() else 0):
        settings = collected[mf]
        datasets = sorted({d for per in settings.values() for d in per})
        header = (["setting"]
                  + [f"{d}_N@5" for d in datasets]
                  + [f"{d}_R@1" for d in datasets]
                  + ["avg_N@5", "avg_R@1"])
        rows = [header]
        for setting in sorted(settings):
            per = settings[setting]
            n5 = [per[d]["N@5"] if d in per else None for d in datasets]
            r1 = [per[d]["R@1"] if d in per else None for d in datasets]
            have_n5 = [x for x in n5 if x is not None]
            have_r1 = [x for x in r1 if x is not None]
            rows.append(
                [setting] + n5 + r1
                + [round(sum(have_n5) / len(have_n5), 2) if have_n5 else None,
                   round(sum(have_r1) / len(have_r1), 2) if have_r1 else None])
        sheets[mf] = rows
    return sheets


def build_single_exp_sheets(collected) -> Dict[str, list]:
    """Single-experiment layout (reference summary_result_1exp.py:105-135):
    one row per mf sheet — ``metric | <ds>_N@5 <ds>_R@1 ... | averages`` —
    plus a best-step row."""
    sheets = {}
    for mf in sorted(collected, key=lambda s: int(s[2:]) if s[2:].isdigit() else 0):
        per_ds: Dict[str, Dict[str, float]] = {}
        for setting in collected[mf].values():
            per_ds.update(setting)
        datasets = sorted(per_ds)
        header = ["metric"]
        for d in datasets:
            header += [f"{d}_N@5", f"{d}_R@1"]
        header += ["average_N@5", "average_R@1"]
        row = ["best_ndcg5"]
        steps = ["best_step"]
        n5s, r1s = [], []
        for d in datasets:
            m = per_ds[d]
            row += [round(m["N@5"], 1), round(m["R@1"], 1)]
            steps += [m.get("step"), None]
            n5s.append(m["N@5"])
            r1s.append(m["R@1"])
        row += [round(sum(n5s) / len(n5s), 1) if n5s else None,
                round(sum(r1s) / len(r1s), 1) if r1s else None]
        sheets[mf] = [header, row, steps]
    return sheets


def write_report(root, out_xlsx, single: bool = False) -> Dict[str, list]:
    collected = collect_results(root)
    if not collected:
        raise FileNotFoundError(f"no parseable train.log under {root}")
    sheets = build_single_exp_sheets(collected) if single else build_sheets(collected)
    write_xlsx(out_xlsx, sheets)
    out_xlsx = Path(out_xlsx)
    for mf, rows in sheets.items():
        with open(out_xlsx.with_suffix(f".{mf}.csv"), "w", newline="") as f:
            csv.writer(f).writerows(rows)
    return sheets


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("results_root")
    p.add_argument("out_xlsx")
    p.add_argument("--single", action="store_true",
                   help="single-experiment layout (summary_result_1exp.py)")
    a = p.parse_args(argv)
    sheets = write_report(a.results_root, a.out_xlsx, single=a.single)
    for mf, rows in sheets.items():
        print(f"[report] {mf}: {len(rows) - 1} settings x {len(rows[0]) - 3} columns")
    print(f"[report] -> {a.out_xlsx}")


if __name__ == "__main__":
    main()
