#!/usr/bin/env python3
"""Write variant roots of K6 (``csrc/maxsim_train.cu``) and of K5 bf16
(``csrc/maxsim_bf16.cu``) for ``scripts/torch_kernel_ab.py``: copies of
``evdr_tpu_torch/`` with one design choice changed or one stage removed.

    python3 scripts/k6_variants.py OUT_DIR [NAME ...]

writes ``OUT_DIR/NAME/evdr_tpu_torch`` for each NAME (default: all), each
a root to hand to ``torch_kernel_ab.py``. A variant whose anchor text is
missing from the source raises: the variants follow the source.

- ``no_cluster``: clusters of one CTA (``bwd_cluster`` returns 1): each
  query block brings its own page tiles and writes its own dP partial,
  summed on the host (the sparse gradients alone).
- ``pull4`` / ``pull16``: the dP pull's loads for 4 or 16 hits (8 where D
  > 128) issued together (shipped: one hit at a time, ``kPull = 1``).
- ``step1`` / ``step2``: one or two page tiles a cluster barrier
  (``kStep``; shipped: 4).
- ``stages4``: a ring of at most 4 page-tile stages (shipped: as many as
  fit, up to 8).
- ``no_pull`` / ``no_walk`` / ``no_recompute``: the dP pull, the dQ walk or
  the recompute (and so every hit) left out, to split the time; their
  outputs are wrong on purpose.
- ``no_hits``: the recompute runs but finds no hit (every row's M read as
  NaN), so the dQ walk and the pull have nothing to do: against
  ``no_recompute``, the recompute's own time. Wrong on purpose.
- ``k5_tile128``: K5 bf16 on 128-token page tiles (shipped: 64, the width
  K6 recomputes; this root's K6 no longer recomputes K5's products, so
  time only its K5).
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CU = "csrc/maxsim_train.cu"
BF = "csrc/maxsim_bf16.cu"
PY = "ops/cuda_maxsim_train.py"
VARIANTS = {
    "no_cluster": [(PY, "    while c < n_qb:\n", "    while c < 1:\n")],
    "step1": [(CU, "constexpr int kStep = 4;", "constexpr int kStep = 1;")],
    "step2": [(CU, "constexpr int kStep = 4;", "constexpr int kStep = 2;")],
    "pull4": [(CU, "constexpr int kPull = 1;", "constexpr int kPull = 4;")],
    "pull16": [(CU, "constexpr int kPull = 1;",
                "constexpr int kPull = NCH <= 2 ? 16 : 8;")],
    "stages4": [(CU, "constexpr int kBwdStages = 8;",
                 "constexpr int kBwdStages = 4;")],
    "no_pull": [(CU, "    for (int i0 = 0; i0 < n_items; i0 += 2) {\n",
                 "    for (int i0 = 0; i0 < 0; i0 += 2) {\n")],
    "no_walk": [(CU, "      if (bits != 0) {\n        const float e = erow",
                 "      if (false) {\n        const float e = erow")],
    "no_recompute": [(CU, "ntok, nrows > 0, warp, lane);",
                      "ntok, false, warp, lane);"),
                     (CU, "        if (nrows > 0) {\n          TAcc acc",
                      "        if (false) {\n          TAcc acc")],
    "no_hits": [(CU, "          cur_w != 0.f ? cur_m : __int_as_float(0x7fffffff);",
                 "          __int_as_float(0x7fffffff);")],
    "k5_tile128": [(BF, "constexpr int kTrainTileN = 64;",
                    "constexpr int kTrainTileN = 128;")],
}


def write(out: Path, name: str) -> Path:
    dst = out / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "evdr_tpu_torch", dst / "evdr_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in VARIANTS[name]:
        f = dst / "evdr_tpu_torch" / rel
        text = f.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: anchor not found once in {rel}")
        f.write_text(text.replace(old, new))
    return dst


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = Path(argv[0])
    for name in argv[1:] or list(VARIANTS):
        print(write(out, name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
