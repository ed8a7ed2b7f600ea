"""JSON-line training logger, format-compatible with the reference reporter
(a copy of ``evdr_tpu/utils/logging_utils.py``).

The reference writes ``[timestamp][LEVEL] json`` lines to ``<out>/train.log``
plus TensorBoard scalars (``utils/utils.py:28-75``); its Excel reporter regex
greps the last ``summary/best_ndcg5`` JSON line (``summary_results.py:35``).
We keep that exact line format so the reference's reporter parses our logs,
and add a machine-readable ``scalars.jsonl`` (TensorBoard event files are
written too when the tensorboard package is importable).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict, Optional


class ScalarWriter:
    """Scalar metric writer: JSONL always; TensorBoard when available."""

    def __init__(self, log_dir: Path, use_tb: bool = True):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "scalars.jsonl", "a", encoding="utf-8")
        self._tb = None
        if use_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=str(self.log_dir))
            except ImportError:
                self._tb = None

    def add_scalar(self, key: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps({"step": int(step), key: float(value)}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(key, float(value), int(step))

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


# one ScalarWriter per directory: repeated get_logger calls on the same
# out_dir (e.g. a resume) must not open a fresh scalars.jsonl append handle
# each time — log handlers are already dedup-guarded, this mirrors that
_WRITERS: Dict[str, ScalarWriter] = {}


def get_logger(save_dir, name: str = "run", verbosity: int = 1, use_tb: bool = True):
    """File+stream logger writing ``train.log`` in the reference line format.

    Returns (logger, ScalarWriter). ``use_tb=False`` only skips the (heavy)
    TensorBoard event writer — the machine-readable scalars.jsonl is always
    written, as ScalarWriter promises.
    """
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)

    level = {0: logging.DEBUG, 1: logging.INFO, 2: logging.WARNING}.get(
        verbosity, logging.INFO
    )
    logger = logging.getLogger(f"{name}@{save_dir}")
    logger.setLevel(level)
    logger.propagate = False
    if not logger.handlers:
        fmt = logging.Formatter("[%(asctime)s][%(levelname)s] %(message)s")
        fh = logging.FileHandler(save_dir / "train.log", mode="a")
        fh.setFormatter(fmt)
        fh.setLevel(level)
        logger.addHandler(fh)
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        sh.setLevel(level)
        logger.addHandler(sh)

    wkey = str(save_dir.resolve())
    writer = _WRITERS.get(wkey)
    if writer is None or writer._jsonl.closed:
        writer = ScalarWriter(save_dir, use_tb=use_tb)
        _WRITERS[wkey] = writer
    elif use_tb and writer._tb is None:
        # a later caller asking for TensorBoard must not silently inherit a
        # cached tb-less writer; upgrade it in place (the jsonl handle and
        # dedup guarantee are preserved)
        try:
            from torch.utils.tensorboard import SummaryWriter

            writer._tb = SummaryWriter(log_dir=str(writer.log_dir))
        except ImportError:
            pass
    return logger, writer


def log_json(logger, obj: Dict[str, Any]) -> None:
    logger.info(json.dumps(obj, ensure_ascii=False))


def log_dict(logger, writer: Optional[ScalarWriter], scalars: Dict[str, Any],
             step: int) -> None:
    logger.info(json.dumps({"step": step, **scalars}, ensure_ascii=False))
    if writer is not None:
        for k, v in scalars.items():
            if isinstance(v, (int, float)):
                writer.add_scalar(k, v, step)
        writer.flush()
