"""ViDoRe dataset registry: dataset key -> feature-npz filenames (a copy of
``evdr_tpu/data/registry.py`` with its own ``DATASETMAP``).

Mirrors the reference registry (``utils/mapping.py:1-92``) but is generated
from the underlying naming convention instead of spelled out: every dataset has
``split_before`` (full dump) and ``pseudoQ`` (ProxyQ query features) entries,
mf{5,10,25,50} init-index entries, and — for the five datasets with labeled
query splits — ``train``/``test`` entries.
"""

from __future__ import annotations

from typing import Dict

MF_FACTORS = (5, 10, 25, 50)

# dataset key -> (file stem, has labeled train/test split)
_DATASETS = {
    "arxiv": ("arxivqa_test_subsampled", True),
    "docvqa": ("docvqa_test_subsampled", True),
    "infovqa": ("infovqa_test_subsampled", True),
    "tabfquad": ("tabfquad_test_subsampled", True),
    "tatdqa": ("tatdqa_test", True),
    "shift": ("shiftproject_test", False),
    "ai": ("syntheticDocQA_artificial_intelligence_test", False),
    "energy": ("syntheticDocQA_energy_test", False),
    "gov": ("syntheticDocQA_government_reports_test", False),
    "health": ("syntheticDocQA_healthcare_industry_test", False),
}


def _entry(stem: str, has_split: bool, mfs=MF_FACTORS) -> Dict[str, str]:
    e = {f"mf{mf}": f"mf{mf}/{stem}.npz" for mf in mfs}
    e["split_before"] = f"{stem}_dump_all.npz"
    e["pseudoQ"] = f"{stem}_query.npz"
    if has_split:
        e["train"] = f"{stem}_train.npz"
        e["test"] = f"{stem}_test.npz"
    return e


DATASETMAP: Dict[str, Dict[str, str]] = {
    key: _entry(stem, has_split) for key, (stem, has_split) in _DATASETS.items()
}


def register_dataset(key: str, stem: str, has_split: bool = False,
                     mfs=MF_FACTORS) -> Dict[str, str]:
    """Register an additional dataset (synthetic fixtures, new corpora)."""
    entry = _entry(stem, has_split, mfs)
    DATASETMAP[key] = entry
    return entry
