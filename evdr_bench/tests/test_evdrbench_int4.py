"""The one-card int4 Wiki-SS cell on the CPU at a tiny size: its run is
``correct`` against the int4-by-int8 reference, the reference at other
levels in the program's place is not (pages at +-3 or +-127, queries at
+-7), a program that cannot build int4 from blocks fails at once, and its
readers read nothing from nothing."""

from __future__ import annotations

import copy

import pytest
import torch

from benchcells import ROOT
from evdr_bench import check, harness, reference, reference_int4q8

CELL = "wikiss-int4q8-exact-1card"
# 1,100 pages: the build's blocks of 1,024 rows meet the generator's
# blocks of 1,024 pages, the last of 76; an odd Lp packs a pad nibble
CONFIG = {"n_pages": 1100, "page_tokens": 25, "dim": 32}
TRAFFIC = {"batch": 8, "pool_batches": 2, "check_queries": 12}
SEED = 2**31 + 19


def tiny() -> dict:
    cell = copy.deepcopy(harness.find_cell(
        harness.load_json(ROOT / "BENCHMARK.json"), CELL))
    cell["config"].update(CONFIG)
    cell["traffic"].update(TRAFFIC)
    return cell


def test_the_int4_cell_is_correct_on_the_cpu():
    cell = tiny()
    ctx = harness.Context(cell, SEED, 0.3, False, device="cpu")
    out = harness.run_cell(ctx)
    ok, checks = check.judge(out.numbers, cell["traffic"]["limits"])
    assert ok, checks
    assert out.attempted == out.obs["queries"] > 0 and out.failed == 0
    assert out.e2e["search_qps"] > 0 and ctx.setup_s > 0
    # the plain path launches no kernel, so it covers no index bytes
    assert out.obs["index_bytes_read"] == 0
    assert out.obs["check_s"] > 0
    line = harness.result(ctx, out, ok, checks, {"count": 1})
    assert set(line["metrics"]) == {"setup_s", "search_qps"}


@pytest.mark.parametrize("kind", sorted(harness.driver("closed_blocks")
                                        .CONTROLS))
def test_each_control_fails_the_limits_threefold(kind):
    cell = tiny()
    got = harness.driver("closed_blocks").control(cell, SEED, "cpu", kind)
    limits = cell["traffic"]["limits"]
    assert any(got[n] > 3 * limits[n] for n in limits), got


def test_the_reference_is_the_one_level_reference_at_equal_levels():
    """At one level for queries and pages it is ``reference.py``'s."""
    g = torch.Generator().manual_seed(5)
    Q = torch.randn((3, 4, 16), generator=g)
    P = torch.randn((7, 5, 16), generator=g)
    qmask = torch.rand((3, 4), generator=g) > 0.3
    pmask = torch.rand((7, 5), generator=g) > 0.3
    pmask[2] = False
    for levels in (7, 127):
        want = reference.corpus_scores(lambda: iter([(P, pmask)]), Q, qmask,
                                       "quantized", levels)
        got = reference_int4q8.corpus_scores(lambda: iter([(P, pmask)]), Q,
                                             qmask, levels, levels)
        assert torch.equal(got, want)


def _parent_build_blocks(self, source, n_docs, docids=None, normalize=None):
    raise ValueError("build_blocks takes float32, bfloat16 and int8 "
                     "engines without pruning")


@pytest.mark.parametrize("parent", ["refuses_int4", "no_block_builds"])
def test_a_program_without_int4_block_builds_fails_at_once(parent,
                                                           monkeypatch):
    from evdr_tpu_torch.engine import RetrievalEngine

    if parent == "refuses_int4":
        monkeypatch.setattr(RetrievalEngine, "build_blocks",
                            _parent_build_blocks)
        match = "dtype 'int4' from blocks"
    else:
        monkeypatch.delattr(RetrievalEngine, "build_blocks")
        match = "build_blocks"
    ctx = harness.Context(tiny(), SEED, 0.3, False, device="cpu")
    with pytest.raises(RuntimeError, match=match):
        harness.run_cell(ctx)
    assert ctx.marks == []


@pytest.mark.parametrize("metric", ["maxsim_int4_roofline",
                                    "maxsim.index_bytes_per_query"])
def test_the_int4_readers_read_nothing_from_nothing(metric):
    assert harness.reader(metric).read({}) is None


def test_the_int4_readers_read_what_the_cell_observes():
    obs = {"maxsim_ms": 740.0, "maxsim_bound_ms": 100.0,
           "index_bytes_read": 3 * 68_900_000_000, "queries": 96}
    assert harness.reader("maxsim_int4_roofline").read(obs) == \
        pytest.approx(100.0 * 100.0 / 740.0)
    assert harness.reader("maxsim.index_bytes_per_query").read(obs) == \
        3 * 68_900_000_000 / 96
