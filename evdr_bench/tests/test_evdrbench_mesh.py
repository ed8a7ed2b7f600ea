"""The four-card mesh cell on four CPU devices at a tiny size: its run is
``correct``, a merge that leaves a shard out is not, the int4 control is
not, its readers read nothing from nothing, and a program without block
builds fails at once."""

from __future__ import annotations

import copy
import math

import pytest

from benchcells import ROOT
from evdr_bench import calibrate_mesh, check, harness

CELL = "wikiss-int8q8-exact-4card"
# 1,100 pages pad to 1,280 on 4 shards of 320 rows: the shards' ranges
# cut across the generator's blocks of 1,024 pages, the last shard holds
# 140 pages
CONFIG = {"n_pages": 1100, "page_tokens": 24, "dim": 32}
TRAFFIC = {"batch": 8, "pool_batches": 2, "check_queries": 12}
SEED = 2**31 + 17


def tiny() -> dict:
    cell = copy.deepcopy(harness.find_cell(
        harness.load_json(ROOT / "BENCHMARK.json"), CELL))
    cell["config"].update(CONFIG)
    cell["traffic"].update(TRAFFIC)
    return cell


def _run(cell, trace=False):
    ctx = harness.Context(cell, SEED, 0.3, trace, device="cpu")
    out = harness.run_cell(ctx)
    return ctx, out, check.judge(out.numbers, cell["traffic"]["limits"])


def test_the_mesh_cell_is_correct_on_four_cpu_shards():
    cell = tiny()
    ctx, out, (ok, checks) = _run(cell)
    assert ok, checks
    assert out.attempted == out.obs["queries"] > 0 and out.failed == 0
    assert out.e2e["search_qps"] > 0 and ctx.setup_s > 0
    # queries and masks out to three devices, 8 x 10 candidates (f32 score,
    # int64 id) back from each of them, every call of the window
    b, lq, d = TRAFFIC["batch"], 32, CONFIG["dim"]
    per_call = 3 * (b * lq * d * 4 + b * lq) + 3 * b * 10 * 12
    assert out.obs["mesh_gather_bytes"] == per_call * out.obs["calls"]
    line = harness.result(ctx, out, ok, checks, {"count": 4})
    assert set(line["metrics"]) == {"setup_s", "search_qps"}


def test_a_merge_that_drops_a_shard_is_not_correct():
    cell = tiny()
    with calibrate_mesh.planted("dropped_shard"):
        _, out, (ok, checks) = _run(cell)
    assert not ok
    assert checks["rank_gap"]["value"] > 10 * checks["rank_gap"]["limit"]


def test_the_int4_control_fails_the_limits():
    cell = tiny()
    got = calibrate_mesh.control(cell, SEED, "cpu")
    limits = cell["traffic"]["limits"]
    assert any(not math.isfinite(got[n]) or got[n] > limits[n]
               for n in limits), got


def test_the_query_pool_is_what_the_whole_corpus_gives():
    """Target pages made again from their own blocks give the queries that
    ``serving.make_inputs`` draws from the whole corpus, bit for bit."""
    import torch

    from evdr_bench import serving

    cell = tiny()
    ctx = harness.Context(cell, SEED, 0.3, False, device="cpu")
    drv = harness.driver("closed_mesh")
    devs = list(drv.make_mesh(ctx).devices)
    Q, qmask = drv.make_queries(ctx, 40, devs)
    _, _, Qw, qmw = serving.make_inputs(ctx, 40)
    assert torch.equal(Q, Qw) and torch.equal(qmask, qmw)


@pytest.mark.parametrize("metric", ["mesh.overlap_pct", "mesh.merge_ms",
                                    "mesh.gather_bytes_per_query"])
def test_the_mesh_readers_read_nothing_from_nothing(metric):
    assert harness.reader(metric).read({}) is None


def test_the_readers_read_what_the_driver_observes():
    obs = {"mesh_shard_ms": 99.0, "mesh_call_ms": 100.0,
           "mesh_merge_ms": 1.5, "mesh_gather_bytes": 4960,
           "queries": 10}
    assert harness.reader("mesh.overlap_pct").read(obs) == 99.0
    assert harness.reader("mesh.merge_ms").read(obs) == 1.5
    assert harness.reader("mesh.gather_bytes_per_query").read(obs) == 496.0


def test_a_program_without_block_builds_fails_at_once(monkeypatch):
    from evdr_tpu_torch.engine import RetrievalEngine

    monkeypatch.delattr(RetrievalEngine, "build_blocks")
    ctx = harness.Context(tiny(), SEED, 0.3, False, device="cpu")
    with pytest.raises(RuntimeError, match="build_blocks"):
        harness.run_cell(ctx)
    assert ctx.marks == []
