"""The harness: files found by name, the contract's shape of BENCHMARK.json
and of the result line, the frozen cost function, the reference against a
brute-force MaxSim, the trace reduction, and the import rule."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchcells import ROOT, tiny
from evdr_bench import cost, gen, harness, reference, trace

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_finds_its_files_by_name(workload):
    cell = harness.find_cell(BENCH, workload)
    assert cell["config"]["name"] == cell["workload"]["config"]
    drv = harness.driver(cell["traffic"]["driver"])
    assert callable(drv.run)
    assert cell["per_layer"], "every cell reports a per-layer metric"
    names = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    for m in cell["per_layer"]:
        assert m["moves"] in names
        assert harness.reader(m["name"]).read({}) is None


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["evdr_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("evdr_bench/")
        assert harness.load_json(ROOT / c["file"])["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_cost_function_matches_a_hand_count():
    Q = torch.zeros((2, 3, 16))
    qmask = torch.tensor([[1, 1, 0], [1, 0, 0]], dtype=torch.bool)
    P = torch.zeros((4, 5, 16), dtype=torch.int8)
    pmask = torch.ones((4, 5), dtype=torch.bool)
    pmask[0, :2] = False
    scales = torch.zeros((4, 5))
    # valid pairs: 3 query tokens x 18 page tokens, 2 * 16 operations each
    assert cost.valid_ops(qmask, pmask, 16) == 2 * 16 * 3 * 18
    nbytes = 2 * 3 * 16 * 4 + 6 + 4 * 5 * 16 + 20 + 4 * 5 * 4 + 2 * 4 * 4
    ms, by = cost.maxsim_bound_ms(Q, qmask, P, pmask, scales, "int8")
    want = max(nbytes / cost.HBM_BYTES_PER_S,
               2 * 16 * 3 * 18 / cost.PEAK_OPS["int8"]) * 1e3
    assert ms == pytest.approx(want) and by == "bytes"


def _brute(Q, qmask, P, pmask, levels, rerank):
    """MaxSim by loops over numpy arrays."""
    def quant(x):
        s = np.abs(x).max(-1) / levels
        c = np.where(s[..., None] > 0,
                     np.clip(np.rint(x / np.where(s > 0, s, 1)[..., None]),
                             -levels, levels), 0)
        return c, s

    qc, qs = quant(Q)
    pc, ps = quant(P)
    out = np.zeros((Q.shape[0], P.shape[0]))
    for i in range(Q.shape[0]):
        for j in range(P.shape[0]):
            if not pmask[j].any():
                out[i, j] = -np.inf if rerank else 0.0
                continue
            tot = 0.0
            for t in range(Q.shape[1]):
                if rerank:
                    sims = (pc[j] * ps[j][:, None]) @ Q[i, t]
                    best = np.where(pmask[j], sims, -1e4).max()
                    tot += best * qmask[i, t]
                else:
                    sims = (pc[j] @ qc[i, t]) * ps[j]
                    best = sims[pmask[j]].max()
                    tot += best * qmask[i, t] * qs[i, t]
            out[i, j] = tot
    return out


@pytest.mark.parametrize("kind", ["quantized", "rerank"])
@pytest.mark.parametrize("levels", [127, 7])
def test_reference_matches_a_brute_force_maxsim(kind, levels):
    g = torch.Generator().manual_seed(3)
    Q = gen.unit(torch.randn((3, 4, 16), generator=g))
    P = gen.unit(torch.randn((5, 6, 16), generator=g))
    qmask = torch.rand((3, 4), generator=g) > 0.3
    pmask = torch.rand((5, 6), generator=g) > 0.3
    pmask[2] = False
    got = reference.corpus_scores(lambda: iter([(P, pmask)]), Q, qmask,
                                  kind, levels)
    want = _brute(Q.double().numpy(), qmask.numpy(), P.double().numpy(),
                  pmask.numpy(), levels, kind == "rerank")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_page_blocks_are_made_again_bit_for_bit_and_pool_as_array_split():
    cfg = tiny("distill-mf5-liscore-b32")["config"]
    P, pmask = gen.make_pages(cfg, 2**31 + 5, "cpu")
    Pb, mb = gen.page_block(cfg, 2**31 + 5, 0, "cpu")
    assert torch.equal(P[:Pb.shape[0]], Pb) and torch.equal(pmask, mb)
    pooled, live = gen.pooled_init(P, pmask, 5)
    for i in (0, 7):
        toks = P[i][pmask[i]].numpy()
        want = [c.mean(0) for c in np.array_split(toks, len(toks) // 5)]
        np.testing.assert_allclose(pooled[i][live[i]].numpy(), want,
                                   rtol=1e-5, atol=1e-6)


def test_trace_summary_merges_busy_time_and_names_idle_gaps():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_SPAN,
           "ts": 0, "dur": 1000},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 100, "dur": 200},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 250, "dur": 100},
          {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 900,
           "dur": 200},
          {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 360,
           "dur": 500}]
    s = trace.summarize(ev)
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(350e-6)
    assert s.kernels == 2
    assert s.idle_gaps[0] == ("aten::sort", pytest.approx(550e-6))
    assert s.device_ops[0] == ("k1", pytest.approx(200e-6))


def test_result_line_has_the_contract_keys():
    cell = tiny("m3doc-int8q8-exact")
    ctx = harness.Context(cell, 2**31 + 9, 0.2, False, device="cpu")
    out = harness.run_cell(ctx)
    from evdr_bench import check

    ok, checks = check.judge(out.numbers, cell["traffic"]["limits"])
    dev = {"platform": "gpu", "kind": "x", "count": 1,
           "memory_peak_bytes": 1}
    line = harness.result(ctx, out, ok, checks, dev)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"setup_s", "search_qps"}
    ctx.trace = True
    ctx.traces = [trace.TraceSummary(1.0, 0.5, 3, [("k", 0.5)],
                                     [("host", 0.5)])]
    out.obs.update(maxsim_ms=2.0, maxsim_bound_ms=1.0)
    line = harness.result(ctx, out, ok, checks, dev)
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert set(line["metrics"]) == {"maxsim_roofline",
                                    "device.idle_pct.serve"}
    assert line["device"]["busy_s"] == 0.5
    json.loads(json.dumps(line))


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(
        ["evdr_tpu_torch.engine", "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(
        ["evdr_tpu.ops", "jax.numpy", "flax"]) == ["evdr_tpu", "flax", "jax"]


def test_nothing_the_benchmark_runs_imports_jax():
    code = (
        "import sys; sys.path.insert(0, '.');"
        "from evdr_bench import harness, calibrate, sweep, run;"
        "bench = harness.load_json(harness.ROOT / 'BENCHMARK.json');"
        "[harness.driver(harness.find_cell(bench, w['name'])['traffic']"
        "['driver']) for w in bench['workloads']];"
        "[harness.reader(m['name']) for m in bench['per_layer']];"
        "import evdr_tpu_torch.engine, evdr_tpu_torch.train.harness,"
        " evdr_tpu_torch.tools.serve_http;"
        "print(harness.forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_exits_nonzero_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would measure")
    out = subprocess.run(
        [sys.executable, "evdr_bench/run.py", "--workload",
         "m3doc-int8q8-exact", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
