"""What decides ``correct``: every cell's run is correct through the
program's plain versions, comes out not correct with the timed path broken
underneath (the faults each cell can have), and the control fails the
limits. Runs skip the harness's look for a card and run at a test run's
size (``benchcells.TINY``); the training control needs TF32, so the card.
"""

from __future__ import annotations

import pytest
import torch

from benchcells import tiny
from evdr_bench import calibrate, check, harness

SERVING = ["m3doc-int8q8-exact", "m3doc-int8q8-openloop",
           "m3doc-int8q8-pruned1pct"]
TRAINING = "distill-mf5-liscore-b32"


def correct(workload: str, seed: int = 2**31 + 11) -> tuple:
    cell = tiny(workload)
    ctx = harness.Context(cell, seed, 0.3, False, device="cpu")
    out = harness.run_cell(ctx)
    return check.judge(out.numbers, cell["traffic"]["limits"])


@pytest.mark.parametrize("workload", SERVING + [TRAINING])
def test_a_sound_run_is_correct(workload):
    ok, checks = correct(workload)
    assert ok, checks


def _half_batch(search):
    def broken(self, Q, qmask, k=10, n_candidates=None):
        vals, idx = search(self, Q, qmask, k=k, n_candidates=n_candidates)
        n = vals.shape[0] // 2
        return vals[:n], idx[:n]
    return broken


def _altered_answer(search):
    def broken(self, Q, qmask, k=10, n_candidates=None):
        vals, idx = search(self, Q, qmask, k=k, n_candidates=n_candidates)
        idx = idx.copy()
        idx[:, 0] = (idx[:, 0] + 1) % self.n_docs
        return vals, idx
    return broken


@pytest.mark.parametrize("fault", [_half_batch, _altered_answer])
@pytest.mark.parametrize("workload", SERVING)
def test_a_broken_search_is_not_correct(workload, fault, monkeypatch):
    from evdr_tpu_torch.engine import RetrievalEngine

    monkeypatch.setattr(RetrievalEngine, "search_dense",
                        fault(RetrievalEngine.search_dense))
    ok, checks = correct(workload)
    assert not ok, checks


def test_a_stage_one_of_arbitrary_pages_is_not_correct():
    """Pruned search whose stage 1 picks arbitrary pages: stage 2 still
    scores them exactly, so ``top1_miss`` has to catch it."""
    with calibrate.planted("arbitrary_candidates"):
        ok, checks = correct("m3doc-int8q8-pruned1pct")
    assert not ok, checks
    assert checks["top1_miss"]["value"] > checks["top1_miss"]["limit"]


def _unchanged_state(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, *a, **k: None)


def _half_batch_step(monkeypatch):
    from evdr_tpu_torch.train import harness as th

    build = th.build_train_step

    def halved(cfg, bundle, pmask, optimizer, qat_books=None):
        run = build(cfg, bundle, pmask, optimizer, qat_books)

        def step(idx, seed):
            return run(idx[:len(idx) // 2], seed)
        return step
    monkeypatch.setattr(th, "build_train_step", halved)


def _altered_token(monkeypatch):
    from evdr_tpu_torch.train import harness as th

    plain = th.maxsim_torch

    def altered(Q, P, qmask, pmask, chunk_p=128):
        if torch.is_grad_enabled() and P.requires_grad:
            Q = Q.clone()
            Q[0, 0] = torch.roll(Q[0, 0], 1)
        return plain(Q, P, qmask, pmask, chunk_p=chunk_p)
    monkeypatch.setattr(th, "maxsim_torch", altered)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch_step,
                                   _altered_token])
def test_a_broken_training_step_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    ok, checks = correct(TRAINING)
    assert not ok, checks


@pytest.mark.parametrize("workload", SERVING)
def test_the_int4_control_fails_the_serving_limits(workload):
    cell = tiny(workload)
    numbers = calibrate.serving_control(cell, 2**31 + 13, "cpu")
    ok, checks = check.judge(numbers, cell["traffic"]["limits"])
    assert not ok, checks


@pytest.mark.gpu
def test_the_tf32_control_fails_the_training_limits_on_the_card(on_card):
    """At the cell's own size: TF32 only exists on the card."""
    cell = harness.find_cell(
        harness.load_json(harness.ROOT / "BENCHMARK.json"), TRAINING)
    for seed in (2**31 + 21, 2**31 + 22, 2**31 + 23):
        numbers = calibrate.train_readings(cell, seed, "cuda", "control")
        ok, checks = check.judge(numbers, cell["traffic"]["limits"])
        assert not ok, checks
