"""Whole training runs of the port with QAT, mixup and hardtoken against
the JAX trainer, on the CPU.

As in ``test_torch_train.py``: both packages train on the same fixture
files (written by the JAX package's ``write_dataset_fixture``) and draw the
same batches; every eval line of ``train.log`` must match (NDCG@5 and
Recall@1 exactly, the eval loss within 1e-4) and the final parameter within
1e-4 (float32 summation order is all that differs). Mixup and hardtoken
runs hand the port the JAX run's per-step random draws (one key a step from
the JAX ``PRNGSequence``), as ``scripts/golden_parity.py`` does for the
reference. QAT-pq/opq codebooks are refit at every eval on the student of
that moment: the two runs' students differ by summation order, so the
exported ``qat_books`` agree within 1e-4, and are bit-equal to the books
the JAX package fits on the port's exported student.
"""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evdr_tpu.data import registry as jax_registry
from evdr_tpu.data.packing import l2_normalize as jax_l2_normalize
from evdr_tpu.data.synthetic import write_dataset_fixture as jax_write_fixture
from evdr_tpu.train.config import TrainConfig as JaxConfig
from evdr_tpu.train.harness import _fit_qat_books as jax_fit_qat_books
from evdr_tpu.train.harness import run_training as jax_run_training
from evdr_tpu.utils.prng import PRNGSequence as JaxPRNG
from evdr_tpu_torch import RetrievalEngine
from evdr_tpu_torch.data import registry as torch_registry
from evdr_tpu_torch.data.npz_io import load_payload
from evdr_tpu_torch.data.packing import preprocess_docs
from evdr_tpu_torch.train import cli, harness
from evdr_tpu_torch.train.config import TrainConfig
from evdr_tpu_torch.train.harness import run_training
from evdr_tpu_torch.utils.prng import PRNGSequence as TorchPRNG

KEY = "torchsynthq"


@pytest.fixture
def registries():
    """Snapshot and restore BOTH dataset registries around each test."""
    before = [(m, {k: dict(v) for k, v in m.items()})
              for m in (jax_registry.DATASETMAP, torch_registry.DATASETMAP)]
    yield
    for m, snap in before:
        m.clear()
        m.update(snap)


@pytest.fixture
def fixture_root(tmp_path, registries):
    """A small dataset on disk, registered in both packages."""
    root = tmp_path / "data"
    root.mkdir()
    stem = jax_write_fixture(root, key=KEY, n_docs=12, n_test_queries=10,
                             n_train_queries=48, dim=32, mfs=(5,), seed=0,
                             init_noise=2.5)
    torch_registry.register_dataset(KEY, stem, mfs=(5,))
    return root


def _kw(root, out_root, **kw):
    base = dict(datasets=[KEY], query_root=str(root), teacher_root=str(root),
                init_root=str(root / "S3E_init"), mfs=[5],
                out_root=str(out_root), name="t", max_steps=20, eval_every=10,
                print_every=10, q_batch=8, loss="liscore", k=6, temp=0.1,
                chunk_p=8, checkpoint_every=20)
    base.update(kw)
    return base


def _log_lines(out_dir, key):
    return [json.loads(ln[ln.index("{"):])
            for ln in (Path(out_dir) / "train.log").read_text().splitlines()
            if f'"{key}' in ln]


def _ckpt(out_dir, name="ckpt.npz"):
    z = np.load(Path(out_dir) / name, allow_pickle=True)
    return {k: z[k] for k in z.files if k.startswith("leaf_")}, \
        z["meta"].item()


def _inject_jax_draws(monkeypatch, seed, n_steps=64):
    """The port's per-step draws replaced by the JAX run's. Step i of the
    JAX run draws from the i-th key of its PRNGSequence(seed), split for
    mixup (lambda, permutation) or whole for the hard-token noise; the
    port's step i seeds its generator with the i-th seed of its own
    PRNGSequence(seed), which maps it to that key."""
    tseq, jseq = TorchPRNG(seed), JaxPRNG(seed)
    keys = {tseq.next(): jseq.next() for _ in range(n_steps)}

    def fake_mixup(alpha, n_docs, host_rng, gen):
        k_lam, k_perm = jax.random.split(keys[gen.initial_seed()])
        lam = np.asarray(jax.random.beta(k_lam, alpha, alpha))
        perm = np.array(jax.random.permutation(k_perm, n_docs))
        return (torch.tensor(lam, dtype=torch.float32),
                torch.from_numpy(perm).long())

    def fake_noise(shape, gen):
        return torch.from_numpy(np.array(jax.random.normal(
            keys[gen.initial_seed()], tuple(shape), jnp.float32)))

    monkeypatch.setattr(harness, "mixup_draws", fake_mixup)
    monkeypatch.setattr(harness, "virtual_query_noise", fake_noise)


def _assert_runs_match(jdir, tdir):
    jl, tl = _log_lines(jdir, "eval/NDCG@5"), _log_lines(tdir, "eval/NDCG@5")
    assert [r["step"] for r in tl] == [r["step"] for r in jl] and jl
    for a, b in zip(jl, tl):
        assert b["eval/NDCG@5"] == a["eval/NDCG@5"]
        assert b["eval/Recall@1"] == a["eval/Recall@1"]
        np.testing.assert_allclose(b["eval/eval loss"], a["eval/eval loss"],
                                   rtol=1e-4, atol=1e-6)
    jc, jm = _ckpt(jdir)
    tc, tm = _ckpt(tdir)
    assert tm["step"] == jm["step"]
    np.testing.assert_allclose(tc["leaf_0"], jc["leaf_0"], rtol=0, atol=1e-4)
    assert tm["best_nd5"] == jm["best_nd5"] and tm["best_r1"] == jm["best_r1"]


RUNS = {
    "qat_int8": dict(qat="int8"),
    "qat_int4_start_half": dict(qat="int4", qat_start_frac=0.5),
    "qat_int4_select_all": dict(qat="int4", qat_start_frac=0.5,
                                qat_select_post=False),
    "qat_pq": dict(qat="pq", qat_pq_m=4, lr=3e-3),
    "qat_opq_start_half": dict(qat="opq", qat_pq_m=4, qat_start_frac=0.5,
                               lr=3e-3),
    "mixup": dict(aug="mixup", mixup_alpha=0.4),
    "hardtoken": dict(aug="hardtoken", gap_log_every=10, gap_topk=4),
    "hardtoken_qat_int8": dict(aug="hardtoken", virt_noise_std=0.0,
                               qat="int8", gap_log_every=5),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_training_run_matches_jax(fixture_root, tmp_path, monkeypatch, name):
    kw = _kw(fixture_root, tmp_path / "j", **RUNS[name])
    jax_run_training(JaxConfig(**kw))
    _inject_jax_draws(monkeypatch, JaxConfig(**kw).seed)
    kw["out_root"] = str(tmp_path / "t")
    run_training(TrainConfig(**kw), device="cpu")
    sub = Path("t") / "mf5" / KEY
    jdir, tdir = tmp_path / "j" / sub, tmp_path / "t" / sub
    _assert_runs_match(jdir, tdir)
    # the hard-token rank-gap diagnostics: the same lines, integers equal
    jg, tg = _log_lines(jdir, "gaplog/"), _log_lines(tdir, "gaplog/")
    assert tg == jg
    assert bool(tg) == (RUNS[name].get("aug") == "hardtoken")
    notes = [r for r in _log_lines(tdir, "note") if "qat_start_frac" in r]
    assert bool(notes) == (RUNS[name].get("qat_start_frac", 0) > 0
                           and RUNS[name].get("qat_select_post", True))


def test_qat_switch_runs_the_plain_step_first(fixture_root, tmp_path):
    """qat_start_frac 0.5 of 20 steps: up to the switch at step 10 the
    trajectory is the qat='none' run's, bit for bit (the phase-1 step), and
    it differs after it; with the selection window, no best checkpoint
    before it."""
    params = {}
    for name, extra in (("none", {}),
                        ("half", dict(qat="int8", qat_start_frac=0.5))):
        kw = _kw(fixture_root, tmp_path / name, save_period=10, **extra)
        run_training(TrainConfig(**kw), device="cpu")
        d = tmp_path / name / "t" / "mf5" / KEY
        params[name] = [load_payload(d / f"compressed_ep{s}.npz")["documents"]
                        for s in (10, 20)]
        if name == "half":
            best = _ckpt(d)[1]["best_nd5"]
    for a, b in zip(params["none"][0], params["half"][0]):
        np.testing.assert_array_equal(a, b)
    assert not all(np.array_equal(a, b) for a, b in zip(params["none"][1],
                                                        params["half"][1]))
    assert best["step"] == 20


@pytest.mark.parametrize("tier", ["pq", "opq"])
def test_qat_books_export_with_the_best_npz(fixture_root, tmp_path, tier):
    """The best npz carries the codebooks its student was evaluated on:
    within 1e-4 of the JAX run's, bit-equal to the JAX package's fit on the
    port's exported student, and they serve through from_npz."""
    kw = _kw(fixture_root, tmp_path / "j", qat=tier, qat_pq_m=4, lr=3e-3,
             max_steps=40, checkpoint_every=40)
    jax_run_training(JaxConfig(**kw))
    kw["out_root"] = str(tmp_path / "t")
    run_training(TrainConfig(**kw), device="cpu")
    sub = Path("t") / "mf5" / KEY
    jz = np.load(tmp_path / "j" / sub / "best_ndcg5.npz", allow_pickle=True)
    tz = np.load(tmp_path / "t" / sub / "best_ndcg5.npz", allow_pickle=True)
    assert tz["meta"].item()["step"] == jz["meta"].item()["step"] > 0
    books = tz["qat_books"]
    assert books.dtype == np.float32 and books.shape == jz["qat_books"].shape
    np.testing.assert_allclose(books, jz["qat_books"], rtol=0, atol=1e-4)
    payload = load_payload(tmp_path / "t" / sub / "best_ndcg5.npz")
    P, pm, _ = preprocess_docs(payload["documents"], payload["doc_attnmask"],
                               payload["doc_imgmask"])
    Ps = np.asarray(jax_l2_normalize(jnp.asarray(P * pm[..., None])))
    want = np.asarray(jax_fit_qat_books(JaxConfig(**kw), Ps, pm))
    got_jfit = harness._fit_qat_books(TrainConfig(**kw), Ps, pm)
    np.testing.assert_array_equal(got_jfit, want)
    # ... and the port refits its own student to exactly the exported books
    Pt = torch.from_numpy(P * pm[..., None])
    refit = harness._fit_qat_books(
        TrainConfig(**kw), Pt / (torch.linalg.vector_norm(
            Pt, dim=-1, keepdim=True) + 1e-12), torch.from_numpy(pm))
    np.testing.assert_array_equal(refit, books)
    eng = RetrievalEngine.from_npz(tmp_path / "t" / sub / "best_ndcg5.npz",
                                   dtype="pq", device="cpu")
    np.testing.assert_array_equal(eng.index.books.numpy(), books)
    assert eng.index.books_expanded == (tier == "opq")


def test_cli_trains_hardtoken_with_qat_and_exports(fixture_root, tmp_path):
    """The CLI with --aug hardtoken --qat int4 and --aug mixup --qat pq
    (switch at half, selection window) on the CPU: the summary line; the
    first run's best NDCG@5 at least the step-0 value; the second's best npz
    from the window, with its codebooks, and the packed export."""
    for aug, extra in (("hardtoken", ["--qat", "int4"]),
                       ("mixup", ["--qat", "pq", "--qat_pq_m", "4",
                                  "--qat_start_frac", "0.5",
                                  "--export_packed", "pq"])):
        out = tmp_path / aug
        cli.main(["--datasets", KEY, "--query_root", str(fixture_root),
                  "--teacher_root", str(fixture_root), "--init_root",
                  str(fixture_root / "S3E_init"), "--mfs", "5", "--out_root",
                  str(out), "--name", "c", "--max_steps", "40",
                  "--eval_every", "20", "--q_batch", "8", "--chunk_p", "8",
                  "--k", "6", "--lr", "3e-3", "--aug", aug, "--device",
                  "cpu", *extra])
        d = out / "c" / "mf5" / KEY
        log = (d / "train.log").read_text()
        m = re.search(r"(\{.*\"summary/best_ndcg5\".*\})\s*$", log, re.M)
        best = json.loads(m.group(1))["summary/best_ndcg5"]
        first = _log_lines(d, "eval/NDCG@5")[0]
        if aug == "hardtoken":
            assert best["NDCG@5"] >= first["eval/NDCG@5"]
        else:
            assert best["step"] == 40
            assert "qat_books" in np.load(d / "best_ndcg5.npz",
                                          allow_pickle=True).files
            assert (d / "best_ndcg5.packed.npz").exists()
