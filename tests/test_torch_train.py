"""The torch port's single-device trainer against the JAX package's, on the
CPU.

Both packages train on the same fixture files (written by the JAX package's
``write_dataset_fixture``; the port's copy of it is checked to write the
same payloads) and draw the same batches (``index_stream`` is numpy in
both). Parity runs compare the parameter and the Adam moments of the final
checkpoint (same npz leaf layout in both packages) and every eval line of
``train.log``. Only float32 summation order differs between the two, and
AdamW's first steps move each element by about +-lr whatever the gradient's
size -> 1e-4 on the parameter.
"""

import json
import re
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from evdr_tpu.data import registry as jax_registry
from evdr_tpu.data.npz_io import load_payload as jax_load_payload
from evdr_tpu.data.synthetic import write_dataset_fixture as jax_write_fixture
from evdr_tpu.train.config import TrainConfig as JaxConfig
from evdr_tpu.train.harness import DatasetBundle as JaxBundle
from evdr_tpu.train.harness import build_train_step as jax_build_train_step
from evdr_tpu.train.harness import run_training as jax_run_training
from evdr_tpu_torch.convert import train_state_from_numpy
from evdr_tpu_torch.data import registry as torch_registry
from evdr_tpu_torch.data.npz_io import load_payload
from evdr_tpu_torch.data.synthetic import write_dataset_fixture
from evdr_tpu_torch.train import cli
from evdr_tpu_torch.train.config import TrainConfig
from evdr_tpu_torch.train.harness import (DatasetBundle, build_train_step,
                                          make_optimizer, run_training)

KEY = "torchsynth"


@pytest.fixture
def registries():
    """Snapshot and restore BOTH dataset registries around each test, so a
    fixture registered here never leaks into another test's registry."""
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


def _eval_lines(out_dir):
    lines = []
    for ln in (Path(out_dir) / "train.log").read_text().splitlines():
        if '"eval/NDCG@5"' in ln:
            lines.append(json.loads(ln[ln.index("{"):]))
    return lines


def _ckpt(out_dir):
    z = np.load(Path(out_dir) / "ckpt.npz", allow_pickle=True)
    return {k: z[k] for k in z.files if k.startswith("leaf_")}, \
        z["meta"].item()


def _assert_runs_match(jdir, tdir, atol=1e-4):
    jl, tl = _eval_lines(jdir), _eval_lines(tdir)
    assert [r["step"] for r in tl] == [r["step"] for r in jl] and jl
    for a, b in zip(jl, tl):
        assert b["eval/NDCG@5"] == a["eval/NDCG@5"]
        assert b["eval/Recall@1"] == a["eval/Recall@1"]
        np.testing.assert_allclose(b["eval/eval loss"], a["eval/eval loss"],
                                   rtol=1e-4, atol=1e-6)
    jc, jm = _ckpt(jdir)
    tc, tm = _ckpt(tdir)
    assert tm["step"] == jm["step"] and int(tc["leaf_1"]) == int(jc["leaf_1"])
    np.testing.assert_allclose(tc["leaf_0"], jc["leaf_0"], rtol=0, atol=atol)
    # the moments: mu ~ |g|, nu ~ g^2
    for leaf in ("leaf_2", "leaf_3"):
        scale = float(np.abs(jc[leaf]).max())
        np.testing.assert_allclose(tc[leaf], jc[leaf], rtol=1e-3,
                                   atol=1e-4 * scale)
    assert tm["best_nd5"] == jm["best_nd5"] and tm["best_r1"] == jm["best_r1"]


def test_fixture_writer_is_a_copy_of_the_jax_one(tmp_path, registries):
    # same seed -> the same payloads, key for key and byte for byte
    kw = dict(key=KEY, n_docs=5, n_test_queries=4, n_train_queries=7, dim=16,
              mfs=(5,), seed=3, init_noise=1.5)
    for sub in ("j", "t"):
        (tmp_path / sub).mkdir()
    stem = jax_write_fixture(tmp_path / "j", **kw)
    assert write_dataset_fixture(tmp_path / "t", **kw) == stem
    assert torch_registry.DATASETMAP[KEY] == jax_registry.DATASETMAP[KEY]
    for rel in (f"{stem}_dump_all.npz", f"{stem}_query.npz",
                f"S3E_init/mf5/{stem}.npz"):
        want = np.load(tmp_path / "j" / rel, allow_pickle=True)
        got = np.load(tmp_path / "t" / rel, allow_pickle=True)
        assert got.files == want.files
        for k in want.files:
            a, b = want[k], got[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            if a.dtype != object:
                np.testing.assert_array_equal(b, a)
            elif a.shape:
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(np.asarray(y),
                                                  np.asarray(x))
            else:  # a pickled dict (qrels, maps, meta)
                assert b.item() == a.item(), k


# --------------------------------------------------------------- one step


def _step_inputs(seed=0, n_train=16, b=6, n=9, lq=5, lp_t=40, ls=8, d=16):
    rng = np.random.default_rng(seed)

    def unit(x):
        return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)

    Q = unit(rng.normal(size=(n_train, lq, d))).astype(np.float32)
    qm = rng.random((n_train, lq)) > 0.15
    qm[:, 0] = True
    pm_t = rng.random((n, lp_t)) > 0.15
    P_t = unit(rng.normal(size=(n, lp_t, d)) * pm_t[..., None]
               + 1e-12).astype(np.float32)
    pm_s = rng.random((n, ls)) > 0.1
    Pbar = (rng.normal(size=(n, ls, d)) * pm_s[..., None]).astype(np.float32)
    pos = rng.integers(0, n, size=n_train)
    idx = rng.permutation(n_train)[:2 * b].reshape(2, b).astype(np.int32)
    return Q, qm, P_t, pm_t, Pbar, pm_s, pos, idx


@pytest.mark.parametrize("loss,k_steps", [("liscore", 1), ("spl", 1),
                                          ("infonce_sup", 1), ("liscore", 2),
                                          ("lipairscore_std", 1)])
def test_one_train_step_matches_jax(loss, k_steps):
    Q, qm, P_t, pm_t, Pbar, pm_s, pos, idx = _step_inputs()
    kw = dict(loss=loss, lr=1e-3, weight_decay=1e-2, k=4, temp=0.1,
              lambda_list=1.0, lambda_score=0.7, chunk_p=4,
              steps_per_dispatch=k_steps, debug_invariants=True)
    idx_in = idx if k_steps > 1 else idx[0]

    jcfg = JaxConfig(**kw)
    jbundle = JaxBundle(
        dataset="x", Q_train=jnp.asarray(Q), qmask_train=jnp.asarray(qm),
        pos_idx=pos, Q_test=jnp.asarray(Q), qmask_test=jnp.asarray(qm),
        P_teacher_norm=jnp.asarray(P_t), pmask_teacher=jnp.asarray(pm_t),
        docid_teacher=np.array(["d"] * P_t.shape[0], dtype=object),
        relevant_docs_test={}, docidx_2_docid_test={},
        qsidx_2_query_test=None)
    opt = optax.adamw(jcfg.lr, weight_decay=jcfg.weight_decay)
    jparam = jnp.asarray(Pbar)
    jstep = jax_build_train_step(jcfg, jbundle, jnp.asarray(pm_s), opt)
    jparam2, jstate, jparts = jstep(jparam, opt.init(jparam),
                                    jnp.asarray(idx_in), jax.random.PRNGKey(0))

    cfg = TrainConfig(**kw)
    bundle = DatasetBundle(
        dataset="x", Q_train=torch.from_numpy(Q), qmask_train=torch.from_numpy(qm),
        pos_idx=pos, Q_test=torch.from_numpy(Q), qmask_test=torch.from_numpy(qm),
        P_teacher_norm=torch.from_numpy(P_t),
        pmask_teacher=torch.from_numpy(pm_t),
        docid_teacher=np.array(["d"] * P_t.shape[0], dtype=object),
        relevant_docs_test={}, docidx_2_docid_test={},
        qsidx_2_query_test=None)
    param = torch.from_numpy(Pbar.copy()).requires_grad_(True)
    optimizer = make_optimizer(cfg, param)
    parts = build_train_step(cfg, bundle, torch.from_numpy(pm_s),
                             optimizer)(idx_in, 0)

    assert set(parts) == set(jparts)
    for k in jparts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(parts["_grad_invalid_absmax"]) == 0.0
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(jparam2),
                               rtol=1e-4, atol=2e-5)
    st = optimizer.state[param]
    adam = jstate[0]
    assert int(st["step"]) == int(adam.count) == k_steps
    np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(adam.mu),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(adam.nu),
                               rtol=1e-4, atol=1e-10)


# ------------------------------------------------------------ whole runs


PARITY_RUNS = {
    "liscore": dict(),
    "infonce_sup": dict(loss="infonce_sup", temp=0.05),
    "steps_per_dispatch": dict(steps_per_dispatch=4, print_every=0),
    "epoch_listwise": dict(trainer="epoch", epochs=4, eval_every=0,
                           loss="listwise", max_steps=0, checkpoint_every=24),
    "qnoise_zero_noise": dict(aug="qnoise", q_noise_std=0.0),
    "no_precompute": dict(precompute_teacher=False, loss="linfo"),
}


@pytest.mark.parametrize("name", sorted(PARITY_RUNS))
def test_training_run_matches_jax(fixture_root, tmp_path, name):
    """20 steps (or 4 epochs) in both packages from the same fixture and
    seed: the same batches, every eval line equal, the final parameter
    within 1e-4. (qnoise at std 0 runs the noise path's inline teacher
    scoring and re-normalization without random numbers, which the two
    packages draw differently.)"""
    kw = _kw(fixture_root, tmp_path / "j", **PARITY_RUNS[name])
    jax_run_training(JaxConfig(**kw))
    kw["out_root"] = str(tmp_path / "t")
    cfg = TrainConfig(**kw)
    res = run_training(cfg, device="cpu")
    sub = Path("t") / "mf5" / KEY
    _assert_runs_match(tmp_path / "j" / sub, tmp_path / "t" / sub)
    tconf, jconf = (json.loads((tmp_path / p / sub / "config.json")
                               .read_text()) for p in ("t", "j"))
    assert tconf.pop("out_root") != jconf.pop("out_root")
    assert tconf == jconf
    assert res[f"{KEY}/mf5"]["summary/best_ndcg5"]["step"] >= 0


def test_labeled_split_full_batch_matches_jax(fixture_root, tmp_path):
    # mainv1 family: SPL, one full-batch step per epoch, teacher + train
    # queries from the labeled train npz, eval on the test npz
    from evdr_tpu.tools.split_data import split_query_npz

    split_query_npz(fixture_root / f"{KEY}_test_dump_all.npz", fixture_root,
                    test_ratio=0.25, shuffle=True, seed=3)
    for reg in (jax_registry, torch_registry):
        reg.register_dataset(KEY + "split", f"{KEY}_test", has_split=True,
                             mfs=(5,))
    kw = _kw(fixture_root, tmp_path / "j", datasets=[KEY + "split"],
             trainer="epoch", epochs=12, eval_every=0, loss="spl",
             full_batch=True, use_labeled_split=True, max_steps=0,
             checkpoint_every=12, lr=3e-3)
    jax_run_training(JaxConfig(**kw))
    kw["out_root"] = str(tmp_path / "t")
    run_training(TrainConfig(**kw), device="cpu")
    sub = Path("t") / "mf5" / (KEY + "split")
    _assert_runs_match(tmp_path / "j" / sub, tmp_path / "t" / sub)


def test_a_jax_checkpoint_resumes_in_the_port(fixture_root, tmp_path):
    """JAX trains 10 steps and checkpoints; the port resumes from that
    ckpt.npz (train_state_from_numpy) to step 20 and lands where an
    uninterrupted 20-step JAX run does."""
    kw = _kw(fixture_root, tmp_path / "j10", max_steps=10, checkpoint_every=10)
    jax_run_training(JaxConfig(**kw))
    sub = Path("t") / "mf5" / KEY
    (tmp_path / "t" / sub).mkdir(parents=True)
    shutil.copy(tmp_path / "j10" / sub / "ckpt.npz",
                tmp_path / "t" / sub / "ckpt.npz")
    kw20 = _kw(fixture_root, tmp_path / "j20", checkpoint_every=10)
    jax_run_training(JaxConfig(**kw20))
    kw20.update(out_root=str(tmp_path / "t"), resume=True)
    run_training(TrainConfig(**kw20), device="cpu")
    jc, jm = _ckpt(tmp_path / "j20" / sub)
    tc, tm = _ckpt(tmp_path / "t" / sub)
    assert tm["step"] == jm["step"] == 20
    np.testing.assert_allclose(tc["leaf_0"], jc["leaf_0"], rtol=0, atol=1e-4)
    log = (tmp_path / "t" / sub / "train.log").read_text()
    assert '"note": "resumed", "step": 10' in log


def test_train_state_from_numpy_continues_an_optax_adamw_state():
    # two optax steps, carry (param, mu, nu, count) over, one more step in
    # both: the same parameter and moments
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(3, 4, 8)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) for _ in range(3)]
    opt = optax.adamw(1e-3, weight_decay=1e-2)
    p, s = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    for g in grads[:2]:
        u, s = opt.update(jnp.asarray(g), s, p)
        p = optax.apply_updates(p, u)
    adam = s[0]
    tp, state = train_state_from_numpy(np.asarray(p), np.asarray(adam.mu),
                                       np.asarray(adam.nu),
                                       np.asarray(adam.count), "cpu")
    assert tp.requires_grad and tp.is_leaf and float(state["step"]) == 2
    cfg = TrainConfig(lr=1e-3, weight_decay=1e-2)
    topt = make_optimizer(cfg, tp)
    sd = topt.state_dict()
    sd["state"] = {0: state}
    topt.load_state_dict(sd)
    tp.grad = torch.from_numpy(grads[2])
    topt.step()
    u, s = opt.update(jnp.asarray(grads[2]), s, p)
    p = optax.apply_updates(p, u)
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(p), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(topt.state[tp]["exp_avg_sq"].numpy(),
                               np.asarray(s[0].nu), rtol=1e-6)
    with pytest.raises(ValueError, match="moments"):
        train_state_from_numpy(p0, p0[:1], p0, 0, "cpu")


# --------------------------------------------------- entry points, refusals


def test_trainer_logs_best_npz_and_export(fixture_root, tmp_path):
    # the CLI with --device cpu: summary line, best npz readable by the
    # port's loaders, packed int8 export
    from evdr_tpu_torch.data.npz_io import load_init_payload
    from evdr_tpu_torch.tools.convert_packed import load_packed_payload

    out = tmp_path / "r"
    cli.main(["--datasets", KEY, "--query_root", str(fixture_root),
              "--teacher_root", str(fixture_root), "--init_root",
              str(fixture_root / "S3E_init"), "--mfs", "5", "--out_root",
              str(out), "--name", "c", "--max_steps", "60", "--eval_every",
              "20", "--q_batch", "8", "--chunk_p", "8", "--k", "6", "--lr",
              "3e-3", "--score_impl", "pallas", "--export_packed", "int8",
              "--save_period", "30", "--debug_invariants", "--device", "cpu"])
    d = out / "c" / "mf5" / KEY
    log = (d / "train.log").read_text()
    m = re.search(r"(\{.*\"summary/best_ndcg5\".*\})\s*$", log, re.M)
    best = json.loads(m.group(1))["summary/best_ndcg5"]
    first = _eval_lines(d)[0]
    assert best["NDCG@5"] >= first["eval/NDCG@5"]
    init = load_init_payload(d / "best_ndcg5.npz")
    assert len(init["documents"]) == 12
    assert all(np.isfinite(x).all() for x in init["documents"])
    packed = load_packed_payload(d / "best_ndcg5.packed.npz")
    assert packed["P_codes"].dtype == np.int8
    assert (d / "compressed_ep30.npz").exists()
    inv = [json.loads(ln[ln.index("{"):]) for ln in log.splitlines()
           if "debug/masked_param_absmax" in ln]
    assert inv and all(r["debug/masked_param_absmax"] == 0.0
                       and r["debug/grad_invalid_absmax"] == 0.0 for r in inv)
    assert payload_docs_equal(load_payload(d / "best_ndcg5.npz"),
                              jax_load_payload(d / "best_ndcg5.npz"))


def payload_docs_equal(a, b):
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a["documents"], b["documents"]))


def test_trainer_raises_without_a_gpu(fixture_root, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TrainConfig(**_kw(fixture_root, tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--datasets", KEY, "--query_root", str(fixture_root),
                  "--teacher_root", str(fixture_root)])
    assert not (tmp_path / "t").exists()


@pytest.mark.parametrize("setting", [
    dict(mesh_docs=2), dict(checkpoint_backend="orbax")])
def test_unported_settings_raise(fixture_root, tmp_path, setting):
    cfg = TrainConfig(**_kw(fixture_root, tmp_path, **setting))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_training(cfg, device="cpu")
    assert not (tmp_path / "t").exists()


@pytest.mark.parametrize("tier", ["int4", "pq", "opq"])
def test_export_packed_tiers_load_in_the_engine(fixture_root, tmp_path,
                                                tier):
    # export_packed int4/pq/opq goes through the ported convert_packed; the
    # file serves its codes directly in both packages' engines, and the
    # port's scores match its f32 oracle on the file's arrays (tier codes,
    # bf16 queries -> 2e-2 on sums of <= 32 unit-bounded terms)
    from evdr_tpu.engine import RetrievalEngine as JaxEngine
    from evdr_tpu.parallel.mesh import make_mesh
    from evdr_tpu_torch import RetrievalEngine
    from evdr_tpu_torch.ops.int4 import maxsim_int4
    from evdr_tpu_torch.ops.pq import maxsim_pq

    run_training(TrainConfig(**_kw(fixture_root, tmp_path, max_steps=60,
                                   eval_every=20, lr=3e-3,
                                   export_packed=tier)), device="cpu")
    path = tmp_path / "t" / "mf5" / KEY / "best_ndcg5.packed.npz"
    dtype = "int4" if tier == "int4" else "pq"
    eng = RetrievalEngine.from_npz(path, dtype=dtype, device="cpu")
    jeng = JaxEngine.from_npz(path, mesh=make_mesh(1), dtype=dtype,
                              impl="xla")
    with np.load(path) as z:
        assert bool(z["doc_normalized"])
        if tier == "int4":
            codes, pm = z["P_codes4"], z["pmask"]
            np.testing.assert_array_equal(eng.index.P[:len(codes)].numpy(),
                                          codes)
        else:
            codes, books, pm = z["P_pq_codes"], z["P_pq_books"], z["pmask"]
            assert ("P_pq_expanded" in z.files) == (tier == "opq")
            assert eng.index.books_expanded == (tier == "opq")
            np.testing.assert_array_equal(eng.index.books.numpy(), books)
        scale = z["P_scale"] if tier == "int4" else None
    assert eng.n_docs == jeng.n_docs == 12 and eng.dim == 32
    rng = np.random.default_rng(1)
    Q = rng.normal(size=(4, 6, 32)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=-1, keepdims=True)
    qm = np.ones((4, 6), bool)
    t = [torch.from_numpy(a) for a in (Q, codes, pm, qm)]
    want = (maxsim_int4(t[0], t[1], torch.from_numpy(scale), t[3], t[2])
            if tier == "int4" else
            maxsim_pq(t[0], t[1], t[3], t[2], torch.from_numpy(books)))
    np.testing.assert_allclose(eng.score_all(Q, qm), want.numpy(), atol=2e-2)
    np.testing.assert_allclose(eng.score_all(Q, qm),
                               np.asarray(jeng.score_all(Q, qm)), atol=2e-2)


def test_multihost_flags_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["--datasets", KEY, "--coordinator", "localhost:1234",
                  "--device", "cpu"])
