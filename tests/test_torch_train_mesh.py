"""Whole doc-sharded training runs of the torch port on a 4-shard CPU mesh
(``run_training(..., mesh=mesh_of(["cpu"] * 4), device="cpu")``) against
the JAX package's ``run_training`` with ``mesh_docs=4`` (its 4-device CPU
mesh) and against the port's one-device run, and mesh checkpoints that
resume.

Both packages train on the same fixture files and draw the same batches.
A mesh checkpoint keeps the JAX package's padded layout (13 docs over 4
shards: 16 rows), so a checkpoint of either package resumes in the other
at the same mesh size; a one-device checkpoint (13 rows) is zero-padded
onto the mesh. Tolerances are ``tests/test_torch_train.py``'s: float32
summation order differs, and AdamW moves each element by about +-lr a
step whatever the gradient's size, so 1e-4 on the parameter.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from evdr_tpu.data import registry as jax_registry
from evdr_tpu.data.synthetic import write_dataset_fixture as jax_write_fixture
from evdr_tpu.train.config import TrainConfig as JaxConfig
from evdr_tpu.train.harness import run_training as jax_run_training
from evdr_tpu_torch.data import registry as torch_registry
from evdr_tpu_torch.parallel import mesh_of
from evdr_tpu_torch.train.config import TrainConfig
from evdr_tpu_torch.train.harness import run_training

KEY = "torchmesh"
N_DOCS = 13


@pytest.fixture
def fixture_root(tmp_path):
    """A small dataset on disk, registered in both packages (both
    registries restored afterwards)."""
    before = [(m, {k: dict(v) for k, v in m.items()})
              for m in (jax_registry.DATASETMAP, torch_registry.DATASETMAP)]
    root = tmp_path / "data"
    root.mkdir()
    stem = jax_write_fixture(root, key=KEY, n_docs=N_DOCS, n_test_queries=10,
                             n_train_queries=48, dim=32, mfs=(5,), seed=0,
                             init_noise=2.5)
    torch_registry.register_dataset(KEY, stem, mfs=(5,))
    yield root
    for m, snap in before:
        m.clear()
        m.update(snap)


def _kw(root, out_root, name, **kw):
    base = dict(datasets=[KEY], query_root=str(root), teacher_root=str(root),
                init_root=str(root / "S3E_init"), mfs=[5],
                out_root=str(out_root), name=name, max_steps=20,
                eval_every=10, print_every=10, q_batch=8, loss="liscore",
                k=6, temp=0.1, chunk_p=8, checkpoint_every=20)
    base.update(kw)
    return base


def _out(out_root, name):
    return Path(out_root) / name / "mf5" / KEY


def _port_mesh(kw):
    return run_training(TrainConfig(mesh_docs=4, **kw), device="cpu",
                        mesh=mesh_of(["cpu"] * 4))


def _lines(out_dir, key):
    rows = {}
    for ln in (Path(out_dir) / "train.log").read_text().splitlines():
        if f'"{key}"' in ln:
            r = json.loads(ln[ln.index("{"):])
            rows[r["step"]] = r
    return rows


def _ckpt(out_dir):
    z = np.load(Path(out_dir) / "ckpt.npz", allow_pickle=True)
    return {k: z[k] for k in z.files if k.startswith("leaf_")}, \
        z["meta"].item()


def _assert_runs_match(a_dir, b_dir, steps=None):
    ea, eb = _lines(a_dir, "eval/NDCG@5"), _lines(b_dir, "eval/NDCG@5")
    steps = sorted(ea) if steps is None else steps
    assert steps and set(steps) <= set(eb), (sorted(ea), sorted(eb))
    for s in steps:
        a, b = ea[s], eb[s]
        assert b["eval/NDCG@5"] == a["eval/NDCG@5"], s
        assert b["eval/Recall@1"] == a["eval/Recall@1"], s
        np.testing.assert_allclose(b["eval/eval loss"], a["eval/eval loss"],
                                   rtol=1e-4, atol=1e-6)
    ta, tb = _lines(a_dir, "train/total loss"), _lines(b_dir,
                                                       "train/total loss")
    for s in set(ta) & set(tb) & set(range(max(steps) + 1)):
        np.testing.assert_allclose(tb[s]["train/total loss"],
                                   ta[s]["train/total loss"], rtol=1e-4)
    ca, ma = _ckpt(a_dir)
    cb, mb = _ckpt(b_dir)
    assert ma["step"] == mb["step"] and int(ca["leaf_1"]) == int(cb["leaf_1"])
    n = min(ca["leaf_0"].shape[0], cb["leaf_0"].shape[0])
    np.testing.assert_allclose(cb["leaf_0"][:n], ca["leaf_0"][:n], rtol=0,
                               atol=1e-4)
    for leaf in ("leaf_2", "leaf_3"):
        scale = float(np.abs(ca[leaf]).max())
        np.testing.assert_allclose(cb[leaf][:n], ca[leaf][:n], rtol=1e-3,
                                   atol=1e-4 * scale)
    assert ma["best_nd5"] == mb["best_nd5"] and ma["best_r1"] == mb["best_r1"]


def test_mesh_run_matches_jax_mesh_and_one_device(fixture_root, tmp_path):
    """20 steps with two evals: every eval line, the train losses and the
    final checkpoint (the padded layout, 16 rows) equal JAX's mesh run's
    and the port's one-device run's; the best artifact holds the 13 real
    docs."""
    from evdr_tpu_torch.data.npz_io import load_payload

    res = _port_mesh(_kw(fixture_root, tmp_path, "mesh"))
    assert np.isfinite(res[f"{KEY}/mf5"]["summary/best_ndcg5"]["NDCG@5"])
    jax_run_training(JaxConfig(mesh_docs=4, **_kw(fixture_root, tmp_path,
                                                  "jax")))
    run_training(TrainConfig(**_kw(fixture_root, tmp_path, "one")),
                 device="cpu")
    mesh_dir = _out(tmp_path, "mesh")
    _assert_runs_match(_out(tmp_path, "jax"), mesh_dir)
    _assert_runs_match(_out(tmp_path, "one"), mesh_dir)
    leaves, _ = _ckpt(mesh_dir)
    assert leaves["leaf_0"].shape[0] == 16 and not leaves["leaf_0"][13:].any()
    assert _ckpt(_out(tmp_path, "jax"))[0]["leaf_0"].shape[0] == 16
    best = load_payload(mesh_dir / "best_ndcg5.npz")
    assert len(best["documents"]) == N_DOCS


@pytest.mark.parametrize("source", ["port_mesh", "port_one_device",
                                    "jax_mesh"])
def test_mesh_checkpoint_resumes(fixture_root, tmp_path, source):
    """10 steps written by ``source`` with a checkpoint, then resumed on the
    port's 4-shard mesh to step 20: the resumed run's step-20 eval and
    checkpoint equal an uninterrupted 20-step mesh run's (a one-device
    checkpoint of 13 rows is zero-padded onto the 16 mesh rows)."""
    _port_mesh(_kw(fixture_root, tmp_path, "full"))
    first = _kw(fixture_root, tmp_path, "r", max_steps=10,
                checkpoint_every=10)
    if source == "port_mesh":
        _port_mesh(first)
    elif source == "port_one_device":
        run_training(TrainConfig(**first), device="cpu")
    else:
        jax_run_training(JaxConfig(mesh_docs=4, **first))
    rows = _ckpt(_out(tmp_path, "r"))[0]["leaf_0"].shape[0]
    assert rows == (N_DOCS if source == "port_one_device" else 16)
    _port_mesh(_kw(fixture_root, tmp_path, "r", resume=True))
    log = (_out(tmp_path, "r") / "train.log").read_text()
    assert '{"note": "resumed", "step": 10}' in log
    _assert_runs_match(_out(tmp_path, "full"), _out(tmp_path, "r"),
                       steps=[20])


def test_mesh_refuses_qat_pq_and_a_wrong_mesh(fixture_root, tmp_path):
    """qat pq/opq stay one-device (validate()); a mesh whose size is not
    mesh_docs is refused before anything is written."""
    with pytest.raises(ValueError, match="single-device"):
        _port_mesh(_kw(fixture_root, tmp_path, "pq", qat="pq"))
    with pytest.raises(ValueError, match="mesh_docs=4"):
        run_training(TrainConfig(mesh_docs=4,
                                 **_kw(fixture_root, tmp_path, "w")),
                     device="cpu", mesh=mesh_of(["cpu"] * 2))
    assert not (tmp_path / "pq").exists() and not (tmp_path / "w").exists()
