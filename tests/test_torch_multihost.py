"""One process per GPU in the torch port, on the CPU: two gloo processes of
two CPU shards each form a 4-shard global mesh (``parallel/multihost.py``).

Each process builds its shards from a memory-mapped packed file, reading
only the row ranges its shards own (a recording view asserts them), and
the sharded top-k and scores over int8 and PQ shards, the coordinator's
search and mutations, compact and a snapshot of bf16 shards, and ``tools/serve_http --multihost`` must answer as
the one-process engine on the same file does: ids equal and scores bit
for bit (every shard scores its rows through the same plain versions,
whose numerics on a doc do not depend on the launch's other docs).

Training (``parallel/train_sharded.py``): two processes x two CPU shards
take one sharded train step whose gradient must equal the one-device
step's (not world x it), and ``evdr_tpu_torch.train.cli`` runs as two
processes whose train.log equals a one-process 4-shard run's.

The workers are this file run as a script. Every spawned process writes
to a file (a worker blocked on a full pipe while its peer waits in a
collective would turn a failure into a silent timeout) and has its own
time limit, after which it is killed.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 120
N, LP, D, NQ, LQ, K = 203, 12, 32, 7, 5, 9


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _unit(x):
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)


def _data(seed=3):
    rng = np.random.default_rng(seed)
    P = _unit(rng.normal(size=(N, LP, D))).astype(np.float32)
    pm = rng.random((N, LP)) > 0.2
    pm[5] = False                  # a doc with no valid token
    Q = _unit(rng.normal(size=(NQ, LQ, D))).astype(np.float32)
    qm = rng.random((NQ, LQ)) > 0.2
    qm[:, 0] = True
    new = _unit(rng.normal(size=(4, LP, D))).astype(np.float32)
    return P, pm, Q, qm, new


def _one_process(path, dtype):
    from evdr_tpu_torch import RetrievalEngine

    return RetrievalEngine.from_npz(path, dtype=dtype, device="cpu",
                                    pq_m=4)


def _write_files(tmp):
    from evdr_tpu_torch import RetrievalEngine

    P, pm, _, _, _ = _data()
    ids = [f"d{i}" for i in range(N)]
    RetrievalEngine(dtype="int8", device="cpu").build(
        P, pm, docids=ids).save_npz(tmp / "int8.npz")
    RetrievalEngine(dtype="pq", pq_m=4, device="cpu").build(
        P, pm, docids=ids).save_npz(tmp / "pq.npz")
    RetrievalEngine(dtype="bfloat16", device="cpu").build(
        P, pm, docids=ids).save_npz(tmp / "bf16.npz")


def _spawn(cmds, logs, env=None):
    procs = []
    for cmd, log in zip(cmds, logs):
        procs.append(subprocess.Popen(
            cmd, stdout=open(log, "w"), stderr=subprocess.STDOUT,
            cwd=str(ROOT), env=env))
    return procs


def _wait(procs, logs, deadline):
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [Path(log).read_text(errors="replace") for log in logs]


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    return env


@pytest.mark.parametrize("world", [2, 1])
def test_gloo_processes_shard_search_and_mutate(tmp_path, world):
    """Sharded top-k and scores on int8 and PQ shards built from the rows
    each process owns, then the coordinator's search, add, delete,
    compact and snapshot, against the one-process engine: two processes
    of two shards, and one process of four shards in a group of its own
    (its gathers still run on the backend)."""
    _write_files(tmp_path)
    addr = f"localhost:{_free_port()}"
    logs = [tmp_path / f"w{i}.log" for i in range(world)]
    cmds = [[sys.executable, __file__, "worker", str(i), str(world), addr,
             str(tmp_path)] for i in range(world)]
    outs = _wait(_spawn(cmds, logs, _env()), logs,
                 time.monotonic() + SPAWN_TIMEOUT)
    for i, out in enumerate(outs):
        assert f"WORKER_OK {i}" in out, f"worker {i}:\n{out}"


def test_serve_http_multihost_answers_search_add_delete_save(tmp_path):
    """Two ``serve_http --multihost`` processes (gloo, two CPU shards
    each) over a packed int8 file: /healthz reports the mesh, and
    /search, /add, /delete and /save answer as the one-process engine
    after the same calls; SIGINT to process 0 stops both."""
    from evdr_tpu_torch.data.packing import preprocess_queries

    _write_files(tmp_path)
    P, pm, Q, qm, new = _data()
    port, addr = _free_port(), f"localhost:{_free_port()}"
    logs = [tmp_path / f"s{i}.log" for i in range(2)]
    save = tmp_path / "snap"
    save.mkdir()
    cmds = [[sys.executable, "-m", "evdr_tpu_torch.tools.serve_http",
             "--index", str(tmp_path / "int8.npz"), "--dtype", "int8",
             "--device", "cpu", "--multihost", "--coordinator", addr,
             "--num_processes", "2", "--process_id", str(i),
             "--local_shards", "2", "--port", str(port), "--warm", "1",
             "--save_dir", str(save)] for i in range(2)]
    deadline = time.monotonic() + SPAWN_TIMEOUT
    procs = _spawn(cmds, logs, _env())
    url = f"http://127.0.0.1:{port}"

    def call(path, obj=None):
        req = urllib.request.Request(
            url + path, data=None if obj is None else json.dumps(obj).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    try:
        while True:
            assert all(p.poll() is None for p in procs), _tails(logs)
            assert time.monotonic() < deadline, _tails(logs)
            try:
                health = call("/healthz")
                break
            except OSError:
                time.sleep(0.2)
        queries = [Q[i][qm[i]].tolist() for i in range(NQ)]
        got = [call("/search", {"queries": queries, "k": K})]
        added = call("/add", {"documents": [x.tolist() for x in new[:2]],
                              "docids": ["new0", "d3"]})
        deleted = call("/delete", {"docids": ["d7", "d150", "nope"]})
        got.append(call("/search", {"queries": queries, "k": K}))
        saved = call("/save", {"path": "snap.npz"})
        procs[0].send_signal(signal.SIGINT)
        outs = _wait(procs, logs, deadline)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(outs)
    assert health["mesh"] == {"shards": 4, "processes": 2,
                              "backend": "gloo"}, health
    assert added == {"added": 2, "n_docs": N + 1}, added
    assert deleted == {"deleted": 2, "n_docs": N - 1}, deleted
    assert saved["n_docs"] == N - 1, saved

    one = _one_process(tmp_path / "int8.npz", "int8")
    qobj = np.empty(NQ, dtype=object)
    qobj[:] = [np.asarray(q, np.float32) for q in queries]
    Qh, qmh = preprocess_queries(qobj, None, length_multiple=8)
    want = []
    v, i = one.search_dense(Qh, qmh, k=K)
    want.append((one.ids_for(i), v))
    one.add(new[:2], np.ones((2, LP), bool), docids=["new0", "d3"])
    one.delete(["d7", "d150", "nope"])
    v, i = one.search_dense(Qh, qmh, k=K)
    want.append((one.ids_for(i), v))
    for reply, (ids, vals) in zip(got, want):
        assert reply["docids"] == ids
        assert np.array_equal(np.asarray(reply["scores"], np.float32), vals)
    snap = _one_process(save / "snap.npz", "int8")
    v2, i2 = snap.search_dense(Qh, qmh, k=K)
    assert snap.ids_for(i2) == want[-1][0] and np.array_equal(
        v2, want[-1][1])


@pytest.mark.parametrize("loss", ["liscore", "liscore_std", "ranknet",
                                  "hardtoken"])
def test_gloo_processes_sharded_train_step_gradient(tmp_path, loss):
    """Two gloo processes x two CPU shards take one sharded train step:
    each shard's gradient (gathered) equals the one-device step's
    gradient, not world x it, for a psum consumed by the replicated loss
    (liscore), psums fed back into shard-local terms (liscore_std's means
    and variances), the (B, N) row-gather fallback (ranknet) and the
    hard-token augmentation; and the updated rows equal the one-device
    step's."""
    addr = f"localhost:{_free_port()}"
    logs = [tmp_path / f"g{i}.log" for i in range(2)]
    cmds = [[sys.executable, __file__, "train_worker", str(i), "2", addr,
             loss] for i in range(2)]
    outs = _wait(_spawn(cmds, logs, _env()), logs,
                 time.monotonic() + SPAWN_TIMEOUT)
    for i, out in enumerate(outs):
        assert f"TRAIN_STEP_OK {i}" in out, f"worker {i}:\n{out}"


def test_two_process_training_cli_matches_one_process_mesh(tmp_path):
    """``evdr_tpu_torch.train.cli`` as two gloo processes x two CPU shards
    (``--mesh_docs 4 --local_shards 2``): process 0's train.log (every
    train and eval line) and final checkpoint equal a one-process 4-shard
    run's, and the follower (its own --out_root) writes nothing."""
    from evdr_tpu_torch.data import registry
    from evdr_tpu_torch.data.synthetic import write_dataset_fixture
    from evdr_tpu_torch.parallel import mesh_of
    from evdr_tpu_torch.train.config import TrainConfig
    from evdr_tpu_torch.train.harness import run_training

    root = tmp_path / "data"
    root.mkdir()
    snap = {k: dict(v) for k, v in registry.DATASETMAP.items()}
    try:
        # stem shiftproject_test: the built-in dataset key 'shift' names
        # these files, so the CLI processes find them
        write_dataset_fixture(root, key="shiftproject", n_docs=21,
                              n_test_queries=8, n_train_queries=32, dim=32,
                              mfs=(5,), seed=0, init_noise=2.0)
    finally:
        registry.DATASETMAP.clear()
        registry.DATASETMAP.update(snap)
    flags = ["--datasets", "shift", "--loss", "liscore", "--mfs", "5",
             "--max_steps", "20", "--eval_every", "10", "--print_every", "5",
             "--q_batch", "8", "--k", "6", "--temp", "0.1", "--chunk_p", "8",
             "--query_root", str(root), "--teacher_root", str(root),
             "--init_root", str(root / "S3E_init"), "--name", "mh",
             "--mesh_docs", "4", "--checkpoint_every", "20"]
    addr = f"localhost:{_free_port()}"
    logs = [tmp_path / f"c{i}.log" for i in range(2)]
    cmds = [[sys.executable, "-m", "evdr_tpu_torch.train.cli", *flags,
             "--out_root", str(tmp_path / f"out{i}"), "--device", "cpu",
             "--coordinator", addr, "--num_processes", "2", "--process_id",
             str(i), "--dist_backend", "gloo", "--local_shards", "2"]
            for i in range(2)]
    procs = _spawn(cmds, logs, _env())
    outs = _wait(procs, logs, time.monotonic() + SPAWN_TIMEOUT)
    assert [p.returncode for p in procs] == [0, 0], "\n".join(outs)
    assert not (tmp_path / "out1").exists()

    kw = dict(datasets=["shift"], loss="liscore", mfs=[5], max_steps=20,
              eval_every=10, print_every=5, q_batch=8, k=6, temp=0.1,
              chunk_p=8, query_root=str(root), teacher_root=str(root),
              init_root=str(root / "S3E_init"), name="one",
              out_root=str(tmp_path / "out0"), mesh_docs=4,
              checkpoint_every=20)
    run_training(TrainConfig(**kw), device="cpu",
                 mesh=mesh_of(["cpu"] * 4))

    def series(name):
        d = tmp_path / "out0" / name / "mf5" / "shift"
        recs = [json.loads(ln[ln.index("{"):]) for ln in
                (d / "train.log").read_text().splitlines()
                if ln.rstrip().endswith("}") and '"step"' in ln]
        z = np.load(d / "ckpt.npz", allow_pickle=True)
        return recs, z["leaf_0"]

    (got, p_got), (want, p_want) = series("mh"), series("one")
    keys = ("train/total loss", "eval/eval loss", "eval/NDCG@5",
            "eval/Recall@1")
    got = {(r["step"], k): r[k] for r in got for k in keys if k in r}
    want = {(r["step"], k): r[k] for r in want for k in keys if k in r}
    assert set(got) == set(want) and len(want) >= 10, sorted(want)
    for key, v in want.items():
        np.testing.assert_allclose(got[key], v, rtol=1e-5, atol=1e-7,
                                   err_msg=str(key))
    np.testing.assert_allclose(p_got, p_want, rtol=0, atol=1e-5)


def _tails(logs):
    return "\n".join(Path(x).read_text(errors="replace")[-3000:]
                     for x in logs if Path(x).exists())


# ----------------------------------------------------------------- worker


class _Rows:
    """A view of a host array that records the row ranges read from it."""

    def __init__(self, x, seen):
        self.x, self.seen = x, seen
        self.shape, self.dtype, self.ndim = x.shape, x.dtype, x.ndim
        self.itemsize = x.itemsize

    def __getitem__(self, sl):
        assert isinstance(sl, slice) and sl.step is None, sl
        self.seen.append((sl.start, sl.stop))
        return self.x[sl]


def _worker(rank, world, addr, tmp):
    import torch

    from evdr_tpu_torch import RetrievalEngine
    from evdr_tpu_torch.parallel.multihost import (
        MultihostSearchCoordinator, build_multihost_index, gather_to_host,
        global_doc_mesh, init_multihost, replicate_global, shard_docs_global,
        to_replicated)
    from evdr_tpu_torch.parallel.sharded_index import (pad_index_dim,
                                                       set_books)
    from evdr_tpu_torch.parallel.topk import sharded_maxsim, sharded_topk
    from evdr_tpu_torch.tools.convert_packed import load_packed_payload

    init_multihost(addr, world, rank, "gloo")
    n_local = 4 // world
    mesh = global_doc_mesh(n_local, device="cpu")
    assert mesh.size == 4 and mesh.rank == rank and mesh.backend == "gloo"
    P, pm, Q, qm, new = _data()
    Qt, qmt = torch.from_numpy(Q), torch.from_numpy(qm)
    # 203 docs over 4 shards padded to 64: 4 x 64 rows
    mine = [(64 * c, min(64 * c + 64, N))
            for c in range(rank * n_local, (rank + 1) * n_local)]
    for dtype in ("int8", "pq"):
        pay = load_packed_payload(tmp / f"{dtype}.npz", mmap_docs=True)
        one = _one_process(tmp / f"{dtype}.npz", dtype).index
        seen = []
        if dtype == "int8":
            ix = build_multihost_index(
                _Rows(pay["P_codes"], seen), _Rows(pay["pmask"], seen),
                mesh, dtype="int8", scales=_Rows(pay["P_scale"], seen))
        else:
            ix = pad_index_dim(set_books(build_multihost_index(
                _Rows(pay["P_pq_codes"], seen), _Rows(pay["pmask"], seen),
                mesh), pay["P_pq_books"], False))
        reads = sorted(set(seen))
        assert reads == mine, (dtype, reads, mine)
        assert len(ix.parts) == n_local
        for k in (K, 100, 300):
            v1, i1 = sharded_topk(Qt, qmt, one, k, "plain")
            vm, im = sharded_topk(Qt, qmt, ix, k, "plain")
            n = min(k, N)
            assert torch.equal(i1[:, :n], im[:, :n]), (dtype, k)
            assert torch.equal(v1[:, :n], vm[:, :n]), (dtype, k)
        assert torch.equal(sharded_maxsim(Qt, qmt, one, "plain"),
                           sharded_maxsim(Qt, qmt, ix, "plain"))
        rows = gather_to_host([p.pmask for p in ix.parts], mesh,
                              chunk_bytes=4 * LP)
        assert np.array_equal(rows[:N], pm) and not rows[N:].any()
        full = to_replicated([p.pmask for p in ix.parts], mesh)
        assert np.array_equal(full.numpy(), rows)
    assert np.array_equal(replicate_global(Q, mesh).numpy(), Q)
    parts = shard_docs_global(pm, mesh)
    assert [tuple(t.shape) for t in parts] == [(51, LP)] * n_local

    eng = RetrievalEngine.from_npz(tmp / "int8.npz", mmap=True,
                                   dtype="int8", mesh=mesh)
    one = _one_process(tmp / "int8.npz", "int8")
    coord = MultihostSearchCoordinator(eng)
    ids_new = ["new0", "d3", "new2"]
    def search(e):
        v, i = e.search_dense(Q, qm, k=K)
        return e.ids_for(i), v

    if rank == 0:
        got = [search(coord)]
        assert coord.add(new[:3], np.ones((3, LP), bool),
                         docids=ids_new) == 3
        assert coord.delete(["d7", "new2", "nope"]) == 2
        got.append(search(coord))
        coord.compact()
        got.append(search(coord))
        payload = coord.to_packed_payload()
        assert len(payload["docid"]) == N
        coord.stop()
    else:
        coord.follow()
    want = [search(one)]
    one.add(new[:3], np.ones((3, LP), bool), docids=ids_new)
    one.delete(["d7", "new2", "nope"])
    want.append(search(one))
    one.compact()
    want.append(search(one))
    if rank == 0:
        for (ids, v), (wids, wv) in zip(got, want):
            assert ids == wids and np.array_equal(v, wv)
    # every process's engine followed the same mutations: a collective
    # search on all of them equals the one-process engine's
    ids, v = search(eng)
    assert ids == want[-1][0] and np.array_equal(v, want[-1][1])
    assert eng.n_docs == one.n_docs == N

    # bf16 tokens are gathered as raw bytes (gloo carries no int16, the
    # dtype of their bits): mutations, compact and a snapshot on the mesh
    bf = RetrievalEngine.from_npz(tmp / "bf16.npz", mmap=True,
                                  dtype="bfloat16", mesh=mesh)
    one = _one_process(tmp / "bf16.npz", "bfloat16")
    for e in (bf, one):
        e.add(new[:2], np.ones((2, LP), bool), docids=["new0", "d3"])
        e.delete(["d9"])
        e.compact()
    got, want = bf.to_packed_payload(), one.to_packed_payload()
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    ids, v = search(bf)
    wids, wv = search(one)
    assert ids == wids and np.array_equal(v, wv)
    print(f"WORKER_OK {rank}", flush=True)


def _train_worker(rank, world, addr, loss):
    """One sharded train step on a 2-process x 2-shard gloo mesh against
    the one-device step of the same inputs (computed here, locally)."""
    import torch

    from evdr_tpu_torch.parallel.multihost import (gather_to_host,
                                                   global_doc_mesh,
                                                   init_multihost,
                                                   shard_docs_global)
    from evdr_tpu_torch.parallel.train_sharded import (
        build_sharded_train_step)
    from evdr_tpu_torch.train.config import TrainConfig
    from evdr_tpu_torch.train.harness import (DatasetBundle,
                                              build_train_step,
                                              make_optimizer)

    init_multihost(addr, world, rank, "gloo")
    mesh = global_doc_mesh(2, device="cpu")
    rng = np.random.default_rng(9)
    n, nt, b, lq, lp, ls, d = 19, 16, 8, 5, 12, 6, 32
    Q = _unit(rng.normal(size=(nt, lq, d))).astype(np.float32)
    qm = rng.random((nt, lq)) > 0.15
    qm[:, 0] = True
    pm_t = rng.random((n, lp)) > 0.15
    P_t = _unit(rng.normal(size=(n, lp, d)) * pm_t[..., None]
                + 1e-12).astype(np.float32)
    pm_s = rng.random((n, ls)) > 0.1
    Pbar = (rng.normal(size=(n, ls, d)) * pm_s[..., None]).astype(np.float32)
    idx = rng.permutation(nt)[:b].astype(np.int32)
    aug = "hardtoken" if loss == "hardtoken" else "none"
    cfg = TrainConfig(loss="liscore" if aug != "none" else loss, aug=aug,
                      k=6, temp=0.3, lambda_list=1.0, lambda_score=0.5,
                      lr=1e-3, chunk_p=8, aux_docs=3, virt_noise_std=0.0)

    def shards(x):
        return [t.clone() for t in shard_docs_global(
            torch.from_numpy(x), mesh, n_pad=20)]

    params = [x.requires_grad_(True) for x in shards(Pbar)]
    step, _ = build_sharded_train_step(
        cfg, mesh, params=params, pmask_student=shards(pm_s),
        P_teacher=shards(P_t), pmask_teacher=shards(pm_t), n_docs=n,
        Q_all=torch.from_numpy(Q), qm_all=torch.from_numpy(qm))
    parts = step(idx, 5)
    grad = gather_to_host([p.grad for p in params], mesh)
    new = gather_to_host([p.detach() for p in params], mesh)

    tb = DatasetBundle(
        dataset="x", Q_train=torch.from_numpy(Q),
        qmask_train=torch.from_numpy(qm), pos_idx=None,
        Q_test=torch.from_numpy(Q), qmask_test=torch.from_numpy(qm),
        P_teacher_norm=torch.from_numpy(P_t),
        pmask_teacher=torch.from_numpy(pm_t),
        docid_teacher=np.array(["d"] * n, dtype=object),
        relevant_docs_test={}, docidx_2_docid_test={},
        qsidx_2_query_test=None)
    param = torch.from_numpy(Pbar.copy()).requires_grad_(True)
    want = build_train_step(cfg, tb, torch.from_numpy(pm_s),
                            make_optimizer(cfg, param))(idx, 5)
    g1 = param.grad.numpy()
    np.testing.assert_allclose(float(parts["total_loss"]),
                               float(want["total_loss"]), rtol=1e-5)
    scale = float(np.abs(g1).max())
    assert scale > 0
    np.testing.assert_allclose(grad[:n], g1, rtol=1e-4, atol=1e-5 * scale)
    assert not grad[n:].any()
    np.testing.assert_allclose(new[:n], param.detach().numpy(), rtol=0,
                               atol=2e-5)
    print(f"TRAIN_STEP_OK {rank}", flush=True)


if __name__ == "__main__" and sys.argv[1:2] == ["train_worker"]:
    sys.path.insert(0, str(ROOT))
    _train_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                  sys.argv[5])

if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    sys.path.insert(0, str(ROOT))
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
            Path(sys.argv[5]))
