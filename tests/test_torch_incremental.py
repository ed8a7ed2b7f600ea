"""Incremental serving in the torch port (``add``, ``add_ragged``,
``delete``, ``compact``, ``save_npz``, the merged main + tail top-k, the
HTTP ``/add``, ``/delete`` and ``/save``) and memory-mapped streamed
loading, against the JAX package on the CPU.

Each test follows one of ``tests/test_incremental.py`` (its multi-device
test aside): the same seeded numpy corpora go through the JAX engine
(``impl='xla'``, one device, f32 scoring) and the port's engine on
``device='cpu'`` (the kernels' plain versions). Tolerances: an
incremental port engine equals a fresh port build of the same corpus bit
for bit (bf16, int8, int4, float32: per-doc storage transforms do not
depend on the corpus, and the scorer's numerics on a doc do not depend on
its column); against the JAX engine, rankings agree tie-tolerantly within
``TOL`` (the port scores with bf16 queries: <= ~4e-3 a token similarity,
<= 6 query tokens here); PQ within ``PQ_TOL`` against the f32 decode
oracle (K3's plain version also quantizes the books to int8).
"""

import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from evdr_tpu.engine import RetrievalEngine as JaxEngine
from evdr_tpu.parallel.mesh import make_mesh
from evdr_tpu_torch import RetrievalEngine
from evdr_tpu_torch.ops import cuda_maxsim as cm
from evdr_tpu_torch.ops.maxsim import maxsim_numpy
from evdr_tpu_torch.ops.pq import decode_pq, encode_with_books

TOL = 3e-2
PQ_TOL = 5e-2


def _unit(x):
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)


def _corpus(rng, n, lp=6, d=64):
    protos = _unit(rng.normal(size=(8, d)))
    pick = rng.integers(0, 8, size=(n, lp))
    P = _unit(protos[pick] + 0.15 * rng.normal(size=(n, lp, d))).astype(
        np.float32)
    pmask = rng.random((n, lp)) > 0.15
    return P, pmask


def _queries(rng, P, pmask, nq=10, lq=4):
    src = rng.integers(0, P.shape[0], size=nq)
    Q = _unit(P[src, :lq] + 0.05 * rng.normal(size=(nq, lq, P.shape[2]))
              ).astype(np.float32)
    return Q, np.ones((nq, lq), bool)


def _pair(dtype, **kw):
    """(port engine on the CPU, JAX engine on one device), same options."""
    return (RetrievalEngine(dtype=dtype, device="cpu", **kw),
            JaxEngine(dtype=dtype, impl="xla", mesh=make_mesh(1), **kw))


def _same_ranking(eng, vals, idx, jeng, jvals, jidx, scores, tol):
    """The port's top-k against the JAX engine's, by doc id: values within
    ``tol``, and at every rank the same id or two docs whose reference
    scores (``scores``: the JAX engine's score_all) are within ``tol``."""
    np.testing.assert_allclose(vals, np.asarray(jvals), atol=tol)
    ids, jids = eng.ids_for(idx), jeng.ids_for(np.asarray(jidx))
    assert _ids_equal_or_tied(ids, jids, np.asarray(idx), np.asarray(jidx),
                             scores, tol)


def _ids_equal_or_tied(ids, jids, idx, jidx, scores, tol):
    for q in range(len(ids)):
        for r, (a, b) in enumerate(zip(ids[q], jids[q])):
            if a != b and abs(scores[q, idx[q, r]] - scores[q, jidx[q, r]]) \
                    > tol:
                return False
    return True


def _mutate(eng, P2, pm2, ids2, dead):
    eng.add(P2, pm2, docids=ids2)
    return eng.delete(dead)


# ---------------------------------------------------------------- add


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
def test_add_matches_fresh_build_exactly(rng, dtype):
    """A port engine with a tail returns exactly what a fresh port engine
    built on the concatenated corpus returns (ids and scores bit for bit),
    and ranks as the JAX engine does after the same add."""
    P1, pm1 = _corpus(rng, 30)
    P2, pm2 = _corpus(rng, 11)
    Pa, pma = np.concatenate([P1, P2]), np.concatenate([pm1, pm2])
    Q, qm = _queries(rng, Pa, pma, nq=12)
    inc, jinc = _pair(dtype)
    inc.build(P1, pm1)
    jinc.build(P1, pm1)
    assert inc.add(P2, pm2) == jinc.add(P2, pm2) == 11
    assert inc.n_docs == jinc.n_docs == 41
    assert inc.tail is None                  # built lazily, on the search
    fresh = RetrievalEngine(dtype=dtype, device="cpu").build(Pa, pma)
    vi, ii = inc.search_dense(Q, qm, k=5)
    vf, jf = fresh.search_dense(Q, qm, k=5)
    np.testing.assert_array_equal(ii, jf)
    np.testing.assert_array_equal(vi, vf)
    np.testing.assert_array_equal(inc.score_all(Q, qm),
                                  fresh.score_all(Q, qm))
    assert inc.tail.n_docs == 11 and inc.tail.n_pad == 64
    assert inc.tail.P.dtype == inc.index.P.dtype
    jv, ji = jinc.search_dense(Q, qm, k=5)
    _same_ranking(inc, vi, ii, jinc, jv, ji,
                  np.asarray(jinc.score_all(Q, qm)), TOL)


def test_add_twice_with_different_lp_and_ids(rng):
    """Sequential adds with different token counts pad into one tail;
    custom docids surface through ids_for / search, as in the JAX
    engine."""
    P1, pm1 = _corpus(rng, 20, lp=6)
    Pa, pma = _corpus(rng, 4, lp=3)
    Pb, pmb = _corpus(rng, 5, lp=9)
    out = []
    for eng in _pair("bfloat16"):
        eng.build(P1, pm1, docids=[f"m{i}" for i in range(20)])
        eng.add(Pa, pma, docids=[f"a{i}" for i in range(4)])
        eng.add(Pb, pmb, docids=[f"b{i}" for i in range(5)])
        assert eng.n_docs == 29
        ids, _ = eng.search(list(Pb[2:3, :3].copy()), k=3)
        assert ids[0][0] == "b2"
        out.append(eng)
    eng = out[0]
    assert eng.tail.pmask.shape[1] == 9       # padded to the longest Lp
    assert eng._tail_ids == [f"a{i}" for i in range(4)] + [
        f"b{i}" for i in range(5)]


def test_delete_tombstones_and_merge(rng):
    """delete() masks a doc at once (idempotent, unknown ids ignored);
    score_all gives it -inf; a tail doc deletes too; both packages return
    the same ids after the same mutations."""
    P, pm = _corpus(rng, 25)
    Q, qm = _queries(rng, P, pm, nq=8)
    eng, jeng = _pair("bfloat16")
    for e in (eng, jeng):
        e.build(P, pm)
    v0, i0 = eng.search_dense(Q, qm, k=4)
    victim = int(i0[0, 0])
    assert eng.delete([str(victim)]) == 1 == jeng.delete([str(victim)])
    assert eng.delete([str(victim), "no-such-doc"]) == 0
    assert eng.n_docs == jeng.n_docs == 24
    v1, i1 = eng.search_dense(Q, qm, k=4)
    assert victim not in set(i1.flatten().tolist())
    assert i1[0, 0] == i0[0, 1]
    sc = eng.score_all(Q, qm)
    assert np.all(np.isneginf(sc[:, victim]))
    np.testing.assert_allclose(sc[:, :25][:, np.arange(25) != victim],
                               np.asarray(jeng.score_all(Q, qm))[
                                   :, np.arange(25) != victim], atol=TOL)
    for e in (eng, jeng):
        e.add(P[:3], pm[:3], docids=["t0", "t1", "t2"])
        assert e.delete(["t1"]) == 1
    v2, i2 = eng.search_dense(Q, qm, k=6)
    assert 25 + 1 not in set(i2.flatten().tolist())
    jv2, ji2 = jeng.search_dense(Q, qm, k=6)
    _same_ranking(eng, v2, i2, jeng, jv2, ji2,
                  np.asarray(jeng.score_all(Q, qm)), TOL)
    assert eng.score_all(Q, qm).shape == (8, 28)


@pytest.mark.parametrize("d,opq", [(64, False), (64, True), (72, False),
                                   (72, True)])
def test_add_pq_and_opq_tail_scores_equal_decode_oracle(rng, d, opq):
    """PQ tails encode against the main index's books at their TRUE width
    (at D 72 the stored books are padded: compact to 8 x 10 dims, expanded
    to 80), so the tail's codes equal a host encode with the unpadded
    books; merged scores equal K3's plain version over main + tail (1e-5)
    and the f32 decode oracle within PQ_TOL; the JAX engine ranks alike."""
    P1, pm1 = _corpus(rng, 30, d=d)
    P2, pm2 = _corpus(rng, 9, d=d)
    Q, qm = _queries(rng, np.concatenate([P1, P2]),
                     np.concatenate([pm1, pm2]), nq=10)
    eng, jeng = _pair("pq", pq_opq=opq, pq_m=8)
    for e in (eng, jeng):
        e.build(P1, pm1)
        e.add(P2, pm2)
        assert e.n_docs == 39
    vals, idx = eng.search_dense(Q, qm, k=5)
    jv, ji = jeng.search_dense(Q, qm, k=5)
    books = eng._true_books().numpy()
    assert books.shape[-1] == (d if opq else d // 8)
    assert eng.index.books.shape[-1] == ((-(-d // 16) * 16) if opq
                                         else (8 if d == 64 else 10))
    np.testing.assert_array_equal(books, np.asarray(jeng.index.books))
    codes_t = eng.tail.P[:9].numpy()
    np.testing.assert_array_equal(
        codes_t, encode_with_books(P2, books, pm2))
    np.testing.assert_array_equal(codes_t, np.asarray(jeng.tail.P)[:9])
    # K3's plain version on the stored main and tail codes
    Qd = eng._queries(Q, qm)[0]
    qmt = torch.from_numpy(qm)
    plain = torch.cat([
        cm.maxsim_pq_plain(Qd, ix.P, qmt, ix.pmask, ix.books)[:, :n]
        for ix, n in ((eng.index, 30), (eng.tail, 9))], dim=1).numpy()
    order = np.argsort(-plain, axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(idx, order)
    np.testing.assert_allclose(vals, np.take_along_axis(plain, order, 1),
                               rtol=1e-5, atol=1e-5)
    rec = np.concatenate([decode_pq(eng.index.P[:30].numpy(), books,
                                    expanded=opq),
                          decode_pq(codes_t, books, expanded=opq)])
    ref = maxsim_numpy(Q, rec, qm, np.concatenate([pm1, pm2]))
    np.testing.assert_allclose(vals, np.take_along_axis(ref, idx, 1),
                               atol=PQ_TOL)
    _same_ranking(eng, vals, idx, jeng, jv, ji, ref, PQ_TOL)


def test_add_with_pruned_engine(rng):
    """Pruned engines score the tail exactly beside the pruned main
    search: added docs are found through n_candidates searches."""
    P1, pm1 = _corpus(rng, 40)
    P2, pm2 = _corpus(rng, 6)
    for eng in _pair("bfloat16", prune_centroids=2):
        eng.build(P1, pm1)
        eng.add(P2, pm2, docids=[f"new{i}" for i in range(6)])
        Q = P2[4:5, :4].copy()
        _, idx = eng.search_dense(Q, np.ones((1, 4), bool), k=3,
                                  n_candidates=8)
        assert eng.ids_for(idx)[0][0] == "new4"


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's k-means first-centre draws replaced by the JAX build's
    (as in tests/test_torch_pruned.py)."""
    import jax

    from evdr_tpu_torch.ops import batched_kmeans as km

    def draws(seed, shape, device):
        g = jax.random.gumbel(jax.random.PRNGKey(int(seed)), tuple(shape))
        return torch.from_numpy(np.array(g, np.float32)).to(device)

    monkeypatch.setattr(km, "gumbel_draws", draws)


@pytest.mark.parametrize("n_cand", [6, 40])
def test_pruned_tombstone_over_fetch_matches_jax(rng, jax_draws, monkeypatch,
                                                 n_cand):
    """With tombstones, a pruned search over-fetches k and the stage-1
    candidates by the tombstone count bucketed to 32, clamped to the main
    index's rows: both packages hand the fused pruned search the same k
    and candidate count; the merged result never holds a deleted doc and,
    with every main row a candidate, ranks as the JAX engine does."""
    import evdr_tpu.ops.pruned as jpr
    from evdr_tpu_torch.ops import pruned

    P1, pm1 = _corpus(rng, 40)
    P2, pm2 = _corpus(rng, 7)
    Q, qm = _queries(rng, np.concatenate([P1, P2]),
                     np.concatenate([pm1, pm2]), nq=8)
    calls = {"port": [], "jax": []}

    def spy(mod, key):
        real = mod.pruned_topk_fused

        def wrapped(*a, **kw):
            calls[key].append((kw["k"], kw["n_cand"]))
            return real(*a, **kw)

        monkeypatch.setattr(mod, "pruned_topk_fused", wrapped)

    spy(pruned, "port")
    spy(jpr, "jax")
    dead = ["m3", "m17", "t2"]
    engines = _pair(None, prune_centroids=2)
    for eng in engines:
        eng.build(P1, pm1, docids=[f"m{i}" for i in range(40)])
        _mutate(eng, P2, pm2, [f"t{i}" for i in range(7)], dead)
    (eng, jeng) = engines
    v, i = eng.search_dense(Q, qm, k=5, n_candidates=n_cand)
    jv, ji = jeng.search_dense(Q, qm, k=5, n_candidates=n_cand)
    assert calls["port"] == calls["jax"] == [(min(32, 40),
                                              min(n_cand + 32, 40))]
    ids = eng.ids_for(i)
    assert not set(dead) & {x for row in ids for x in row}
    assert i.shape == (8, 5)
    if n_cand + 32 >= 40:
        # full cover: the exact f32 rerank and the tail's exact top-k
        scores = np.asarray(jeng.score_all(Q, qm))
        _same_ranking(eng, v, i, jeng, jv, ji, scores, TOL)


def test_add_existing_docid_is_upsert(rng):
    """Re-adding a live docid supersedes the old row: searches return the
    new content under that id, delete() removes it completely, and the doc
    count never double-counts."""
    P, pm = _corpus(rng, 10, d=32)
    newP, newpm = _corpus(rng, 1, d=32)
    for eng in _pair("bfloat16"):
        eng.build(P, pm, docids=[f"d{i}" for i in range(10)])
        assert eng.add(newP, newpm, docids=["d3"]) == 1
        assert eng.n_docs == 10 and eng._tombstones == {3}
        ids, _ = eng.search(list(newP[0:1, :3]), k=3)
        assert ids[0][0] == "d3"
        ids_old, _ = eng.search(list(P[3:4, :3]), k=10)
        assert ids_old[0].count("d3") <= 1
        assert eng.delete(["d3"]) == 1
        assert eng.n_docs == 9
        ids2, _ = eng.search(list(newP[0:1, :3]), k=9)
        assert "d3" not in ids2[0]


def test_add_keeps_the_docid_map_current(rng):
    """add() is O(batch): it extends the cached docid -> row map in place
    (an upserted id moves to its new tail row) instead of dropping it, so
    no later add or delete rebuilds the map over the whole corpus; the
    map equals one rebuilt from scratch."""
    P, pm = _corpus(rng, 10, d=32)
    eng = RetrievalEngine(dtype="bfloat16", device="cpu").build(
        P, pm, docids=[f"d{i}" for i in range(10)])
    assert eng.delete([]) == 0
    lut = eng._docid_lut_cache
    assert lut is not None and lut["d9"] == 9
    eng.add(P[:2], pm[:2], docids=["x0", "d4"])
    eng.add(P[2:4], pm[2:4])
    assert eng._docid_lut_cache is lut
    assert lut["x0"] == 10 and lut["d4"] == 11 and eng._tombstones == {4}
    assert eng.delete(["x0", eng._tail_ids[-1]]) == 2
    assert eng._docid_lut_cache is lut
    eng._docid_lut_cache = None
    assert eng._docid_lut() == lut
    assert eng.n_docs == 11


def test_auto_ids_never_collide_after_compact(rng):
    """Positional ids survive compaction's renumbering, so auto ids start
    past the largest live numeric id: the same id as the JAX engine's."""
    P, pm = _corpus(rng, 12)
    new_ids = []
    for eng in _pair("bfloat16"):
        eng.build(P, pm)
        eng.delete(["0", "5"])
        eng.compact()
        eng.add(P[:1], pm[:1])
        new_id = eng._tail_ids[0]
        live = {str(i) for row in eng.ids_for(np.arange(10)[:, None])
                for i in row}
        assert new_id not in live
        assert eng.delete([new_id]) == 1
        assert eng.n_docs == 10
        new_ids.append(new_id)
    assert new_ids[0] == new_ids[1] == "12"


def test_compact_failure_restores_state(rng, monkeypatch):
    """A failed compact leaves the engine exactly as it was: tombstones
    still masking, the tail still serving, the same results."""
    P, pm = _corpus(rng, 15)
    eng = RetrievalEngine(dtype="bfloat16", device="cpu").build(P, pm)
    eng.add(P[:2], pm[:2], docids=["x0", "x1"])
    eng.delete(["3"])
    Q, qm = _queries(rng, P, pm, nq=5)
    v0, i0 = eng.search_dense(Q, qm, k=4)
    index, tail, alive = eng.index, eng.tail, eng._alive

    def boom(*a, **kw):
        raise RuntimeError("synthetic rebuild failure")

    monkeypatch.setattr(eng, "_compact_build", boom)
    with pytest.raises(RuntimeError, match="synthetic"):
        eng.compact()
    assert eng.index is index and eng.tail is tail and eng._alive is alive
    assert eng._tombstones == {3} and eng._tail_ids == ["x0", "x1"]
    assert eng.n_docs == 16
    v1, i1 = eng.search_dense(Q, qm, k=4)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_array_equal(v1, v0)


def test_delete_does_not_rebuild_the_tail(rng):
    """The counterpart of the JAX engine's no-recompile test: deletes only
    change the device alive mask (rebuilt once per change, not per
    search); the tail index is built once per burst of adds."""
    P, pm = _corpus(rng, 30)
    eng = RetrievalEngine(dtype="bfloat16", device="cpu").build(P, pm)
    Q, qm = _queries(rng, P, pm, nq=4)
    eng.add(P[:2], pm[:2], docids=["a", "b"])
    eng.add(P[2:3], pm[2:3], docids=["c"])
    eng.delete(["1"])
    eng.search_dense(Q, qm, k=3)
    tail, alive = eng.tail, eng._alive
    assert alive.shape == (33,) and not bool(alive[1]) and int(
        alive.sum()) == 32
    eng.search_dense(Q, qm, k=3)
    assert eng._alive is alive                  # no change, no rebuild
    for d in ("2", "7", "b"):
        eng.delete([d])
        _, idx = eng.search_dense(Q, qm, k=3)
        assert eng.tail is tail and not eng._tail_dirty
        assert eng._alive is not alive
        alive = eng._alive
    assert not alive[[1, 2, 7, 31]].any() and int(alive.sum()) == 29
    eng.delete(["no-such-doc"])
    eng.search_dense(Q, qm, k=3)
    assert eng._alive is alive


TIERS = [("bfloat16", {}), ("float32", {}), ("int8", {}), ("int4", {}),
         ("pq", {}), ("pq", {"pq_opq": True})]


def _tier_id(t):
    return t[0] + ("+opq" if t[1] else "")


@pytest.mark.parametrize("tier", TIERS[:1] + TIERS[2:], ids=_tier_id)
def test_compact_preserves_results_and_ids(rng, tier):
    """compact() folds the tail and drops tombstones: searches return the
    same (id, score) results as before, on every tier, including int4's
    odd-Lp repack (main Lp 5, tail Lp 8); compacting again is a no-op."""
    dtype, kw = tier
    P1, pm1 = _corpus(rng, 24, lp=5)
    P2, pm2 = _corpus(rng, 7, lp=8)
    Q, qm = _queries(rng, P1, pm1, nq=9)
    eng = RetrievalEngine(dtype=dtype, device="cpu", pq_m=8, **kw)
    eng.build(P1, pm1, docids=[f"m{i}" for i in range(24)])
    _mutate(eng, P2, pm2, [f"t{i}" for i in range(7)], ["m3", "t2"])
    v0, i0 = eng.search_dense(Q, qm, k=6)
    ids0 = eng.ids_for(i0)
    assert eng.tail is not None and eng._tombstones
    eng.compact()
    assert eng.tail is None and not eng._tombstones and eng._alive is None
    assert eng.n_docs == 29 and eng.index.n_docs == 29
    v1, i1 = eng.search_dense(Q, qm, k=6)
    assert eng.ids_for(i1) == ids0
    np.testing.assert_allclose(v1, v0, rtol=1e-4, atol=1e-4)
    assert eng.compact() is eng


def test_compact_positional_ids_survive(rng):
    """An index built without docids hands out positional ids; compaction
    renumbers rows but keeps returning the original ids."""
    P, pm = _corpus(rng, 12)
    Q, qm = _queries(rng, P, pm, nq=6)
    eng = RetrievalEngine(dtype="bfloat16", device="cpu").build(P, pm)
    eng.delete(["0", "5"])
    ids0 = eng.ids_for(eng.search_dense(Q, qm, k=4)[1])
    eng.compact()
    ids1 = eng.ids_for(eng.search_dense(Q, qm, k=4)[1])
    assert ids1 == ids0
    assert "0" not in {i for row in ids1 for i in row}
    assert list(eng.index.docids[:3]) == ["1", "2", "3"]


@pytest.mark.parametrize("dtype", ["int8", "pq"])
def test_compact_rebuilds_pruning_summaries(rng, dtype):
    """Pruned engines keep n_candidates working after compaction: the
    summaries are rebuilt from the stored rows (dequantized int8, decoded
    PQ) over the compacted corpus."""
    P1, pm1 = _corpus(rng, 40)
    P2, pm2 = _corpus(rng, 6)
    eng = RetrievalEngine(dtype=dtype, prune_centroids=2, pq_m=8,
                          device="cpu").build(P1, pm1)
    eng.add(P2, pm2, docids=[f"n{i}" for i in range(6)])
    eng.delete(["7"])
    old = eng.summary
    eng.compact()
    assert eng.summary is not old and eng.summary.n_docs == 45
    _, idx = eng.search_dense(P2[1:2, :4].copy(), np.ones((1, 4), bool),
                              k=3, n_candidates=10)
    assert eng.ids_for(idx)[0][0] == "n1"


# ----------------------------------------------------------- save / load


def _saved_pair(rng, tmp_path, tier):
    """The same corpus and mutations in both packages, each saved."""
    dtype, kw = tier
    P1, pm1 = _corpus(rng, 22, lp=5)
    P2, pm2 = _corpus(rng, 6, lp=8)
    Q, qm = _queries(rng, P1, pm1, nq=8)
    kw = dict(kw, pq_m=8)
    eng, jeng = _pair(dtype, **kw)
    for e, tag in ((eng, "port"), (jeng, "jax")):
        e.build(P1, pm1, docids=[f"m{i}" for i in range(22)])
        _mutate(e, P2, pm2, [f"t{i}" for i in range(6)], ["m2", "t5"])
        e.save_npz(tmp_path / f"{tag}.npz")
    return eng, jeng, kw, Q, qm


@pytest.mark.parametrize("tier", TIERS, ids=_tier_id)
def test_save_npz_roundtrips_every_tier_across_packages(rng, tmp_path, tier):
    """save_npz writes the current corpus (tail merged, tombstones
    dropped): the port's file holds the JAX engine's bytes, from_npz (eager
    and mmap) reproduces the engine's results id for id, and a file saved
    by either package serves identical rankings in the other."""
    from evdr_tpu_torch.tools.convert_packed import load_packed_payload

    dtype, _ = tier
    eng, jeng, kw, Q, qm = _saved_pair(rng, tmp_path, tier)
    mine = load_packed_payload(tmp_path / "port.npz")
    theirs = load_packed_payload(tmp_path / "jax.npz")
    assert sorted(mine) == sorted(theirs)
    for key in mine:
        np.testing.assert_array_equal(mine[key], theirs[key], err_msg=key)
    v0, i0 = eng.search_dense(Q, qm, k=5)
    ids0 = eng.ids_for(i0)
    loaded = {}
    for tag in ("port", "jax"):
        for mmap in (False, True):
            e2 = RetrievalEngine.from_npz(tmp_path / f"{tag}.npz", mmap=mmap,
                                          dtype=dtype, device="cpu", **kw)
            assert e2.n_docs == 26 and e2.tail is None
            v1, i1 = e2.search_dense(Q, qm, k=5)
            assert e2.ids_for(i1) == ids0, (tag, mmap)
            np.testing.assert_array_equal(v1, v0)
        j2 = JaxEngine.from_npz(tmp_path / f"{tag}.npz", dtype=dtype,
                                impl="xla", mesh=make_mesh(1), **kw)
        jv, ji = j2.search_dense(Q, qm, k=5)
        loaded[tag] = (np.asarray(jv), j2.ids_for(np.asarray(ji)))
    np.testing.assert_array_equal(loaded["port"][0], loaded["jax"][0])
    assert loaded["port"][1] == loaded["jax"][1]
    jv0, ji0 = jeng.search_dense(Q, qm, k=5)
    assert loaded["jax"][1] == jeng.ids_for(np.asarray(ji0))


def test_pq_pruned_engine_roundtrips_through_save(rng, tmp_path):
    """The PLAID combination (pq + prune_centroids) saves and reloads:
    from_npz rebuilds the summaries from the decoded codes, and the
    full-cover pruned search gives the same result."""
    P, pm = _corpus(rng, 30, d=64)
    Q, qm = _queries(rng, P, pm, nq=6)
    eng = RetrievalEngine(dtype="pq", prune_centroids=2, device="cpu"
                          ).build(P, pm)
    v0, i0 = eng.search_dense(Q, qm, k=4, n_candidates=30)
    eng.save_npz(tmp_path / "plaid.npz")
    eng2 = RetrievalEngine.from_npz(tmp_path / "plaid.npz", dtype="pq",
                                    prune_centroids=2, device="cpu")
    assert eng2.summary is not None
    v1, i1 = eng2.search_dense(Q, qm, k=4, n_candidates=30)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_allclose(v1, v0, rtol=2e-4, atol=2e-4)


def test_save_is_atomic_on_failure(rng, tmp_path, monkeypatch):
    """write_packed_npz writes a temporary file and renames it: a failed
    write leaves neither a partial file nor the temporary behind."""
    P, pm = _corpus(rng, 8, d=32)
    eng = RetrievalEngine(dtype="int8", device="cpu").build(P, pm)

    def fail(path, **kw):
        open(path, "wb").write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", fail)
    with pytest.raises(OSError, match="disk full"):
        eng.save_npz(tmp_path / "x.npz")
    assert list(tmp_path.iterdir()) == []


# -------------------------------------------------------------- HTTP


def _serve(eng, **kw):
    from evdr_tpu_torch.tools.serve_http import make_server

    srv = make_server(eng, port=0, **kw)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv, th, f"http://127.0.0.1:{srv.server_address[1]}"


def _stop(srv, th):
    srv.shutdown()
    srv.server_close()
    th.join(timeout=10)
    assert not th.is_alive()


def _post(url, obj, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_add_and_delete_endpoints(rng):
    P, pm = _corpus(rng, 15, d=32)
    eng = RetrievalEngine(dtype="float32", device="cpu").build(
        P, pm, docids=[f"d{i}" for i in range(15)])
    srv, th, base = _serve(eng)
    try:
        new_doc = _unit(rng.normal(size=(4, 32))).astype(np.float32)
        code, res = _post(base + "/add", {"documents": [new_doc.tolist()],
                                          "docids": ["added0"]})
        assert (code, res) == (200, {"added": 1, "n_docs": 16})
        search = {"queries": [new_doc.tolist()], "k": 2}
        code, sres = _post(base + "/search", search)
        assert code == 200 and sres["docids"][0][0] == "added0"
        code, dres = _post(base + "/delete", {"docids": ["added0"]})
        assert (code, dres) == (200, {"deleted": 1, "n_docs": 15})
        code, sres2 = _post(base + "/search", search)
        assert code == 200 and sres2["docids"][0][0] != "added0"
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["n_docs"] == 15
        # a malformed add is a 400 and changes nothing
        code, _ = _post(base + "/add", {"documents": [[[0.5] * 7]]})
        assert code == 400 and eng.n_docs == 15
    finally:
        _stop(srv, th)


def test_http_save_endpoint(rng, tmp_path):
    """POST /save writes only *.npz files directly under --save_dir; other
    paths are refused (400), and without the flag the endpoint is off
    (403). The saved file reloads in both packages."""
    P, pm = _corpus(rng, 10, d=32)
    eng = RetrievalEngine(dtype="int8", device="cpu").build(P, pm)
    srv, th, base = _serve(eng, save_dir=tmp_path)
    try:
        _post(base + "/add", {"documents": [P[0].tolist()],
                              "docids": ["extra"]})
        _post(base + "/delete", {"docids": ["4"]})
        code, res = _post(base + "/save", {"path": "snap.npz"})
        assert code == 200 and res == {"saved": str(tmp_path / "snap.npz"),
                                       "n_docs": 10}
        for bad in ("../evil.npz", "/etc/evil.npz", "sub/nested.npz",
                    "snap.txt"):
            assert _post(base + "/save", {"path": bad})[0] == 400, bad
    finally:
        _stop(srv, th)
    e2 = RetrievalEngine.from_npz(tmp_path / "snap.npz", dtype="int8",
                                  device="cpu")
    j2 = JaxEngine.from_npz(tmp_path / "snap.npz", dtype="int8", impl="xla",
                            mesh=make_mesh(1))
    assert e2.n_docs == j2.n_docs == 10
    assert list(e2.index.docids) == [str(i) for i in range(10) if i != 4] + [
        "extra"]
    srv2, th2, base2 = _serve(eng)
    try:
        assert _post(base2 + "/save", {"path": "x.npz"})[0] == 403
    finally:
        _stop(srv2, th2)


def test_add_rejects_malformed_batch_and_engine_stays_usable(rng):
    """A wrong-dim or wrong-shape add() raises at add() time, mutating
    nothing: the lazy tail is never poisoned."""
    d = 32
    P1, pm1 = _corpus(rng, 12, d=d)
    eng = RetrievalEngine(dtype="float32", device="cpu").build(P1, pm1)
    Q, qm = _queries(rng, P1, pm1, nq=4)
    _, ok_idx = eng.search_dense(Q, qm, k=3)
    with pytest.raises(ValueError, match="add\\(\\) embeddings"):
        eng.add(rng.normal(size=(2, 5, d // 2)).astype(np.float32),
                np.ones((2, 5), bool))
    with pytest.raises(ValueError, match="add\\(\\) embeddings"):
        eng.add(rng.normal(size=(2, 5 * d)).astype(np.float32),
                np.ones((2, 5), bool))
    with pytest.raises(ValueError, match="pmask shape"):
        eng.add(rng.normal(size=(2, 5, d)).astype(np.float32),
                np.ones((2, 4), bool))
    with pytest.raises(ValueError, match="duplicate docids"):
        eng.add(rng.normal(size=(2, 5, d)).astype(np.float32),
                np.ones((2, 5), bool), docids=["x", "x"])
    assert eng.n_docs == 12 and not eng._tail_parts and not eng._tail_dirty
    np.testing.assert_array_equal(ok_idx, eng.search_dense(Q, qm, k=3)[1])
    P2, pm2 = _corpus(rng, 3, d=d)
    assert eng.add(torch.from_numpy(P2), torch.from_numpy(pm2)) == 3
    eng.search_dense(Q, qm, k=3)
    assert eng.n_docs == 15


def test_concurrent_search_add_delete_stress(rng):
    """Interleaved searches, adds and deletes from 8 threads (a short
    switch interval) through the server's lock: no deadlock (each thread
    joins within 60 s of a 90 s budget), no error reply, and the final
    state is exactly initial + adds - deletes."""
    P, pm = _corpus(rng, 20, d=32)
    eng = RetrievalEngine(dtype="bfloat16", device="cpu").build(
        P, pm, docids=[f"base{i}" for i in range(20)])
    srv, th, base = _serve(eng, batch_wait_ms=2.0)
    errors = []

    def worker(wid):
        try:
            wrng = np.random.default_rng(wid)
            for op in range(6):
                roll = wrng.random()
                if roll < 0.5:
                    q = _unit(wrng.normal(size=(3, 32))).astype(np.float32)
                    code, res = _post(base + "/search",
                                      {"queries": [q.tolist()], "k": 3}, 30)
                    assert code == 200 and len(res["docids"][0]) == 3
                elif roll < 0.8:
                    d = _unit(wrng.normal(size=(4, 32))).astype(np.float32)
                    code, _ = _post(base + "/add", {
                        "documents": [d.tolist()],
                        "docids": [f"w{wid}_{op}"]}, 30)
                    assert code == 200
                else:
                    code, _ = _post(base + "/delete", {"docids": [
                        f"base{int(wrng.integers(5))}"]}, 30)
                    assert code == 200
        except Exception as e:  # noqa: BLE001
            errors.append(f"w{wid}: {type(e).__name__}: {e}")

    deadline = time.monotonic() + 90
    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(8)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)      # interleave the threads finely
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=max(0.0, min(60.0, deadline - time.monotonic())))
            assert not t.is_alive(), "stress worker deadlocked"
        assert not errors, errors
        assert eng.n_docs == 20 + len(eng._tail_ids) - len(eng._tombstones)
        assert eng._tombstones <= set(range(5))
        ids, _ = eng.search(list(P[10:11, :3].copy()), k=5)
        assert len(ids[0]) == 5 and ids[0][0] == "base10"
    finally:
        sys.setswitchinterval(switch)
        _stop(srv, th)
