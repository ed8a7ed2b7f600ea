"""Doc-sharded serving in the torch port against the JAX package, on the CPU.

The port runs a 4-shard mesh and a 2 x 2 (dp x docs) mesh of repeated CPU
devices (``parallel/mesh.mesh_of``); the JAX package runs ``make_mesh(4)``
and ``make_mesh_2d(2, 4)`` on the 8 virtual CPU devices of
``tests/conftest.py`` with ``impl='xla'``. The same seeded numpy corpora go
through both.

Tolerances: the port's mesh equals its own one-shard engine bit for bit
(ids and scores: every shard scores its rows through the same plain
versions, whose numerics on a doc do not depend on the launch's other
docs, and the merge is an exact stable sort). Against the JAX package the
ids are equal at every rank whose reference scores are untied by more
than ``TOL`` and the scores agree within ``TOL`` (the port's plain
versions score with bf16 queries and pages: <= ~4e-3 a token similarity
here), ``PQ_TOL`` for PQ (K3's plain version also quantizes the books to
int8), and ``RERANK_TOL`` for pruned search at full cover (both packages
rerank in f32).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from evdr_tpu.engine import RetrievalEngine as JaxEngine
from evdr_tpu.parallel import build_sharded_index as jax_build
from evdr_tpu.parallel import replicate
from evdr_tpu.parallel import sharded_maxsim as jax_maxsim
from evdr_tpu.parallel import sharded_topk as jax_topk
from evdr_tpu.parallel.mesh import make_mesh as jax_mesh
from evdr_tpu.parallel.mesh import make_mesh_2d as jax_mesh_2d
from evdr_tpu_torch import RetrievalEngine
from evdr_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d, mesh_of
from evdr_tpu_torch.parallel.sharded_index import build_sharded_index
from evdr_tpu_torch.parallel.topk import sharded_maxsim, sharded_topk

TOL = 3e-2
PQ_TOL = 5e-2
RERANK_TOL = 1e-5
N, LP, D, NQ, LQ = 203, 10, 32, 8, 5
MESHES = {"4": (lambda: mesh_of(["cpu"] * 4), lambda: jax_mesh(4)),
          "2x2": (lambda: mesh_of(["cpu"] * 4, dp=2),
                  lambda: jax_mesh_2d(2, 4))}


def _unit(x):
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)


def _corpus(seed=0, n=N):
    """Clustered unit pages, ~15% masked tokens, doc 5 with no valid token
    and doc 64 (the first row of shard 1 on every mesh here: 203 docs pad
    to 256, 64 a shard) an exact copy of doc 63 (the last row of shard
    0); queries planted on docs, the first two on doc 63."""
    rng = np.random.default_rng(seed)
    protos = _unit(rng.normal(size=(12, D)))
    P = _unit(protos[rng.integers(0, 12, (n, LP))]
              + 0.3 * rng.normal(size=(n, LP, D))).astype(np.float32)
    pm = rng.random((n, LP)) > 0.15
    pm[:, 0] = True
    pm[5] = False
    P[64], pm[64] = P[63], pm[63]
    src = np.r_[63, 63, rng.integers(0, n, NQ - 2)]
    Q = _unit(P[src, :LQ] + 0.05 * rng.normal(size=(NQ, LQ, D))).astype(
        np.float32)
    qm = np.ones((NQ, LQ), bool)
    qm[:, -1] = rng.random(NQ) > 0.5
    return P, pm, Q, qm


def _ranked_alike(ids, vals, jids, jvals, ref, idx, jidx, tol):
    """Scores within ``tol``; at every rank the same id, or two docs whose
    reference scores (``ref``, (nq, N)) are within ``tol``."""
    np.testing.assert_allclose(vals, jvals, atol=tol)
    for q in range(len(ids)):
        for r, (a, b) in enumerate(zip(ids[q], jids[q])):
            assert a == b or abs(ref[q, idx[q, r]] - ref[q, jidx[q, r]]) \
                <= tol, (q, r, a, b)


def _bit_equal(a, b):
    (va, ia), (vb, ib) = a, b
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(va, vb)


# ---------------------------------------------------------------- meshes


def test_mesh_constructors_and_errors():
    m = mesh_of(["cpu"] * 4, dp=2)
    assert m.shape == (2, 2) and m.dp == 2 and m.n_doc_shards == 2
    assert m.local_shards() == [(0, 0, torch.device("cpu")),
                                (0, 1, torch.device("cpu")),
                                (1, 0, torch.device("cpu")),
                                (1, 1, torch.device("cpu"))]
    assert make_mesh(device="cpu").size == 1
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        make_mesh_2d(2, 2, device="cpu")
    with pytest.raises(ValueError, match="do not split"):
        mesh_of(["cpu"] * 3, dp=2)


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("dtype", [None, "bfloat16", "int8", "int4"])
def test_sharded_layout_is_the_jax_layout(mesh_kind, dtype):
    """The shards are the JAX package's: the doc axis padded to a multiple
    of n_shards x 64, contiguous shards, padding at the end; the rows,
    masks and scales of both packages' shards are equal."""
    P, pm, _, _ = _corpus()
    mk, jmk = MESHES[mesh_kind]
    mesh, jm = mk(), jmk()
    ix = build_sharded_index(P, pm, mesh, dtype=dtype)
    jx = jax_build(P, pm, jm, dtype=dtype, pad_docs_to=64)
    assert ix.n_pad == jx.n_pad == 256 and ix.n_docs == jx.n_docs == N
    d = mesh.n_doc_shards
    parts = ix.parts[:d]
    assert [p.n_docs for p in parts] == ([64, 64, 64, 11] if d == 4
                                         else [128, 75])
    got_P = torch.cat([p.P for p in parts])
    want_P = np.asarray(jx.P)
    if dtype == "bfloat16":
        got_P = got_P.view(torch.int16)
        want_P = want_P.view(np.int16)
    np.testing.assert_array_equal(got_P.numpy(), want_P)
    np.testing.assert_array_equal(
        torch.cat([p.pmask for p in parts]).numpy(), np.asarray(jx.pmask))
    if dtype in ("int8", "int4"):
        np.testing.assert_array_equal(
            torch.cat([p.scales for p in parts]).numpy(),
            np.asarray(jx.scales))
    if mesh.dp == 2:   # the second dp group holds the same shards
        for a, b in zip(ix.parts[:d], ix.parts[d:]):
            assert torch.equal(a.P, b.P) and torch.equal(a.pmask, b.pmask)


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("dtype", [None, "int8", "int4"])
def test_sharded_maxsim_and_topk_against_jax(mesh_kind, dtype):
    """sharded_maxsim and sharded_topk on the mesh: bit-equal to the
    port's one-shard index, and alike to the JAX package's on its mesh, at
    k below, above (100 > a shard's 64 rows) and at the doc count (the
    padding never returned, the empty doc 5 at its exact 0); the tie of
    docs 63 and 64 across the shard boundary goes to 63, in both."""
    P, pm, Q, qm = _corpus(1)
    mk, jmk = MESHES[mesh_kind]
    ix = build_sharded_index(P, pm, mk(), dtype=dtype)
    one = build_sharded_index(P, pm, "cpu", dtype=dtype)
    jm = jmk()
    jx = jax_build(P, pm, jm, dtype=dtype, pad_docs_to=64)
    Qt, qmt = torch.from_numpy(Q), torch.from_numpy(qm)
    Qj, qmj = replicate(jnp.asarray(Q), jm), replicate(jnp.asarray(qm), jm)
    sc = sharded_maxsim(Qt, qmt, ix, "plain")
    np.testing.assert_array_equal(
        sc.numpy(), sharded_maxsim(Qt, qmt, one, "plain").numpy())
    ref = np.asarray(jax_maxsim(Qj, qmj, jx, impl="xla"))
    np.testing.assert_allclose(sc.numpy(), ref, atol=TOL)
    assert (sc[:, 5] == 0).all() and (ref[:, 5] == 0).all()
    for k in (5, 100, N):
        v, i = sharded_topk(Qt, qmt, ix, k, "plain")
        v1, i1 = sharded_topk(Qt, qmt, one, k, "plain")
        _bit_equal((v.numpy(), i.numpy()),
                   (v1[:, :k].numpy(), i1[:, :k].numpy()))
        jv, ji = (np.asarray(a) for a in jax_topk(Qj, qmj, jx, k=k,
                                                   impl="xla"))
        assert v.shape == jv.shape == (NQ, k)
        assert int(i.max()) < N and int(ji.max()) < N
        _ranked_alike(i.numpy().tolist(), v.numpy(), ji.tolist(), jv, ref,
                      i.numpy(), ji, TOL)
        assert i[0, :2].tolist() == i[1, :2].tolist() == [63, 64]
        assert ji[0, :2].tolist() == ji[1, :2].tolist() == [63, 64]
    # the empty doc keeps its 0 in the full top-k (not -inf)
    v, i = sharded_topk(Qt, qmt, ix, N, "plain")
    assert float(v[0][(i[0] == 5)]) == 0.0


# ---------------------------------------------------------------- engine


TIERS = [("float32", {}), ("bfloat16", {}), ("int8", {}),
         ("int8", {"quantize_queries": True}), ("int4", {}),
         ("pq", {"pq_m": 4})]


def _tier_id(t):
    dtype, kw = t
    return dtype + ("_q8" if kw.get("quantize_queries") else "")


def _engines(mesh_kind, dtype, kw, P, pm, ids, **extra):
    """(port mesh engine, port one-shard engine, JAX mesh engine), built
    on the same corpus; PQ engines share the one-shard engine's codes and
    books."""
    mk, jmk = MESHES[mesh_kind]
    one = RetrievalEngine(dtype=dtype, device="cpu", **kw, **extra)
    em = RetrievalEngine(dtype=dtype, mesh=mk(), **kw, **extra)
    je = JaxEngine(dtype=dtype, mesh=jmk(), impl="xla", **kw, **extra)
    one.build(P, pm, docids=ids)
    if dtype == "pq":
        codes, books = one.index.P[:N].numpy(), one._true_books().numpy()
        em.build_from_pq(codes, books, pm, docids=ids)
        je.build_from_pq(codes, books, pm, docids=ids)
    else:
        em.build(P, pm, docids=ids)
        je.build(P, pm, docids=ids)
    return em, one, je


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("tier", TIERS, ids=_tier_id)
def test_engine_on_a_mesh_every_tier(mesh_kind, tier):
    """search_dense, search, score_all and dim of a mesh engine: bit-equal
    to the one-shard engine, alike to the JAX mesh engine."""
    dtype, kw = tier
    P, pm, Q, qm = _corpus(2)
    ids = [f"p{i}" for i in range(N)]
    em, one, je = _engines(mesh_kind, dtype, kw, P, pm, ids)
    assert em.impl == one.impl and em.dim == one.dim == je.dim == D
    assert em.index.parts is not None and one.index.parts is None
    tol = PQ_TOL if dtype == "pq" else TOL
    ref = np.asarray(je.score_all(Q, qm))
    sc = em.score_all(Q, qm)
    np.testing.assert_array_equal(sc, one.score_all(Q, qm))
    np.testing.assert_allclose(sc, ref, atol=tol)
    for k in (10, 100):
        got = em.search_dense(Q, qm, k=k)
        _bit_equal(got, one.search_dense(Q, qm, k=k))
        jv, ji = je.search_dense(Q, qm, k=k)
        _ranked_alike(em.ids_for(got[1]), got[0], je.ids_for(ji),
                      np.asarray(jv), ref, got[1], np.asarray(ji), tol)
    # a batch that does not split over the dp groups (the JAX package
    # refuses it; the port pads the last group with masked rows)
    _bit_equal(em.search_dense(Q[:7], qm[:7], k=10),
               one.search_dense(Q[:7], qm[:7], k=10))
    qobj = np.empty(NQ, dtype=object)
    qobj[:] = [Q[i][qm[i]] for i in range(NQ)]
    (ids_m, v_m), (ids_1, v_1) = (e.search(qobj, k=5) for e in (em, one))
    assert ids_m == ids_1 and np.array_equal(v_m, v_1)


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("tier", [("int8", {}),
                                  ("int8", {"summary_dtype": "int4"}),
                                  ("bfloat16", {}), ("pq", {"pq_m": 4})],
                         ids=lambda t: t[0] + "_" + t[1].get(
                             "summary_dtype", "own"))
def test_pruned_search_on_a_mesh(mesh_kind, tier):
    """Pruned two-stage search on a mesh (stage 1 an exact sharded top-k on
    the summaries, stage 2 each shard reranking the candidates it owns):
    bit-equal to the one-shard engine at 8, 40 and 150 candidates and at
    n_docs; at n_docs alike to the JAX mesh engine within RERANK_TOL."""
    dtype, kw = tier
    P, pm, Q, qm = _corpus(3)
    mk, jmk = MESHES[mesh_kind]
    one = RetrievalEngine(dtype=dtype, device="cpu", prune_centroids=2,
                          **kw).build(P, pm)
    em = RetrievalEngine(dtype=dtype, mesh=mk(), prune_centroids=2, **kw)
    if dtype == "pq":
        # the PQ build's summaries, as one.build made them
        from evdr_tpu_torch.data.packing import l2_normalize
        from evdr_tpu_torch.ops.pruned import build_summary_tokens

        em.build_from_pq(one.index.P[:N], one._true_books(), pm)
        Pn = np.asarray(l2_normalize(P * pm[..., None]), np.float32)
        em._build_summary(*build_summary_tokens(Pn, pm, 2, device="cpu"))
    else:
        em.build(P, pm)
    assert em.summary.parts is not None
    for nc in (8, 40, 150, N):
        _bit_equal(em.search_dense(Q, qm, k=10, n_candidates=nc),
                   one.search_dense(Q, qm, k=10, n_candidates=nc))
    if dtype != "pq":
        je = JaxEngine(dtype=dtype, mesh=jmk(), impl="xla",
                       prune_centroids=2, **kw).build(P, pm)
        v, i = em.search_dense(Q, qm, k=10, n_candidates=N)
        jv, ji = je.search_dense(Q, qm, k=10, n_candidates=N)
        ref = np.asarray(je.score_all(Q, qm))
        _ranked_alike(em.ids_for(i), v, je.ids_for(ji), np.asarray(jv),
                      ref, i, np.asarray(ji), RERANK_TOL)


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("tier", [("bfloat16", {}), ("int8", {}),
                                  ("int4", {}), ("pq", {"pq_m": 4})],
                         ids=lambda t: t[0])
def test_incremental_serving_on_a_mesh(mesh_kind, tier, tmp_path):
    """add (with an upsert), delete, search (exact and pruned), score_all,
    compact and save_npz -> from_npz on a mesh: bit-equal to the one-shard
    engine after the same calls, alike to the JAX mesh engine."""
    dtype, kw = tier
    P, pm, Q, qm = _corpus(4)
    rng = np.random.default_rng(9)
    new = _unit(P[:20] + 0.5 * rng.normal(size=(20, LP, D))).astype(
        np.float32)
    new_pm = pm[20:40].copy()
    new_ids = [f"n{i}" for i in range(18)] + ["p3", "p70"]
    dead = ["p7", "n2", "p64", "p150", "nope"]
    ids = [f"p{i}" for i in range(N)]
    em, one, je = _engines(mesh_kind, dtype, kw, P, pm, ids)
    for e in (em, one, je):
        assert e.add(new, new_pm, docids=new_ids) == 20
        assert e.delete(dead) == 4
        assert e.n_docs == N + 20 - 2 - 4
    tol = PQ_TOL if dtype == "pq" else TOL
    ref = np.asarray(je.score_all(Q, qm))
    sc = em.score_all(Q, qm)
    np.testing.assert_array_equal(sc, one.score_all(Q, qm))
    np.testing.assert_allclose(np.where(np.isinf(ref), 0, sc),
                               np.where(np.isinf(ref), 0, ref), atol=tol)
    assert (np.isinf(sc) == np.isinf(ref)).all()
    for k in (10, 60):
        got = em.search_dense(Q, qm, k=k)
        _bit_equal(got, one.search_dense(Q, qm, k=k))
        jv, ji = je.search_dense(Q, qm, k=k)
        _ranked_alike(em.ids_for(got[1]), got[0], je.ids_for(ji),
                      np.asarray(jv), ref, got[1], np.asarray(ji), tol)
        assert not {"p7", "n2", "p64", "p150"} & {
            x for row in em.ids_for(got[1]) for x in row}
    for e in (em, one):
        e.compact()
    after = em.search_dense(Q, qm, k=10)
    _bit_equal(after, one.search_dense(Q, qm, k=10))
    assert em.tail is None and em.index.n_docs == em.n_docs
    path = tmp_path / "mesh.npz"
    em.save_npz(path)
    mk = MESHES[mesh_kind][0]
    back = RetrievalEngine.from_npz(path, mmap=mk().dp == 1, dtype=dtype,
                                    mesh=mk(), **kw)
    _bit_equal(back.search_dense(Q, qm, k=10), after)
    assert back.ids_for(after[1]) == em.ids_for(after[1])


def test_pruned_incremental_on_a_mesh():
    """The pruned path's tombstone over-fetch and tail merge on a mesh:
    bit-equal to the one-shard engine after the same add and delete."""
    P, pm, Q, qm = _corpus(5)
    one = RetrievalEngine(dtype="int8", device="cpu",
                          prune_centroids=2).build(P, pm)
    em = RetrievalEngine(dtype="int8", mesh=mesh_of(["cpu"] * 4),
                         prune_centroids=2).build(P, pm)
    for e in (em, one):
        e.add(P[:9] * 0.9, pm[:9], docids=[f"x{i}" for i in range(9)])
        e.delete(["4", "x1", "100"])
    for nc in (16, 64, em.n_docs):
        _bit_equal(em.search_dense(Q, qm, k=10, n_candidates=nc),
                   one.search_dense(Q, qm, k=10, n_candidates=nc))


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("tier", TIERS, ids=_tier_id)
def test_from_index_of_a_jax_mesh_index(mesh_kind, tier):
    """The arrays of the JAX mesh engine's index served by the port through
    from_index on a mesh: the port's shards hold the JAX shards' bytes, and
    the mesh engine is bit-equal to a one-shard from_index of the same
    arrays and alike to the JAX engine."""
    dtype, kw = tier
    P, pm, Q, qm = _corpus(6)
    _, one, je = _engines(mesh_kind, dtype, kw, P, pm, None)
    ix = je.index
    arrays = dict(P=np.asarray(ix.P), pmask=np.asarray(ix.pmask),
                  n_docs=ix.n_docs,
                  scales=None if ix.scales is None else np.asarray(ix.scales),
                  books=None if ix.books is None else np.asarray(ix.books),
                  books_expanded=ix.books_expanded)
    mk = MESHES[mesh_kind][0]
    em = RetrievalEngine.from_index(mesh=mk(), dtype=dtype, **arrays, **kw)
    e1 = RetrievalEngine.from_index(device="cpu", dtype=dtype, **arrays,
                                    **kw)
    d = em.mesh.n_doc_shards
    got = torch.cat([p.P for p in em.index.parts[:d]])
    if got.dtype == torch.bfloat16:
        got = got.view(torch.int16)
    want = arrays["P"]
    np.testing.assert_array_equal(got.numpy(), want.view(np.int16)
                                  if want.dtype.name == "bfloat16" else want)
    got = em.search_dense(Q, qm, k=10)
    _bit_equal(got, e1.search_dense(Q, qm, k=10))
    jv, ji = je.search_dense(Q, qm, k=10)
    _ranked_alike(em.ids_for(got[1]), got[0], je.ids_for(ji),
                  np.asarray(jv), np.asarray(je.score_all(Q, qm)), got[1],
                  np.asarray(ji), PQ_TOL if dtype == "pq" else TOL)


def test_clis_shard_over_mesh_docs(tmp_path, monkeypatch):
    """``--mesh_docs N`` of the search CLI (and the server) shards the
    index over ``make_mesh(N)``; here a mesh of repeated CPU devices stands
    in for N GPUs, and the run equals the one-device run. On a mesh both
    load the packed file's doc arrays memory-mapped (a one-device load
    reads them whole)."""
    from evdr_tpu_torch.parallel import mesh as mesh_mod
    from evdr_tpu_torch.tools import convert_packed, serve_http
    from evdr_tpu_torch.tools.search import run_search

    P, pm, Q, qm = _corpus(7)
    path = tmp_path / "idx.npz"
    np.savez(path, P_pad=P, pmask=pm, Q_norm=Q, qmask=qm)
    monkeypatch.setattr(mesh_mod, "make_mesh",
                        lambda n, device: mesh_of([device] * n))
    mapped = []
    load = convert_packed.load_packed_payload

    def recording(npz_path, mmap_docs=False):
        out = load(npz_path, mmap_docs=mmap_docs)
        mapped.append(all(isinstance(out[k], np.memmap)
                          for k in ("P_pad", "pmask")))
        return out

    monkeypatch.setattr(convert_packed, "load_packed_payload", recording)
    one = run_search(path, path, k=10, dtype="int8", device="cpu")
    two = run_search(path, path, k=10, dtype="int8", device="cpu",
                     mesh_docs=3)
    assert one[1] == two[1] and np.array_equal(one[2], two[2])
    assert (one[3]["shards"], two[3]["shards"]) == (1, 3)
    # each run loads the file twice: its index, then its queries
    assert mapped == [False, False, True, False]

    class Served(Exception):
        pass

    def served(engine, *a, **kw):
        assert engine.index.mesh.n_doc_shards == 3
        raise Served

    monkeypatch.setattr(serve_http, "make_server", served)
    with pytest.raises(Served):
        serve_http.main(["--index", str(path), "--dtype", "int8",
                         "--device", "cpu", "--mesh_docs", "3",
                         "--warm", "1"])
    assert mapped[4:] == [True]
