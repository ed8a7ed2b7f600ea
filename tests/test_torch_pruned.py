"""Pruned two-stage search in the torch port (``ops/batched_kmeans.py``,
``ops/pruned.py``, the engine's ``prune_centroids`` / ``n_candidates``, the
CLIs' flags) against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
k-means' first-centre draws come from ``jax.random.gumbel`` on both sides:
the port's ``batched_kmeans.gumbel_draws`` is replaced by the JAX draw of
the same seed and shape. Tolerances: the k-means and the rerank compute in
f32 on both sides and differ only in summation order (1e-5); stage 1 runs
the port's plain kernels (bf16 queries, as on the card) where the JAX
engine at ``impl='xla'`` scores in f32, so engine-level comparisons take
the reference's recall thresholds, or full-cover candidate sets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evdr_tpu.data.synthetic import make_synthetic_corpus, save_synthetic_npz
from evdr_tpu.engine import RetrievalEngine as JaxEngine
from evdr_tpu.ops import batched_kmeans as jkm
from evdr_tpu.ops import pruned as jpr
from evdr_tpu.ops.int4 import quantize_tokens_int4 as j_int4
from evdr_tpu.ops.quantize import quantize_tokens_int8 as j_int8
from evdr_tpu.parallel.mesh import make_mesh
from evdr_tpu_torch import RetrievalEngine
from evdr_tpu_torch.data.packing import preprocess_queries
from evdr_tpu_torch.ops import batched_kmeans as km
from evdr_tpu_torch.ops import pruned


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's first-centre draws replaced by the JAX build's."""
    def draws(seed, shape, device):
        g = jax.random.gumbel(jax.random.PRNGKey(int(seed)), tuple(shape))
        return torch.from_numpy(np.array(g, np.float32)).to(device)

    monkeypatch.setattr(km, "gumbel_draws", draws)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _sse(P, pmask, C, cmask):
    total = 0.0
    for i in range(P.shape[0]):
        toks = P[i][pmask[i]]
        if toks.size == 0:
            continue
        cs = C[i][cmask[i]]
        total += ((toks[:, None] - cs[None]) ** 2).sum(-1).min(axis=1).sum()
    return total


# ------------------------------------------------------------------ k-means


def _separated(seed=0, n=40, k=4, per=8, d=16):
    rng = np.random.default_rng(seed)
    true = rng.normal(size=(n, k, d)) * 4.0
    toks = np.repeat(true, per, axis=1) + 0.05 * rng.normal(
        size=(n, k * per, d))
    return toks.astype(np.float32), np.ones((n, k * per), bool)


def _masked(seed=2, n=10, lp=12, d=6):
    rng = np.random.default_rng(seed)
    P = rng.normal(size=(n, lp, d)).astype(np.float32)
    pm = np.ones((n, lp), bool)
    pm[:, 8:] = False
    return P, pm


def _degenerate(seed=3, n=6, lp=5, d=4):
    rng = np.random.default_rng(seed)
    P = rng.normal(size=(n, lp, d)).astype(np.float32)
    pm = np.ones((n, lp), bool)
    pm[0] = False            # a page with no valid token
    pm[1, 1:] = False        # a single-token page
    return P, pm


def _random(seed=4, n=30, lp=10, d=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, lp, d)).astype(np.float32),
            rng.random((n, lp)) > 0.2)


KMEANS_CASES = {
    "separated": (_separated, dict(k=4, iters=10, seed=0)),
    "masked": (_masked, dict(k=2, iters=5, seed=3)),
    "degenerate": (_degenerate, dict(k=3, iters=4, seed=0)),
    "chunked": (_random, dict(k=3, iters=5, seed=0, chunk_pages=7)),
    "single": (_random, dict(k=3, iters=5, seed=0, chunk_pages=30)),
}


@pytest.mark.parametrize("case", sorted(KMEANS_CASES))
def test_batched_kmeans_matches_jax_with_its_draws(jax_draws, case):
    """Centres (1e-5) and occupancy (equal) against the JAX function fed
    the same first-centre draws: separated clusters, masked tokens,
    degenerate pages (no valid token: zero centres, nothing occupied; one
    token: one centre, that token), a chunked build (its tail padded to
    the chunk's shape, each chunk seeded seed + s) and a single one."""
    make, kw = KMEANS_CASES[case]
    P, pm = make()
    C, m = km.batched_kmeans(P, pm, **kw)
    Cj, mj = jkm.batched_kmeans(P, pm, **kw)
    assert C.dtype == torch.float32 and m.dtype == torch.bool
    np.testing.assert_array_equal(m.numpy(), mj)
    np.testing.assert_allclose(C.numpy(), Cj, rtol=1e-5, atol=1e-5)
    if case == "degenerate":
        assert not m[0].any() and bool((C[0] == 0).all())
        assert int(m[1].sum()) == 1
        np.testing.assert_allclose(C[1][m[1]][0].numpy(), P[1, 0], rtol=1e-6)


def test_batched_kmeans_ignores_masked_tokens_and_chunks_alike():
    """With the port's own draws: masked tokens poisoned with 1e6 change
    nothing, and a chunked build's objective is within half of a single
    build's (chunking changes the per-chunk seeds), as the JAX package's
    tests hold its own."""
    P, pm = _masked()
    P2 = P.copy()
    P2[:, 8:] = 1e6
    C1, m1 = km.batched_kmeans(P, pm, k=2, iters=5, seed=3)
    C2, m2 = km.batched_kmeans(P2, pm, k=2, iters=5, seed=3)
    assert torch.equal(m1, m2)
    torch.testing.assert_close(C1, C2, rtol=1e-6, atol=1e-6)
    P, pm = _random()
    s1 = _sse(P, pm, *map(_np, km.batched_kmeans(P, pm, 3, chunk_pages=30)))
    s2 = _sse(P, pm, *map(_np, km.batched_kmeans(P, pm, 3, chunk_pages=7)))
    assert abs(s1 - s2) / max(s1, 1e-9) < 0.5


def test_summary_tokens_match_jax(jax_draws):
    """build_summary_tokens: L2-normalized centres where occupied, zero
    elsewhere, equal to the JAX function's (1e-5); from PQ codes, chunk by
    chunk (chunk_pages 5 of 12 pages), equal to the JAX function's on the
    same codes and books, compact and expanded."""
    rng = np.random.default_rng(5)
    P = rng.normal(size=(12, 16, 8)).astype(np.float32)
    pm = rng.random((12, 16)) > 0.15
    S, sm = pruned.build_summary_tokens(P, pm, k_centroids=4, iters=4)
    Sj, smj = jpr.build_summary_tokens(P, pm, k_centroids=4, iters=4)
    np.testing.assert_array_equal(sm.numpy(), smj)
    np.testing.assert_allclose(S.numpy(), Sj, rtol=1e-5, atol=1e-5)
    norms = S.norm(dim=-1)
    assert torch.allclose(norms[sm], torch.ones(()), atol=1e-5)
    assert bool((norms[~sm] == 0).all())
    books = rng.normal(size=(4, 8, 2)).astype(np.float32)
    codes = rng.integers(0, 8, (12, 16, 4), dtype=np.uint8)
    for b, expanded in ((books, False),
                        (rng.normal(size=(4, 8, 8)).astype(np.float32),
                         True)):
        S, sm = pruned.build_summary_tokens_from_pq(
            torch.from_numpy(codes), b, pm, 3, chunk_pages=5,
            expanded=expanded)
        Sj, smj = jpr.build_summary_tokens_from_pq(
            codes, b, pm, 3, chunk_pages=5, expanded=expanded)
        np.testing.assert_array_equal(sm.numpy(), smj)
        np.testing.assert_allclose(S.numpy(), Sj, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ rerank


def _rerank_case(seed=0, nq=5, lq=4, n=23, lp=9, d=16, c=7):
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(nq, lq, d)).astype(np.float32)
    qm = rng.random((nq, lq)) > 0.2
    qm[:, 0] = True
    P = rng.normal(size=(n, lp, d)).astype(np.float32)
    pm = rng.random((n, lp)) > 0.2
    pm[n - 3:] = False  # padding rows: no valid token
    cand = np.stack([rng.permutation(n)[:c] for _ in range(nq)])
    cand[:, 0] = n - 1  # every query holds a padding candidate
    return Q, qm, P, pm, cand.astype(np.int64)


def _index(kind, P, pm, rng):
    """(P as stored, scales, books) of a float, int8, int4 or PQ index,
    quantized by the JAX package's quantizers."""
    if kind == "float":
        return P, None, None
    if kind == "int8":
        codes, sc = j_int8(P, pm)
        return codes, sc, None
    if kind == "int4":
        packed, sc = j_int4(P, pm)
        return packed, sc, None
    m = 4
    expanded = kind.startswith("pq_expanded")
    w = P.shape[-1] if expanded else P.shape[-1] // m
    books = rng.normal(size=(m, 16, w)).astype(np.float32)
    codes = rng.integers(0, 16, P.shape[:2] + (m,), dtype=np.uint8)
    return codes, None, books


RERANK_KINDS = ["float", "int8", "int4", "pq_onehot", "pq_take",
                "pq_expanded_onehot", "pq_expanded_take"]


@pytest.mark.parametrize("kind", RERANK_KINDS)
def test_rerank_matches_jax(kind):
    """_rerank_block and rerank_candidates (in blocks of 2 queries, the
    last ragged) against the JAX functions on the same candidates: float,
    int8 and int4 candidates (scales applied after the gather, int4
    unpacked after it), PQ with compact and expanded books through both
    decodes. Values 1e-5 (f32 on both sides), indices equal; a padding
    candidate ranks last (-inf) and is never returned above a real doc."""
    rng = np.random.default_rng(7)
    Q, qm, P, pm, cand = _rerank_case()
    Pi, sc, books = _index(kind, P, pm, rng)
    dec = "take" if kind.endswith("take") else "onehot"
    jargs = [jnp.asarray(x) for x in (Q, qm, Pi, pm, cand.astype(np.int32))]
    jkw = dict(scales=None if sc is None else jnp.asarray(sc),
               books=None if books is None else jnp.asarray(books),
               pq_decode=dec)
    targs = [torch.from_numpy(np.ascontiguousarray(x))
             for x in (Q, qm, Pi, pm, cand)]
    tkw = dict(scales=None if sc is None else torch.from_numpy(sc),
               books=None if books is None else torch.from_numpy(books),
               pq_decode=dec)
    for k in (3, 7):
        vj, ij = jpr._rerank_block(*jargs, k, **jkw)
        v, i = pruned._rerank_block(*targs, k, **tkw)
        np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    vj, ij = jpr.rerank_candidates(*jargs, k=5, chunk_q=2, **jkw)
    v, i = pruned.rerank_candidates(*targs, k=5, chunk_q=2, **tkw)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    v, i = pruned.rerank_candidates(*targs, k=7, **tkw)
    dead = v == -torch.inf
    assert bool(dead[:, -1].all()) and bool((i[dead] >= P.shape[0] - 3).all())
    assert bool((i[~dead] < P.shape[0] - 3).all())


def test_pq_decode_onehot_equals_take_in_f32():
    """The two PQ decodes of the rerank are the same f32 tokens bit for
    bit (one-hot entries are exact), compact and expanded books, so the
    rerank's results do not depend on the decode (a deliberate f32 decode:
    in a narrower dtype the one-hot product would round)."""
    rng = np.random.default_rng(3)
    codes = torch.from_numpy(rng.integers(0, 16, (3, 5, 9, 4), np.uint8))
    for w, d in ((6, 24), (24, 24)):
        books = torch.from_numpy(rng.normal(size=(4, 16, w)).astype(
            np.float32))
        a = pruned._decode_pq(codes, books, d, "onehot")
        b = pruned._decode_pq(codes, books, d, "take")
        assert a.shape == (3, 5, 9, 24) and torch.equal(a, b)
    with pytest.raises(ValueError, match="pq_decode"):
        pruned._decode_pq(codes, books, 24, "lut")


def test_empty_doc_ranks_last_pruned_and_zero_exact():
    """A real doc with no valid token: the pruned rerank ranks it -inf
    (last), as the reference's (pruned.py:140-144), while exact top-k
    scores it 0 and keeps it rankable (topk.py:145-153), here above docs
    whose MaxSim is negative."""
    rng = np.random.default_rng(0)
    d = 16
    Q = rng.normal(size=(2, 3, d)).astype(np.float32)
    P = np.repeat(-Q.mean(axis=1, keepdims=True), 4, axis=1)[:1]
    P = np.concatenate([np.broadcast_to(P, (5, 4, d)),
                        np.zeros((1, 4, d), np.float32)]).astype(np.float32)
    pm = np.ones((6, 4), bool)
    pm[5] = False  # doc 5: real, no valid token
    qm = np.ones((2, 3), bool)
    eng = RetrievalEngine(dtype="float32", device="cpu", normalize=False,
                          prune_centroids=2).build(P, pm)
    ve, ie = eng.search_dense(Q, qm, k=6)
    assert (ie[:, 0] == 5).all() and (ve[:, 0] == 0.0).all()
    vp, ip = eng.search_dense(Q, qm, k=6, n_candidates=6)
    assert (ip[:, -1] == 5).all() and np.isneginf(vp[:, -1]).all()
    assert (vp[:, :-1] < 0).all()


# ------------------------------------------------------------ both stages


@pytest.mark.parametrize("kind,sdtype", [("float", "bfloat16"),
                                         ("int8", "int8"), ("int4", "int4"),
                                         ("pq_onehot", "bfloat16")])
def test_pruned_topk_fused_matches_jax_on_the_same_candidates(kind, sdtype):
    """Both stages against the JAX function: the summary index (JAX
    summaries, stored in the tier's dtype, int8/int4 with their scales)
    scored by the port's kernels' plain versions picks the same candidates
    as the JAX stage 1 (checked), and then the two reranks agree: values
    1e-5, indices equal."""
    rng = np.random.default_rng(11)
    Q, qm, P, pm, _ = _rerank_case(seed=3, nq=6, n=40, lp=12, d=16)
    S, smask = jpr.build_summary_tokens(P, pm, 4)
    Pi, sc, books = _index(kind, P, pm, rng)
    if sdtype == "int8":
        Sv, ss = j_int8(S, smask)
    elif sdtype == "int4":
        Sv, ss = j_int4(S, smask)
    else:
        Sv, ss = np.asarray(jnp.asarray(S, jnp.bfloat16)), None
    n_cand = 12
    jsc = jnp.where(jnp.asarray(smask).any(-1)[None, :], jpr_scores(
        Q, qm, Sv, smask, ss), -jnp.inf)
    jcand = np.asarray(jax.lax.top_k(jsc, n_cand)[1])
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in (Q, qm)]
    St = torch.from_numpy(np.array(
        Sv.view(np.int16) if Sv.dtype.name == "bfloat16" else Sv))
    if Sv.dtype.name == "bfloat16":
        St = St.view(torch.bfloat16)
    sst = None if ss is None else torch.from_numpy(ss)
    tsc = pruned.candidate_scores(*t, St, torch.from_numpy(smask), "plain",
                                  sst)
    tcand = torch.sort(tsc, dim=1, descending=True, stable=True)[1][:, :n_cand]
    assert [set(r) for r in tcand.numpy()] == [set(r) for r in jcand]
    vj, ij = jpr.pruned_topk_fused(
        *(jnp.asarray(x) for x in (Q, qm, Pi, pm, Sv, smask)), k=5,
        n_cand=n_cand, impl="xla",
        scales=None if sc is None else jnp.asarray(sc),
        sscales=None if ss is None else jnp.asarray(ss),
        books=None if books is None else jnp.asarray(books))
    v, i = pruned.pruned_topk_fused(
        *t, torch.from_numpy(np.ascontiguousarray(Pi)), torch.from_numpy(pm),
        St, torch.from_numpy(smask), k=5, n_cand=n_cand, impl="plain",
        scales=None if sc is None else torch.from_numpy(sc), sscales=sst,
        books=None if books is None else torch.from_numpy(books))
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))


def jpr_scores(Q, qm, S, smask, sscales):
    """The JAX stage 1 at impl='xla' on the same summary index."""
    from evdr_tpu.parallel.topk import _local_scores

    return _local_scores(*(jnp.asarray(x) for x in (Q, qm, S, smask)), 128,
                         "xla", None if sscales is None
                         else jnp.asarray(sscales))


def test_rerank_chunk_q_holds_the_reference_bound():
    """The adaptive query block (pruned.py:221-231): ~512 MB of decoded
    candidates, the one-hot planes counted, 1 to 32 queries."""
    assert pruned.rerank_chunk_q(16, 16, 128) == 32
    assert pruned.rerank_chunk_q(16384, 16, 128) == 4
    assert pruned.rerank_chunk_q(2500, 768, 128) == 1
    books = torch.zeros(16, 256, 8)
    assert (pruned.rerank_chunk_q(512, 64, 128, books)
            < pruned.rerank_chunk_q(512, 64, 128, books, "take"))


# ----------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def corpus():
    return make_synthetic_corpus(n_docs=30, n_queries=12, dim=64, seed=5)


def _engine(corpus, **kw):
    return RetrievalEngine(device="cpu", prune_centroids=4,
                           **kw).build_from_ragged(
        corpus["documents"], corpus["doc_attnmask"], corpus["doc_imgmask"],
        docids=corpus["docid"])


def _exact_f32_top(eng, Q, qm, k):
    """Exact top-k over what the rerank scores: the stored index in f32
    (PQ decoded from its f32 books), the -1e4 fill, no kernel rounding."""
    from evdr_tpu_torch.ops.maxsim import maxsim_torch
    from evdr_tpu_torch.parallel.sharded_index import pad_queries
    from evdr_tpu_torch.parallel.topk import _select_topk

    ix = eng.index
    Qd = pad_queries(torch.from_numpy(Q), ix)
    P = pruned._decode_pq(ix.P, ix.books, Qd.shape[-1], "take")
    sc = maxsim_torch(Qd, P, torch.from_numpy(qm), ix.pmask)[:, :ix.n_docs]
    return _select_topk(sc, k)[1].numpy()


@pytest.mark.parametrize("dtype", [None, "bfloat16", "int8", "int4", "pq"])
def test_pruned_search_recall_against_exact(corpus, dtype):
    """The JAX engine's test (tests/test_engine.py) on the port: pruned
    top-1 recall against the engine's own exact search >= 0.9 and top-5
    >= 0.6 at 10 candidates of 30; at 30 candidates the top-5 sets equal
    the exact ones; every tier, its summaries in the engine's dtype (bf16
    for PQ). PQ: exact search scores int8-quantized books in the kernels'
    bf16 tile, the rerank the f32 books, so its top-5 is held to 0.5 and
    its full cover to the exact top-5 of the f32 reconstruction."""
    kw = dict(pq_m=8) if dtype == "pq" else {}
    eng = _engine(corpus, dtype=dtype, **kw)
    assert eng.summary is not None and eng.summary.n_docs == 30
    want = {None: torch.float32, "pq": torch.bfloat16}.get(
        dtype, eng.index.P.dtype)
    assert eng.summary.P.dtype == want
    Q, qm = preprocess_queries(corpus["query"], corpus["query_attnmask"])
    _, i_exact = eng.search_dense(Q, qm, k=5)
    _, i_pruned = eng.search_dense(Q, qm, k=5, n_candidates=10)
    assert pruned.pruned_recall(i_exact[:, :1], i_pruned[:, :1]) >= 0.9
    assert pruned.pruned_recall(i_exact, i_pruned) >= (
        0.5 if dtype == "pq" else 0.6)
    _, i_all = eng.search_dense(Q, qm, k=5, n_candidates=30)
    if dtype == "pq":
        i_exact = _exact_f32_top(eng, Q, qm, 5)
    for a, b in zip(i_all, i_exact):
        assert set(a.tolist()) == set(b.tolist())


def test_pruned_engine_agrees_with_the_jax_engine(corpus, jax_draws):
    """The same float32 engine in both packages with the same k-means
    draws: summaries equal (1e-5), and at full cover the pruned top-5 of
    both is the exact top-5 (sets equal); public search routes
    n_candidates; an int8 engine's summaries carry scales; without a
    summary, n_candidates is refused as in the reference."""
    jeng = JaxEngine(mesh=make_mesh(1), dtype=None, impl="xla",
                     prune_centroids=4).build_from_ragged(
        corpus["documents"], corpus["doc_attnmask"], corpus["doc_imgmask"],
        docids=corpus["docid"])
    eng = _engine(corpus, dtype="float32")
    np.testing.assert_allclose(eng.summary.P.numpy(),
                               np.asarray(jeng.summary.P), rtol=1e-5,
                               atol=1e-5)
    Q, qm = preprocess_queries(corpus["query"], corpus["query_attnmask"])
    _, ij = jeng.search_dense(Q, qm, k=5, n_candidates=30)
    _, i = eng.search_dense(Q, qm, k=5, n_candidates=30)
    assert [set(r) for r in i.tolist()] == [set(r) for r in
                                            np.asarray(ij).tolist()]
    ids, _ = eng.search(corpus["query"], corpus["query_attnmask"], k=1,
                        n_candidates=10)
    ids_j, _ = jeng.search(corpus["query"], corpus["query_attnmask"], k=1,
                           n_candidates=10)
    assert sum(a == b for a, b in zip(ids, ids_j)) >= 11
    eng8 = _engine(corpus, dtype="int8", quantize_queries=True)
    assert eng8.impl == "plain_q8" and eng8.summary.scales is not None
    plain = RetrievalEngine(dtype="int8", device="cpu").build_from_ragged(
        corpus["documents"], corpus["doc_attnmask"], corpus["doc_imgmask"])
    with pytest.raises(ValueError, match="n_candidates requires"):
        plain.search_dense(Q, qm, k=5, n_candidates=10)


def test_search_cli_and_server_run_pruned(tmp_path, corpus):
    """tools/search with --prune_centroids/--n_candidates writes the same
    rank-1 docs as the JAX CLI's pruned run and reports "pruned"; the
    server over a pruned engine reports pruned: true on /healthz and
    answers a request's n_candidates (and its default_candidates)."""
    import json
    import threading
    import urllib.request

    from evdr_tpu.tools.search import run_search as jax_run_search
    from evdr_tpu_torch.tools import search, serve_http

    path = tmp_path / "c.npz"
    save_synthetic_npz(path, corpus)
    run = tmp_path / "run.trec"
    search.main(["--index", str(path), "--queries", str(path), "--k", "3",
                 "--out", str(run), "--device", "cpu", "--prune_centroids",
                 "4", "--n_candidates", "30", "--summary_dtype", "int8"])
    assert len(run.read_text().splitlines()) == 12 * 3
    qk, ids, _, summary = search.run_search(
        path, path, k=3, device="cpu", prune_centroids=4, n_candidates=30)
    assert summary["pruned"] is True
    jk, jids, _, jsum = jax_run_search(path, path, k=3, impl="xla",
                                       prune_centroids=4, n_candidates=30)
    assert jsum["pruned"] and qk == jk
    assert [r[0] for r in ids] == [r[0] for r in jids]

    eng = _engine(corpus, dtype="bfloat16")
    srv = serve_http.make_server(eng, port=0, default_candidates=10)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["pruned"] is True
        Q, qm = preprocess_queries(corpus["query"], corpus["query_attnmask"])
        q0 = Q[0][qm[0]].tolist()
        for body, nc in (({"queries": [q0], "k": 3}, 10),
                         ({"queries": [q0], "k": 3, "n_candidates": 30},
                          30)):
            req = urllib.request.Request(
                url + "/search", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                reply = json.loads(r.read())
            Qh, qmh = preprocess_queries(_one(q0), None, length_multiple=8)
            _, idx = eng.search_dense(Qh, qmh, k=3, n_candidates=nc)
            assert reply["docids"][0] == eng.ids_for(idx)[0]
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)


def _one(q):
    o = np.empty(1, dtype=object)
    o[0] = np.asarray(q, np.float32)
    return o


@pytest.mark.parametrize("expanded", [False, True])
def test_from_npz_pq_with_pruning_builds_summaries_from_the_codes(
        tmp_path, corpus, jax_draws, expanded):
    """A packed PQ file (compact books, or expanded OPQ books) loaded into
    a pruned PQ engine: the summaries are those of the decoded codes (the
    JAX engine's from_npz on the same file, same draws: 1e-2, both stored
    in bf16), stored bf16; at full cover the pruned top-5 sets are the
    exact ones over the f32 reconstruction."""
    from evdr_tpu_torch.data.npz_io import load_payload
    from evdr_tpu_torch.tools.convert_packed import convert_payload_to_packed

    src = tmp_path / "c.npz"
    save_synthetic_npz(src, corpus)
    path = tmp_path / "pq.npz"
    np.savez(path, **convert_payload_to_packed(
        load_payload(src), dtype="pq", normalize=True, pq_m=8,
        pq_opq=expanded, device="cpu"))
    eng = RetrievalEngine.from_npz(path, dtype="pq", prune_centroids=4,
                                   device="cpu")
    jeng = JaxEngine.from_npz(path, mesh=make_mesh(1), dtype="pq",
                              impl="xla", prune_centroids=4)
    assert eng.summary.P.dtype == torch.bfloat16 and eng.dim == 64
    np.testing.assert_allclose(
        eng.summary.P.float().numpy()[:, :, :64],
        np.asarray(jeng.summary.P).astype(np.float32), rtol=0, atol=1e-2)
    Q, qm = preprocess_queries(corpus["query"], corpus["query_attnmask"])
    _, i_all = eng.search_dense(Q, qm, k=5, n_candidates=30)
    for a, b in zip(i_all, _exact_f32_top(eng, Q, qm, 5)):
        assert set(a.tolist()) == set(b.tolist())
