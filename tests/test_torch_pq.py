"""The torch port's PQ/OPQ tier against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
codebook training and host encoders are numpy in both and must agree bit
for bit; the plain versions of K3 (``maxsim_pq_plain``,
``maxsim_pqfull_plain``) are held against the Pallas kernel in interpret
mode, as ``tests/test_pq.py`` runs it, and the engines against each other.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evdr_tpu.engine import RetrievalEngine as JaxEngine
from evdr_tpu.ops import pq as jpq
from evdr_tpu.ops.pallas_maxsim import maxsim_pallas_pq, maxsim_pallas_pqfull
from evdr_tpu.parallel.mesh import make_mesh
from evdr_tpu.tools.convert_packed import (
    convert_payload_to_packed as jax_convert_payload)
from evdr_tpu_torch import RetrievalEngine
from evdr_tpu_torch.ops import cuda_maxsim, pq


def _unit(x):
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)


def _case(seed, nq=5, lq=6, nd=30, lp=9, d=32):
    """Masked random inputs with a doc that has no valid token (2)."""
    rng = np.random.default_rng(seed)
    Q = _unit(rng.normal(size=(nq, lq, d))).astype(np.float32)
    P = _unit(rng.normal(size=(nd, lp, d))).astype(np.float32)
    qm = rng.random((nq, lq)) > 0.2
    pm = rng.random((nd, lp)) > 0.2
    pm[2] = False
    qm[0, 0] = True
    return Q, P * pm[..., None], qm, pm


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.fixture(scope="module")
def books():
    """Compact and expanded OPQ books trained by the JAX package on one
    corpus (m=8 subspaces of 4 dims, K=32), with the codes of both."""
    _, P, _, pm = _case(seed=0, nd=40, lp=13)
    bc = jpq.train_pq(P, pm, m=8, k=32, iters=4, seed=0)
    bo, rot = jpq.train_opq(P, pm, m=8, k=32, iters=4, opq_iters=2, seed=0)
    return P, pm, bc, bo, rot


def test_training_and_encoding_match_jax_package(books):
    # numpy in both packages: the same seed gives the same books, rotation,
    # codes and reconstructions, bit for bit
    P, pm, bc, bo, rot = books
    np.testing.assert_array_equal(
        pq.train_pq(P, pm, m=8, k=32, iters=4, seed=0), bc)
    got_b, got_r = pq.train_opq(P, pm, m=8, k=32, iters=4, opq_iters=2,
                                seed=0)
    np.testing.assert_array_equal(got_b, bo)
    np.testing.assert_array_equal(got_r, rot)
    # the sample cut and kmeans++ on more tokens than the sample
    np.testing.assert_array_equal(
        pq.train_pq(P, pm, m=4, k=16, iters=3, sample=200, seed=3),
        jpq.train_pq(P, pm, m=4, k=16, iters=3, sample=200, seed=3))
    ex = pq.expand_books(bo, rot)
    np.testing.assert_array_equal(ex, jpq.expand_books(bo, rot))
    assert pq.books_expanded(ex, 32) and not pq.books_expanded(bc, 32)
    for b, r in ((bc, None), (bo, rot)):
        c = pq.encode_pq(P, b, pm, rot=r)
        np.testing.assert_array_equal(c, jpq.encode_pq(P, b, pm, rot=r))
        np.testing.assert_array_equal(pq.decode_pq(c, b),
                                      jpq.decode_pq(c, b))
    for b in (bc, ex):
        c = pq.encode_with_books(P, b, pm)
        np.testing.assert_array_equal(c, jpq.encode_with_books(P, b, pm))
        e = b is ex
        np.testing.assert_array_equal(pq.decode_pq(c, b, expanded=e),
                                      jpq.decode_pq(c, b, expanded=e))
    # fewer tokens than centroids: the tokens are the books
    np.testing.assert_array_equal(pq.train_pq(P[:2, :3], None, m=8),
                                  jpq.train_pq(P[:2, :3], None, m=8))


def test_train_pq_on_a_tensor_picks_the_same_sample(books):
    # a tensor index sends only its token sample to the host: same books
    P, pm, *_ = books
    np.testing.assert_array_equal(
        pq.train_pq(*_t(P, pm), m=4, k=16, iters=3, sample=200, seed=3),
        jpq.train_pq(P, pm, m=4, k=16, iters=3, sample=200, seed=3))


def test_encode_pq_device_matches_host_encoder(books):
    # torch on the CPU, one batched product per chunk: on tie-free data the
    # same nearest centroids as the numpy encoder, for numpy input (codes
    # come back as numpy) and tensor input (codes stay tensors)
    P, pm, bc, bo, rot = books
    for b, r in ((bc, None), (bo, rot)):
        want = jpq.encode_pq(P, b, pm, rot=r)
        got = pq.encode_pq_device(P, b, pm, rot=r, chunk_tokens=50,
                                  device="cpu")
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)
        got_t = pq.encode_pq_device(*_t(P), b, torch.from_numpy(pm), rot=r,
                                    chunk_tokens=64)
        np.testing.assert_array_equal(got_t.numpy(), want)


@pytest.mark.parametrize("expanded", [False, True])
def test_maxsim_pq_matches_the_jax_oracle(books, expanded):
    # f32 lookup tables on both sides (-1e4 fill, any(pmask) rule) -> 1e-5
    P, pm, bc, bo, rot = books
    b = pq.expand_books(bo, rot) if expanded else bc
    codes = jpq.encode_pq(P, bo if expanded else bc, pm,
                          rot=rot if expanded else None)
    Q, _, qm, _ = _case(seed=1)
    want = np.asarray(jpq.maxsim_pq_xla(*_j(Q, codes, qm, pm, b), chunk_p=7))
    got = pq.maxsim_pq(*_t(Q, codes, qm, pm, b), chunk_p=5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(got[:, 2] == 0.0)


def _coded(books, expanded, seed=1, lq=6):
    P, pm, bc, bo, rot = books
    b = pq.expand_books(bo, rot) if expanded else bc
    codes = jpq.encode_pq(P, bo if expanded else bc, pm,
                          rot=rot if expanded else None)
    Q, _, qm, _ = _case(seed=seed, lq=lq)
    return Q, codes, qm, pm, b


@pytest.mark.parametrize("expanded", [False, True])
def test_pq_plain_f32_matches_pallas_interpret(books, expanded):
    # int8-quantized books (one global scale) decoded to exact int32 sums,
    # f32 queries, on both sides -> 1e-5
    Q, codes, qm, pm, b = _coded(books, expanded)
    want = np.asarray(maxsim_pallas_pq(*_j(Q, codes, qm, pm, b),
                                       compute_dtype=jnp.float32,
                                       interpret=True))
    got = cuda_maxsim.maxsim_pq_plain(*_t(Q, codes, qm, pm, b),
                                      compute=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(got[:, 2] == 0.0)


@pytest.mark.parametrize("expanded", [False, True])
def test_pqfull_plain_matches_pallas_interpret(books, expanded):
    # compact books: int8 queries x an exact int8 tile on both sides; the
    # products are exact integers and only the f32 products with the book
    # and query scales and the Lq-sum round (XLA in its own order: <= 1 ulp
    # a term) -> 1e-6. Expanded books: the int8 queries cast up, against
    # the tile in f32 here -> 1e-5
    Q, codes, qm, pm, b = _coded(books, expanded)
    want = np.asarray(maxsim_pallas_pqfull(*_j(Q, codes, qm, pm, b),
                                           compute_dtype=jnp.float32,
                                           interpret=True))
    got = cuda_maxsim.maxsim_pqfull_plain(*_t(Q, codes, qm, pm, b),
                                          compute=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 if expanded else 1e-6)
    assert np.all(got[:, 2] == 0.0)


def test_opq_decode_sums_above_256_round_in_bf16():
    # expanded int8 books whose rows sum to 257 and 259 in dim 0 and 1 (the
    # global scale is exactly 1: max |value| = 127): the decoded token rounds
    # to bf16 before the product (256 and 260, nearest even), as the TPU
    # kernel's bf16 path does; in f32 it stays exact
    M, K, D = 3, 4, 16
    b = np.zeros((M, K, D), np.float32)
    b[0, 1, 0] = b[1, 2, 0] = b[0, 0, 1] = b[1, 0, 1] = 127
    b[2, 3, 0], b[2, 0, 1] = 3, 5
    codes = np.array([[[1, 2, 3], [0, 0, 0]]], np.uint8)
    pm = np.ones((1, 2), bool)
    Q = np.zeros((2, 1, D), np.float32)
    Q[0, 0, 0] = Q[1, 0, 1] = 1.0
    qm = np.ones((2, 1), bool)
    args = (Q, codes, qm, pm, b)
    got = cuda_maxsim.maxsim_pq_plain(*_t(*args)).numpy()
    np.testing.assert_array_equal(got, [[256.0], [260.0]])
    np.testing.assert_array_equal(
        got, np.asarray(maxsim_pallas_pq(*_j(*args), interpret=True)))
    np.testing.assert_array_equal(
        cuda_maxsim.maxsim_pq_plain(*_t(*args), compute=torch.float32),
        [[257.0], [259.0]])
    # int8 queries cast up meet the same rounded tile
    np.testing.assert_array_equal(
        cuda_maxsim.maxsim_pqfull_plain(*_t(*args)).numpy(),
        np.asarray(maxsim_pallas_pqfull(*_j(*args), interpret=True)))


@pytest.mark.parametrize("expanded", [False, True])
def test_pq_plain_versions_rank_as_the_oracle(books, expanded):
    # the kernels' numerics (int8 books, bf16 or int8 queries) against the
    # f32 LUT oracle on unquantized books: <= 5e-2 on these sums, and the
    # top-3 differs only between docs that close
    Q, codes, qm, pm, b = _coded(books, expanded)
    ref = np.asarray(jpq.maxsim_pq_xla(*_j(Q, codes, qm, pm, b)))
    for fn in (cuda_maxsim.maxsim_pq_plain, cuda_maxsim.maxsim_pqfull_plain):
        got = fn(*_t(Q, codes, qm, pm, b)).numpy()
        np.testing.assert_allclose(got, ref, atol=5e-2)
        for q in range(Q.shape[0]):
            for x, y in zip(np.argsort(-got[q], kind="stable")[:3],
                            np.argsort(-ref[q], kind="stable")[:3]):
                assert x == y or abs(ref[q, x] - ref[q, y]) <= 5e-2


@pytest.mark.parametrize("dtype,opq,q8,want", [
    ("int8", False, True, "plain_q8"), ("int4", False, True, "plain_q8"),
    ("pq", False, True, "plain_q8"), ("pq", True, True, "plain"),
    ("pq", False, False, "plain"), ("bfloat16", False, True, "plain")])
def test_impl_names_resolve_as_in_the_jax_engine(dtype, opq, q8, want):
    # engine.py:80-87: int8 x int8 for int8, int4 and pq, never for OPQ
    eng = RetrievalEngine(dtype=dtype, pq_opq=opq, quantize_queries=q8,
                          device="cpu")
    assert eng.impl == want
    jax_impl = JaxEngine(mesh=make_mesh(1), dtype=dtype, pq_opq=opq,
                         quantize_queries=q8, impl="pallas").impl
    assert jax_impl == want.replace("plain", "pallas")


def _corpus(seed=7, nd=40, lp=13, d=32, nq=10, lq=5):
    Q, P, qm, pm = _case(seed, nq=nq, lq=lq, nd=nd, lp=lp, d=d)
    # planted: query i copies tokens of doc 3 i + 1 (well separated top-1)
    for i in range(nq):
        src = P[3 * i + 1][pm[3 * i + 1]]
        Q[i] = _unit(src[np.arange(lq) % len(src)]
                     + 0.05 * np.random.default_rng(i).normal(size=(lq, d)))
    return Q.astype(np.float32), P, qm, pm


@pytest.mark.parametrize("opq,q8", [(False, False), (False, True),
                                    (True, False), (True, True)])
def test_pq_engine_matches_jax_engine(opq, q8):
    """Both packages train the same books on the host (numpy, same seed) and
    encode the same codes; carried over by index_from_numpy, the JAX index
    scores the same in the port. Against the JAX engine's f32 LUT oracle
    (impl='xla'): int8 books and bf16 or int8 queries move each score by
    <= 5e-2; ranks differ only between docs that close."""
    Q, P, qm, pm = _corpus()
    jeng = JaxEngine(mesh=make_mesh(1), dtype="pq", pq_m=8, pq_opq=opq,
                     impl="xla").build(P, pm)
    eng = RetrievalEngine(dtype="pq", pq_m=8, pq_opq=opq, quantize_queries=q8,
                          device="cpu").build(P, pm)
    ji = jeng.index
    np.testing.assert_array_equal(eng.index.P.numpy(), np.asarray(ji.P))
    np.testing.assert_array_equal(eng.index.books.numpy(),
                                  np.asarray(ji.books))
    assert eng.index.books_expanded == ji.books_expanded == opq
    carried = RetrievalEngine.from_index(
        np.asarray(ji.P), np.asarray(ji.pmask), ji.n_docs,
        books=np.asarray(ji.books), books_expanded=ji.books_expanded,
        dtype="pq", pq_opq=opq, quantize_queries=q8, device="cpu")
    np.testing.assert_array_equal(carried.score_all(Q, qm),
                                  eng.score_all(Q, qm))
    tol = 5e-2
    ref_scores = np.asarray(jeng.score_all(Q, qm))
    ref_vals, ref_idx = (np.asarray(a) for a in jeng.search_dense(Q, qm, k=5))
    vals, idx = carried.search_dense(Q, qm, k=5)
    np.testing.assert_allclose(vals, ref_vals, atol=tol)
    for q in range(Q.shape[0]):
        for a, b in zip(idx[q], ref_idx[q]):
            assert a == b or abs(ref_scores[q, a] - ref_scores[q, b]) <= tol
    np.testing.assert_array_equal(idx[:, 0], 3 * np.arange(10) + 1)
    assert eng.dim == jeng.dim == 32 and eng.n_docs == jeng.n_docs


@pytest.mark.parametrize("opq", [False, True])
def test_packed_pq_files_load_in_both_packages(tmp_path, opq):
    # the port writes the JAX package's bytes; a pq engine serves the codes,
    # a float engine the decoded tokens, in both packages
    from evdr_tpu.data.synthetic import make_synthetic_corpus
    from evdr_tpu_torch.tools.convert_packed import (
        convert_payload_to_packed, load_packed_payload)

    c = make_synthetic_corpus(n_docs=30, n_queries=6, dim=32, seed=4)
    files = {}
    for name, conv in (("jax", jax_convert_payload),
                       ("port", convert_payload_to_packed)):
        files[name] = tmp_path / f"{name}.npz"
        np.savez(files[name], **conv(c, dtype="pq", normalize=True, pq_m=8,
                                     pq_opq=opq))
    with np.load(files["jax"]) as a, np.load(files["port"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    payload = load_packed_payload(files["port"])
    Q, qm = payload["Q_norm"], payload["qmask"]
    for path in files.values():
        eng = RetrievalEngine.from_npz(path, dtype="pq", device="cpu")
        jeng = JaxEngine.from_npz(path, mesh=make_mesh(1), dtype="pq",
                                  impl="xla")
        np.testing.assert_array_equal(eng.index.P.numpy(),
                                      np.asarray(jeng.index.P))
        assert eng.index.books_expanded == opq and eng.dim == 32
        fl = RetrievalEngine.from_npz(path, dtype="float32", device="cpu")
        jfl = JaxEngine.from_npz(path, mesh=make_mesh(1), dtype="float32",
                                 impl="xla")
        np.testing.assert_array_equal(fl.index.P.numpy(),
                                      np.asarray(jfl.index.P))
        # the pq engine's int8 books and bf16 queries against the decoded
        # floats in bf16: 5e-2
        np.testing.assert_allclose(eng.score_all(Q, qm), fl.score_all(Q, qm),
                                   atol=5e-2)


def test_build_from_pq_takes_tensors_like_arrays(books):
    # PQ codes encoded on the device (a tensor) enter as numpy ones do;
    # only a pq engine takes them
    P, pm, bc, _, _ = books
    codes = pq.encode_pq_device(*_t(P), bc, torch.from_numpy(pm))
    a = RetrievalEngine(dtype="pq", device="cpu").build_from_pq(
        codes.numpy(), bc, pm)
    b = RetrievalEngine(dtype="pq", device="cpu").build_from_pq(
        codes, torch.from_numpy(bc), torch.from_numpy(pm))
    for x, y in ((a.index.P, b.index.P), (a.index.books, b.index.books),
                 (a.index.pmask, b.index.pmask)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert a.index.P.dtype == torch.uint8 and a.dim == b.dim == 32
    Q, _, qm, _ = _case(seed=2)
    np.testing.assert_array_equal(a.score_all(Q, qm), b.score_all(Q, qm))
    with pytest.raises(ValueError, match="pq"):
        RetrievalEngine(dtype="int4", device="cpu").build_from_pq(
            codes, bc, pm)


@pytest.mark.parametrize("expanded", [False, True])
def test_from_npz_serves_qat_books_as_the_jax_engine(tmp_path, books,
                                                     expanded):
    # an interchange npz that carries a QAT-pq student's codebooks: both
    # packages encode its pages with exactly those books (no refit) and
    # serve the same codes. The port records expanded books as expanded,
    # so its dim is D; the JAX engine's qat_books branch leaves the flag
    # unset (evdr_tpu/engine.py:797-798)
    from evdr_tpu.data.synthetic import make_synthetic_corpus
    from evdr_tpu_torch.data.packing import preprocess_queries

    _, _, bc, bo, rot = books
    qb = pq.expand_books(bo, rot) if expanded else bc
    c = make_synthetic_corpus(n_docs=20, n_queries=4, dim=32, seed=5)
    path = tmp_path / "student.npz"
    np.savez(path, qat_books=qb, **{
        k: np.array(v, dtype=object) if isinstance(v, dict)
        else np.asarray(v, dtype=object) for k, v in c.items()})
    eng = RetrievalEngine.from_npz(path, dtype="pq", device="cpu")
    jeng = JaxEngine.from_npz(path, mesh=make_mesh(1), dtype="pq",
                              impl="xla")
    np.testing.assert_array_equal(eng.index.P.numpy(),
                                  np.asarray(jeng.index.P))
    np.testing.assert_array_equal(eng.index.books.numpy(), qb)
    assert eng.pq_m == 8 and eng.n_docs == 20
    assert eng.index.books_expanded == expanded and eng.dim == 32
    Q, qm = preprocess_queries(c["query"], c["query_attnmask"])
    # int8 books and bf16 queries against the f32 LUT oracle: 5e-2
    np.testing.assert_allclose(eng.score_all(Q, qm), jeng.score_all(Q, qm),
                               atol=5e-2)


@pytest.mark.parametrize("nq,lq", [(1, 32), (4, 32), (5, 32), (12, 32),
                                   (20, 32), (36, 32), (256, 32), (3, 128),
                                   (17, 128), (1000, 7), (9, 1)])
def test_pq_cluster_covers_every_query_block(nq, lq):
    # K3's cluster: a power of two <= 8 (full-width books) or MAX_CLUSTER's
    # compact cap, and <= the query-block count, so the launcher's grid x
    # (the blocks padded up to a multiple of C) has fewer than C padding
    # CTAs; a single block (one HTTP request) runs alone
    blocks = -(-nq // (cuda_maxsim.KERNEL_ROWS // lq))
    for compact, top in ((False, 8),
                         (True, cuda_maxsim.MAX_CLUSTER["compact"])):
        c = cuda_maxsim.pq_cluster(nq, lq, compact)
        assert c in (1, 2, 4, 8) and c <= max(1, blocks)
        assert c == min(top, 1 << (blocks.bit_length() - 1))
        if blocks == 1:
            assert c == 1
    # the serving batch (64 blocks): clusters of 8 with full-width books
    if (nq, lq) == (256, 32):
        assert cuda_maxsim.pq_cluster(nq, lq) == 8
        assert (cuda_maxsim.pq_cluster(nq, lq, True)
                == cuda_maxsim.MAX_CLUSTER["compact"])


def _shares(n, c):
    # the [lo, hi) share of each of a cluster's c CTAs in K3's decode of n
    # items, as maxsim_pq.cu computes it: rank n / c to (rank + 1) n / c
    return [(r * n // c, (r + 1) * n // c) for r in range(c)]


@pytest.mark.parametrize("n", [1, 3, 4, 12, 16, 17, 32, 64])
@pytest.mark.parametrize("c", [1, 2, 4, 8])
def test_pq_shares_cover_each_item_once(n, c):
    # subspaces (compact books) or tokens of a page tile (full-width books):
    # the c shares are contiguous, in rank order, and cover 0..n-1 once,
    # uneven where c does not divide n, empty where n < c
    shares = _shares(n, c)
    assert len(shares) == c
    covered = [i for lo, hi in shares for i in range(lo, hi)]
    assert covered == list(range(n))
    sizes = [hi - lo for lo, hi in shares]
    assert max(sizes) - min(sizes) <= 1 and max(sizes) <= -(-n // c)


@pytest.mark.parametrize("expanded", [False, True])
@pytest.mark.parametrize("c", [1, 2, 4, 8])
def test_pq_decode_by_shares_equals_pq_decode_int(expanded, c):
    # the kernel's split decode in plain torch: compact books share by
    # subspace (CTA r fills the dims of its subspaces for every token),
    # full-width books by token (CTA r sums whole rows for its tokens);
    # concatenated, the shares are pq_decode_int's tokens exactly (M = 12,
    # uneven shares at C = 8)
    rng = np.random.default_rng(c + 10 * expanded)
    m, k, d = 12, 256, 48
    w = d if expanded else d // m
    books = torch.from_numpy(rng.normal(size=(m, k, w)).astype(np.float32))
    tile = 64  # a page tile's tokens (maxsim_tile.cuh kCols)
    codes = torch.from_numpy(rng.integers(0, k, (2, tile, m), dtype=np.uint8))
    compact, books_q, _ = cuda_maxsim.pq_books(books, d, "cpu")
    assert compact != expanded
    want = cuda_maxsim.pq_decode_int(
        codes, cuda_maxsim.pq_full_books(books_q, compact, d))
    idx = codes.long()
    if compact:
        parts = [books_q[torch.arange(lo, hi), idx[..., lo:hi]].flatten(-2)
                 for lo, hi in _shares(m, c)]
        got = torch.cat(parts, dim=-1).to(torch.int32)
    else:
        parts = [sum(books_q[j][idx[:, lo:hi, j]].to(torch.int32)
                     for j in range(m))
                 for lo, hi in _shares(idx.shape[1], c)]
        got = torch.cat(parts, dim=1)
    assert got.shape == want.shape == (2, tile, d)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind,func,kb_shape,cluster", [
    ("compact", "evdr_maxsim_pq", (8, 256, 4), 2),
    ("compact2", "evdr_maxsim_pq_sum", (16, 256, 32), 8),
    ("expanded", "evdr_maxsim_pq_sum", (4, 256, 32), 8)])
def test_pq_host_side_picks_kernel_books_and_cluster(monkeypatch, kind,
                                                     func, kb_shape,
                                                     cluster):
    # K3's host side up to the launch (the kernel replaced by a recorder):
    # compact books of 4-byte subvectors go to the shared-memory kernel as
    # int8 rows padded to 256, clusters of 2 at the serving batch; 2-byte
    # subvectors are embedded block-diagonally and, like expanded books,
    # summed through L2, clusters of 8
    rng = np.random.default_rng(3)
    d, m = 32, {"compact": 8, "compact2": 16, "expanded": 4}[kind]
    w = d if kind == "expanded" else d // m
    books = torch.from_numpy(rng.normal(size=(m, 40, w)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 40, (3, 5, m), dtype=np.uint8))
    Q = torch.from_numpy(rng.normal(size=(256, 32, d)).astype(np.float32))
    qm, pm = torch.ones(256, 32, dtype=torch.bool), torch.ones(3, 5,
                                                               dtype=torch.bool)
    seen = {}

    def record(lib, name, operands, *args, aligned=()):
        seen.update(lib=lib, func=name, kb=operands[3], args=args)

    monkeypatch.setattr(cuda_maxsim, "call_kernel", record)
    out, name = cuda_maxsim._launch_pq(Q.to(torch.bfloat16), qm.float(),
                                       codes, qm, pm, books,
                                       int8_queries=False)
    assert name == seen["func"] == func and seen["lib"] == "maxsim_pq"
    assert seen["kb"].dtype == torch.int8
    assert tuple(seen["kb"].shape) == kb_shape
    assert seen["args"] == (256, 32, 3, 5, d, m, cluster)
    assert out.shape == (256, 3)
    compact, books_q, _ = cuda_maxsim.pq_books(books, d, "cpu")
    full = cuda_maxsim.pq_full_books(books_q, compact, d)
    if func == "evdr_maxsim_pq":
        assert torch.equal(seen["kb"][:, :40], books_q)
        assert not seen["kb"][:, 40:].any()
    else:  # the full-width rows the kernel sums decode as pq_decode_int
        assert torch.equal(seen["kb"].to(torch.int32), full)
