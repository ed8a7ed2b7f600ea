"""The torch port's RetrievalEngine against the JAX package's, on the CPU.

The same synthetic corpus (numpy, seeded) goes into ``evdr_tpu``'s engine
(``impl='xla'``, f32 scoring) and into the port's engine on ``device='cpu'``,
which runs the CUDA kernels' plain versions with the kernels' numerics
(bf16 queries and pages for float indexes, int8 queries for
``quantize_queries``). Rankings are compared tie-tolerantly: where the two
packages order two docs differently, the reference's scores of those docs
must lie within the stated tolerance of each other.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evdr_tpu.data.packing import preprocess_queries
from evdr_tpu.data.synthetic import make_synthetic_corpus, save_synthetic_npz
from evdr_tpu.engine import RetrievalEngine as JaxEngine
from evdr_tpu.ops.pallas_maxsim import maxsim_pallas_int8full
from evdr_tpu.parallel.mesh import make_mesh
from evdr_tpu.tools.convert_packed import (
    convert_payload_to_packed as jax_convert_payload)
from evdr_tpu_torch import RetrievalEngine
from evdr_tpu_torch.convert import index_from_numpy
from evdr_tpu_torch.parallel.sharded_index import build_sharded_index
from evdr_tpu_torch.tools.convert_packed import (convert_payload_to_packed,
                                                 load_packed_payload)

# Score tolerance of the port (kernel numerics) against the reference's f32
# scores: bf16 keeps 8 bits of mantissa, so each unit-norm token similarity
# moves by <= ~4e-3 and a query sums <= 14 of them (query_len_range); the
# int8 query codes move each similarity by <= ~sq/2 * ||p||_1 ~ 5e-3.
TOL = {None: 6e-2, "float32": 6e-2, "bfloat16": 6e-2, "int8": 6e-2,
       "int8_q8": 8e-2}
K = 8


@pytest.fixture(scope="module")
def corpus():
    c = make_synthetic_corpus(n_docs=45, n_queries=12, dim=32, seed=3)
    Q, qm = preprocess_queries(c["query"], c["query_attnmask"])
    return c, Q, qm


def _engines(c, dtype, q8):
    # the JAX engine runs on one device, as the port's index lives on one GPU
    jax_eng = JaxEngine(mesh=make_mesh(1), dtype=dtype, impl="xla")
    jax_eng.build_from_ragged(c["documents"], c["doc_attnmask"],
                              c["doc_imgmask"], docids=c["docid"])
    eng = RetrievalEngine(dtype=dtype, quantize_queries=q8, device="cpu")
    eng.build_from_ragged(c["documents"], c["doc_attnmask"],
                          c["doc_imgmask"], docids=c["docid"])
    return jax_eng, eng


def assert_same_ranking(ids, vals, ref_ids, ref_vals, ref_scores, tol):
    """``ids``/``vals`` (port) against the reference's top-k and its full
    score matrix: values within ``tol``; at every rank either the same doc,
    or two docs whose reference scores are within ``tol``."""
    ids, ref_ids = np.asarray(ids), np.asarray(ref_ids)
    assert ids.shape == ref_ids.shape
    np.testing.assert_allclose(vals, ref_vals, atol=tol)
    for q in range(ids.shape[0]):
        for a, b in zip(ids[q], ref_ids[q]):
            assert a == b or abs(ref_scores[q, a] - ref_scores[q, b]) <= tol


@pytest.mark.parametrize("dtype,q8", [("float32", False), ("bfloat16", False),
                                      ("int8", False), ("int8", True)])
def test_engine_matches_jax_engine(corpus, dtype, q8):
    c, Q, qm = corpus
    jax_eng, eng = _engines(c, dtype, q8)
    assert eng.impl == ("plain_q8" if q8 else "plain")
    tol = TOL["int8_q8" if q8 else dtype]
    ref_vals, ref_idx = jax_eng.search_dense(Q, qm, k=K)
    ref_scores = np.asarray(jax_eng.score_all(Q, qm))
    vals, idx = eng.search_dense(Q, qm, k=K)
    assert_same_ranking(idx, vals, ref_idx, ref_vals, ref_scores, tol)
    np.testing.assert_allclose(eng.score_all(Q, qm), ref_scores, atol=tol)
    # top-1 is well separated on this corpus: identical
    np.testing.assert_array_equal(idx[:, 0], np.asarray(ref_idx)[:, 0])
    ids, _ = eng.search(c["query"], c["query_attnmask"], k=K)
    assert [r[0] for r in ids] == [r[0] for r in jax_eng.ids_for(ref_idx)]
    assert eng.n_docs == jax_eng.n_docs and eng.dim == jax_eng.dim


def _assert_same_index(mine, ji):
    jP = np.asarray(ji.P)
    if jP.dtype.name == "bfloat16":
        np.testing.assert_array_equal(mine.P.view(torch.int16).numpy(),
                                      jP.view(np.int16))
    else:
        np.testing.assert_array_equal(mine.P.numpy(), jP)
    np.testing.assert_array_equal(mine.pmask.numpy(), np.asarray(ji.pmask))
    assert mine.n_pad == ji.n_pad and mine.n_docs == ji.n_docs
    assert (mine.scales is None) == (ji.scales is None)
    if ji.scales is not None:
        np.testing.assert_array_equal(mine.scales.numpy(),
                                      np.asarray(ji.scales))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_index_is_bit_identical_and_carries_over(corpus, dtype):
    """The port builds the same stored index as the JAX package (bf16 round
    to nearest even, the same int8 codes); index_from_numpy carries a JAX
    index over unchanged, and both engines then score the same bytes."""
    c, Q, qm = corpus
    jax_eng, eng = _engines(c, dtype, False)
    ji = jax_eng.index
    jP = np.asarray(ji.P)
    _assert_same_index(eng.index, ji)

    carried = RetrievalEngine.from_index(
        jP, np.asarray(ji.pmask), ji.n_docs,
        scales=None if ji.scales is None else np.asarray(ji.scales),
        docids=ji.docids, dtype=dtype, device="cpu")
    np.testing.assert_array_equal(carried.score_all(Q, qm),
                                  eng.score_all(Q, qm))
    v1, i1 = carried.search_dense(Q, qm, k=K)
    v2, i2 = eng.search_dense(Q, qm, k=K)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(v1, v2)
    assert carried.ids_for(i1) == jax_eng.ids_for(i1)


def test_carried_int8_index_scores_as_the_pallas_int8full_kernel(corpus):
    # the q8 engine on a JAX int8 index vs the TPU kernel in interpret mode
    # on the same arrays: identical codes, exact int dots -> 1e-5
    c, Q, qm = corpus
    ji = JaxEngine(mesh=make_mesh(1), dtype="int8", impl="xla").build_from_ragged(
        c["documents"], c["doc_attnmask"], c["doc_imgmask"]).index
    arrs = [np.asarray(a) for a in (ji.P, ji.scales, ji.pmask)]
    eng = RetrievalEngine.from_index(arrs[0], arrs[2], ji.n_docs,
                                     scales=arrs[1], dtype="int8",
                                     quantize_queries=True, device="cpu")
    want = np.asarray(maxsim_pallas_int8full(
        jnp.asarray(Q), *[jnp.asarray(a) for a in arrs[:2]], jnp.asarray(qm),
        jnp.asarray(arrs[2]), interpret=True))[:, :ji.n_docs]
    np.testing.assert_allclose(eng.score_all(Q, qm), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype,normalize", [("bfloat16", False),
                                             ("int8", True), ("int8", False),
                                             ("float32", True)])
def test_from_npz_reads_files_of_both_packages(tmp_path, corpus, dtype,
                                               normalize):
    c, Q, qm = corpus
    obj = tmp_path / "obj.npz"
    save_synthetic_npz(obj, c)
    jax_file = tmp_path / "jax.packed.npz"
    np.savez(jax_file, **jax_convert_payload(c, dtype=dtype,
                                             normalize=normalize))
    port_file = tmp_path / "port.packed.npz"
    np.savez(port_file, **convert_payload_to_packed(c, dtype=dtype,
                                                    normalize=normalize))
    # the port writes the same bytes as the JAX package
    with np.load(jax_file) as a, np.load(port_file) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    ref = RetrievalEngine(dtype=dtype, device="cpu").build_from_ragged(
        c["documents"], c["doc_attnmask"], c["doc_imgmask"],
        docids=c["docid"])
    want = ref.score_all(Q, qm)
    for path in (obj, jax_file, port_file):
        eng = RetrievalEngine.from_npz(path, dtype=dtype, device="cpu")
        # both packages load a file into the same stored index
        _assert_same_index(eng.index, JaxEngine.from_npz(
            path, mesh=make_mesh(1), dtype=dtype, impl="xla").index)
        # an int8 file of unnormalized tokens is dequantized, normalized and
        # quantized again on load (two roundings, ~scale/2 per element ->
        # 2e-2 on these sums); every other load keeps the direct build's
        # values up to f32 normalization order (1e-5)
        tol = 2e-2 if (dtype == "int8" and not normalize
                       and path != obj) else 1e-5
        np.testing.assert_allclose(eng.score_all(Q, qm), want, atol=tol)
        ids, _ = eng.search(c["query"], c["query_attnmask"], k=3)
        assert ids[0][0] == ref.search(c["query"], c["query_attnmask"],
                                       k=3)[0][0][0]
    payload = load_packed_payload(jax_file)
    assert payload["P_pad"].dtype == np.float32


def test_padding_never_returned_and_empty_doc_scores_zero():
    rng = np.random.default_rng(11)
    nd, lp, d = 37, 5, 16          # 37 docs pad to 64
    P = rng.normal(size=(nd, lp, d)).astype(np.float32)
    pm = np.ones((nd, lp), bool)
    pm[5] = False                  # a real doc with no valid token
    Q = -np.abs(rng.normal(size=(3, 4, d))).astype(np.float32)
    P = np.abs(P)                  # every real similarity is negative
    qm = np.ones((3, 4), bool)
    for dtype in ("bfloat16", "int8"):
        eng = RetrievalEngine(dtype=dtype, device="cpu").build(P, pm)
        assert eng.index.n_pad == 64
        vals, idx = eng.search_dense(Q, qm, k=100)
        assert vals.shape == (3, nd) and idx.max() < nd
        assert np.isfinite(vals).all()
        # the empty doc (score 0) outranks every negative-scoring doc
        np.testing.assert_array_equal(idx[:, 0], 5)
        np.testing.assert_array_equal(vals[:, 0], 0.0)


def test_ties_rank_lower_index_first_like_lax_top_k():
    rng = np.random.default_rng(12)
    base = rng.normal(size=(6, 4, 16)).astype(np.float32)
    P = np.concatenate([base, base, base[:3]])  # exact duplicate docs
    pm = np.ones(P.shape[:2], bool)
    Q = rng.normal(size=(4, 3, 16)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=-1, keepdims=True)
    qm = np.ones((4, 3), bool)
    qm[3] = False                                 # all-tied query: zeros
    jax_eng = JaxEngine(mesh=make_mesh(1), dtype=None, impl="xla").build(P, pm)
    for k in (1, 5, 15):
        _, ref_idx = jax_eng.search_dense(Q, qm, k=k)
        eng = RetrievalEngine(dtype="float32", device="cpu").build(P, pm)
        _, idx = eng.search_dense(Q, qm, k=k)
        np.testing.assert_array_equal(idx, np.asarray(ref_idx))
    np.testing.assert_array_equal(idx[3], np.arange(15))


def test_build_sharded_index_quantizes_tensors_like_arrays():
    rng = np.random.default_rng(13)
    P = rng.normal(size=(5, 7, 16)).astype(np.float32)
    pm = rng.random((5, 7)) > 0.3
    a = build_sharded_index(P, pm, "cpu", dtype="int8", pad_docs_to=4)
    b = build_sharded_index(torch.from_numpy(P), torch.from_numpy(pm), "cpu",
                            dtype="int8", pad_docs_to=4)
    assert a.n_pad == 8 and a.n_docs == 5
    np.testing.assert_array_equal(a.P.numpy(), b.P.numpy())
    np.testing.assert_allclose(a.scales.numpy(), b.scales.numpy(), rtol=1e-7)
    with pytest.raises(ValueError):
        index_from_numpy(a.P, a.pmask, 5, device="cpu")  # codes w/o scales


def test_unported_options_raise(tmp_path):
    # unknown dtypes, impls and summary tiers (PQ summaries: stage 1 has no
    # books) are refused; a streaming build refuses what touches the whole
    # array (normalize, summaries, PQ training), as in the JAX engine
    with pytest.raises(ValueError, match="summary_dtype"):
        RetrievalEngine(prune_centroids=4, summary_dtype="pq", device="cpu")
    P, pm = np.zeros((3, 4, 16), np.float32), np.ones((3, 4), bool)
    for kw, normalize in (({}, None), ({"prune_centroids": 2}, False),
                          ({"dtype": "pq"}, False)):
        with pytest.raises(ValueError, match="streaming build"):
            RetrievalEngine(device="cpu", **kw).build(
                P, pm, streaming=True, normalize=normalize)
    with pytest.raises(ValueError):
        RetrievalEngine(dtype="int2", device="cpu")
    with pytest.raises(ValueError):
        RetrievalEngine(impl="cuda", device="cpu")
    with pytest.raises(ValueError):
        convert_payload_to_packed({}, dtype="int2")


# ------------------------------------------------ memory-mapped loading


def test_packed_mmap_and_direct_codes(tmp_path):
    """--normalize packed files: the mmap loader returns memmap views and
    dequantizes nothing (float32, int8, int4); from_npz(mmap=True) streams
    them into the same index as the eager load (bit for bit), and serves
    int8/int4 codes directly; the JAX loader's views hold the same bytes."""
    from evdr_tpu.tools.convert_packed import (
        load_packed_payload as jax_load_packed)
    from evdr_tpu_torch.parallel import sharded_index

    c = make_synthetic_corpus(n_docs=20, n_queries=8, dim=32, seed=3)
    Q, qm = preprocess_queries(c["query"], c["query_attnmask"])
    for dtype, key in (("float32", "P_pad"), ("int8", "P_codes"),
                       ("int4", "P_codes4")):
        packed = convert_payload_to_packed(c, dtype=dtype, normalize=True)
        pth = tmp_path / f"norm_{dtype}.packed.npz"
        np.savez(pth, **packed)
        pl = load_packed_payload(pth, mmap_docs=True)
        jl = jax_load_packed(pth, mmap_docs=True)
        assert isinstance(pl[key], np.memmap) and not pl[key].flags.writeable
        assert isinstance(pl["pmask"], np.memmap)
        if key != "P_pad":
            assert "P_pad" not in pl and isinstance(pl["P_scale"], np.memmap)
        for k in pl:
            if isinstance(pl[k], np.ndarray):
                np.testing.assert_array_equal(pl[k], jl[k], err_msg=k)
        eng_dtype = None if dtype == "float32" else dtype
        eng_m = RetrievalEngine.from_npz(pth, mmap=True, dtype=eng_dtype,
                                         device="cpu")
        eng_e = RetrievalEngine.from_npz(pth, dtype=eng_dtype, device="cpu")
        for a, b in ((eng_m.index.P, eng_e.index.P),
                     (eng_m.index.pmask, eng_e.index.pmask),
                     (eng_m.index.scales, eng_e.index.scales)):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b)
        v_m, i_m = eng_m.search_dense(Q, qm, k=5)
        v_e, i_e = eng_e.search_dense(Q, qm, k=5)
        np.testing.assert_array_equal(i_m, i_e)
        np.testing.assert_array_equal(v_m, v_e)
        assert eng_m.ids_for(i_m) == eng_e.ids_for(i_e)
    # the mmap load streams: every copy to the device is a bounded chunk
    seen = []
    real = sharded_index._host_tensor

    def spy(x):
        seen.append(x.nbytes)
        return real(x)

    try:
        sharded_index._host_tensor = spy
        sharded_index.STREAM_CHUNK_BYTES, old = 4096, \
            sharded_index.STREAM_CHUNK_BYTES
        RetrievalEngine.from_npz(tmp_path / "norm_int8.packed.npz",
                                 mmap=True, dtype="int8", device="cpu")
    finally:
        sharded_index._host_tensor = real
        sharded_index.STREAM_CHUNK_BYTES = old
    codes_bytes = int(np.prod(load_packed_payload(
        tmp_path / "norm_int8.packed.npz", mmap_docs=True)["P_codes"].shape[
            1:]))
    assert len(seen) > 3 and max(seen) <= max(4096, codes_bytes)


def test_int4_from_npz_mmap_over_float_file_degrades_eagerly(tmp_path):
    """An int4 engine over a normalized FLOAT packed file with mmap=True
    quantizes eagerly (int4 has no quantize-on-stream) instead of failing,
    and serves what the eager load serves; a streaming int4 build from
    floats is refused."""
    c = make_synthetic_corpus(n_docs=17, n_queries=5, dim=32, seed=8)
    Q, qm = preprocess_queries(c["query"], c["query_attnmask"])
    np.savez(tmp_path / "f32.npz", **convert_payload_to_packed(
        c, dtype="float32", normalize=True))
    eng = RetrievalEngine.from_npz(tmp_path / "f32.npz", dtype="int4",
                                   mmap=True, device="cpu")
    assert eng.index.P.dtype == torch.uint8
    eager = RetrievalEngine.from_npz(tmp_path / "f32.npz", dtype="int4",
                                     device="cpu")
    assert torch.equal(eng.index.P, eager.index.P)
    np.testing.assert_array_equal(eng.search_dense(Q, qm, k=3)[1],
                                  eager.search_dense(Q, qm, k=3)[1])
    P = np.zeros((3, 4, 16), np.float32)
    with pytest.raises(ValueError, match="streaming int4"):
        build_sharded_index(P, np.ones((3, 4), bool), "cpu", dtype="int4",
                            streaming=True)


@pytest.mark.parametrize("dtype", [None, "bfloat16", "int8"])
def test_streamed_build_matches_plain(dtype):
    """streaming=True gives the one-shot build's index bit for bit, in
    chunks smaller than the index (the cast and the int8 quantization run
    chunk by chunk; per-token scales make that exact), from read-only
    memmap-like input, padded to the doc quantum."""
    from evdr_tpu_torch.parallel import sharded_index

    rng = np.random.default_rng(1)
    P = rng.normal(size=(21, 6, 16)).astype(np.float32)
    pm = rng.random((21, 6)) > 0.2
    a = build_sharded_index(P, pm, "cpu", dtype=dtype, pad_docs_to=8)
    Pr, pmr = P.copy(), pm.copy()
    Pr.flags.writeable = pmr.flags.writeable = False
    old = sharded_index.STREAM_CHUNK_BYTES
    try:
        sharded_index.STREAM_CHUNK_BYTES = 1024
        b = build_sharded_index(Pr, pmr, "cpu", dtype=dtype, pad_docs_to=8,
                                streaming=True)
    finally:
        sharded_index.STREAM_CHUNK_BYTES = old
    assert a.n_pad == b.n_pad == 24 and a.n_docs == b.n_docs == 21
    assert a.P.dtype == b.P.dtype
    assert torch.equal(a.P, b.P) and torch.equal(a.pmask, b.pmask)
    assert (a.scales is None) == (b.scales is None)
    if a.scales is not None:
        assert torch.equal(a.scales, b.scales)


def test_as_tensor_copies_read_only_arrays_in_chunks():
    """A read-only array (a memmap, a JAX array's view) reaches the device
    a bounded chunk of rows at a time, never as one whole host copy."""
    from evdr_tpu_torch.parallel import sharded_index

    x = np.arange(40 * 8, dtype=np.float32).reshape(40, 8)
    x.flags.writeable = False
    sizes = []
    real = sharded_index._host_tensor

    def spy(a):
        sizes.append(a.shape[0])
        return real(a)

    old = sharded_index.STREAM_CHUNK_BYTES
    try:
        sharded_index._host_tensor = spy
        sharded_index.STREAM_CHUNK_BYTES = 64
        t = sharded_index.as_tensor(x, "cpu", torch.bfloat16)
    finally:
        sharded_index._host_tensor = real
        sharded_index.STREAM_CHUNK_BYTES = old
    assert sizes == [2] * 20
    assert t.dtype == torch.bfloat16
    assert torch.equal(t, torch.from_numpy(x.copy()).to(torch.bfloat16))
    s = np.asarray(3.0)
    s.flags.writeable = False
    assert float(sharded_index.as_tensor(s, "cpu")) == 3.0


def test_from_npz_does_not_mutate_engine_normalize(tmp_path):
    """Loading a pre-normalized packed file (eager or mmap) leaves the
    engine's normalize default alone: a later build() with raw embeddings
    on the same engine still normalizes them."""
    c = make_synthetic_corpus(n_docs=20, n_queries=8, dim=32, seed=5)
    Q, qm = preprocess_queries(c["query"], c["query_attnmask"])
    packed = convert_payload_to_packed(c, dtype="float32", normalize=True)
    pth = tmp_path / "norm.packed.npz"
    np.savez(pth, **packed)
    for mmap in (False, True):
        eng = RetrievalEngine.from_npz(pth, mmap=mmap, device="cpu")
        assert eng.normalize is True
        v_loaded, i_loaded = eng.search_dense(Q, qm, k=3)
        eng.build(np.asarray(packed["P_pad"], np.float32) * 7.0,
                  np.asarray(packed["pmask"], bool))
        v_raw, i_raw = eng.search_dense(Q, qm, k=3)
        np.testing.assert_array_equal(i_raw, i_loaded)
        np.testing.assert_allclose(v_raw, v_loaded, rtol=1e-4, atol=1e-4)
