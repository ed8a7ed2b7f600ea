"""The torch port's int4 tier against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
plain versions of K4 (``maxsim_int4_plain``, ``maxsim_int4full_plain``) are
held against the Pallas kernel in interpret mode, as ``tests/test_int4.py``
runs it, and the engines against each other on the same stored index.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evdr_tpu.engine import RetrievalEngine as JaxEngine
from evdr_tpu.ops import int4 as jint4
from evdr_tpu.ops.pallas_maxsim import (maxsim_pallas_int4,
                                        maxsim_pallas_int4full)
from evdr_tpu.parallel.mesh import make_mesh
from evdr_tpu.tools.convert_packed import (
    convert_payload_to_packed as jax_convert_payload)
from evdr_tpu_torch import RetrievalEngine
from evdr_tpu_torch.ops import cuda_maxsim, int4
from evdr_tpu_torch.tools.convert_packed import convert_payload_to_packed


def _unit(x):
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)


def _case(seed, nq=5, lq=6, nd=11, lp=9, d=32, negative=False):
    """Masked random inputs (odd Lp by default) with a doc that has no valid
    token (2) and a valid all-zero token (doc 4, token 0: scale 0)."""
    rng = np.random.default_rng(seed)
    Q = _unit(rng.normal(size=(nq, lq, d))).astype(np.float32)
    P = _unit(rng.normal(size=(nd, lp, d))).astype(np.float32)
    if negative:
        P = -np.abs(P)
        Q[0] = np.abs(Q[0])
    qm = rng.random((nq, lq)) > 0.2
    pm = rng.random((nd, lp)) > 0.2
    pm[2] = False
    qm[0, 0] = True
    P = P * pm[..., None]
    pm[4, 0] = True          # valid, all zeros: scale 0, scores 0
    return Q, P, qm, pm


CASES = [dict(seed=0), dict(seed=1, lp=16, d=48), dict(seed=2, negative=True),
         dict(seed=3, nq=2, nd=5, lp=1), dict(seed=4, lq=3, lp=71, d=16)]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("lp", [1, 6, 9])
def test_quantize_pack_unpack_match_jax_package(lp):
    # numpy branch: a copy of evdr_tpu.ops.int4, byte for byte; the torch
    # branch and the torch unpack give the same bytes and codes (round half
    # to even in both)
    _, P, _, pm = _case(seed=5, lp=lp)
    P[0, 0, :4] = [0.5 / 7, 1.5 / 7, -2.5 / 7, 1.0]   # exact halves
    want_c, want_s = jint4.quantize_tokens_int4(P, pm)
    got_c, got_s = int4.quantize_tokens_int4(P, pm)
    assert got_c.shape == (P.shape[0], int4.packed_token_rows(lp), 32)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_s, want_s)
    tc, ts = int4.quantize_tokens_int4(*_t(P, pm))
    np.testing.assert_array_equal(tc.numpy(), want_c)
    np.testing.assert_array_equal(ts.numpy(), want_s)
    np.testing.assert_array_equal(int4.unpack_int4(want_c, lp),
                                  jint4.unpack_int4(want_c, lp))
    np.testing.assert_array_equal(
        cuda_maxsim.unpack_int4_torch(torch.from_numpy(want_c), lp).numpy(),
        jint4.unpack_int4(want_c, lp))
    np.testing.assert_array_equal(int4.dequantize_int4(want_c, want_s),
                                  jint4.dequantize_int4(want_c, want_s))
    # every nibble value, the sign bit included, unpacks as the JAX package's
    allb = np.arange(256, dtype=np.uint8).reshape(1, 16, 16)
    np.testing.assert_array_equal(
        cuda_maxsim.unpack_int4_torch(torch.from_numpy(allb), 32).numpy(),
        jint4.unpack_int4(allb))


@pytest.mark.parametrize("case", CASES)
def test_maxsim_int4_matches_the_jax_oracle(case):
    # f32 on both sides (the -1e4 fill, the any(pmask) rule) -> 1e-5
    Q, P, qm, pm = _case(**case)
    packed, scale = jint4.quantize_tokens_int4(P, pm)
    want = np.asarray(jint4.maxsim_int4_xla(*_j(Q, packed, scale, qm, pm),
                                            chunk_p=4))
    got = int4.maxsim_int4(*_t(Q, packed, scale, qm, pm), chunk_p=3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(got[:, 2] == 0.0)


@pytest.mark.parametrize("case", CASES)
def test_int4_plain_f32_matches_pallas_interpret(case):
    # f32 queries x exact codes, scale before the max, on both sides -> 1e-5
    Q, P, qm, pm = _case(**case)
    packed, scale = jint4.quantize_tokens_int4(P, pm)
    want = np.asarray(maxsim_pallas_int4(
        *_j(Q, packed, scale, qm, pm), compute_dtype=jnp.float32,
        interpret=True))
    got = cuda_maxsim.maxsim_int4_plain(*_t(Q, packed, scale, qm, pm),
                                        compute=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(got[:, 2] == 0.0)


@pytest.mark.parametrize("case", CASES)
def test_int4full_plain_matches_pallas_interpret(case):
    # int8 x int4 dot products are exact integers on both sides; only the
    # f32 products with the page and query scales and the Lq-sum round
    # (XLA on the CPU rounds them in its own order: up to 1 ulp per term,
    # 6e-8 measured) -> 1e-6, also for queries with one valid token
    Q, P, qm, pm = _case(**case)
    packed, scale = jint4.quantize_tokens_int4(P, pm)
    for qmask in (qm, np.eye(Q.shape[1], dtype=bool)[
            np.arange(Q.shape[0]) % Q.shape[1]]):
        want = np.asarray(maxsim_pallas_int4full(
            *_j(Q, packed, scale, qmask, pm), interpret=True))
        got = cuda_maxsim.maxsim_int4full_plain(
            *_t(Q, packed, scale, qmask, pm)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert np.all(got[:, 2] == 0.0)


def test_int4_valid_zero_scale_token_is_not_masked():
    # a valid all-zero token (scale 0) takes part in the max with sim 0, in
    # both modes, as in the TPU kernel; all other sims of doc 4 are negative
    Q, P, qm, pm = _case(seed=6, nd=5, lp=3)
    Q[0] = np.abs(Q[0])
    P[4] = -np.abs(P[4])
    P[4, 0] = 0.0
    pm[4] = True
    packed, scale = jint4.quantize_tokens_int4(P, pm)
    assert scale[4, 0] == 0.0
    for fn in (lambda *a: cuda_maxsim.maxsim_int4_plain(
            *a, compute=torch.float32), cuda_maxsim.maxsim_int4full_plain):
        got = fn(*_t(Q, packed, scale, qm, pm)).numpy()
        assert got[0, 4] == 0.0


@pytest.mark.parametrize("case", CASES[:3])
def test_int4_plain_versions_rank_as_the_oracle(case):
    # the kernels' numerics (bf16 queries, or int8 queries) keep the
    # oracle's top-3 where the oracle's scores are apart by more than the
    # rounding (bf16 / int8 query codes: <= 3e-2 on these sums)
    Q, P, qm, pm = _case(**case, nd=40)
    packed, scale = jint4.quantize_tokens_int4(P, pm)
    ref = np.asarray(jint4.maxsim_int4_xla(*_j(Q, packed, scale, qm, pm)))
    for fn in (cuda_maxsim.maxsim_int4_plain,
               cuda_maxsim.maxsim_int4full_plain):
        got = fn(*_t(Q, packed, scale, qm, pm)).numpy()
        np.testing.assert_allclose(got, ref, atol=3e-2)
        for q in range(Q.shape[0]):
            for a, b in zip(np.argsort(-got[q], kind="stable")[:3],
                            np.argsort(-ref[q], kind="stable")[:3]):
                assert a == b or abs(ref[q, a] - ref[q, b]) <= 3e-2


def _corpus(seed=7, nd=45, lp=13, d=32, nq=10, lq=5):
    Q, P, qm, pm = _case(seed, nq=nq, lq=lq, nd=nd, lp=lp, d=d)
    # planted: query i copies tokens of doc 3 i + 1 (well separated top-1)
    for i in range(nq):
        src = P[3 * i + 1][pm[3 * i + 1]]
        Q[i] = _unit(src[np.arange(lq) % len(src)]
                     + 0.05 * np.random.default_rng(i).normal(size=(lq, d)))
    return Q.astype(np.float32), P, qm, pm


@pytest.mark.parametrize("q8", [False, True])
def test_int4_engine_matches_jax_engine(q8):
    """The port builds the JAX package's int4 index bit for bit; carried
    over by index_from_numpy it scores the same. Against the JAX engine's
    f32 oracle (impl='xla'): bf16 queries move each score by <= 2e-2, int8
    queries by <= 3e-2; ranks differ only between docs that close."""
    Q, P, qm, pm = _corpus()
    jeng = JaxEngine(mesh=make_mesh(1), dtype="int4", impl="xla").build(P, pm)
    eng = RetrievalEngine(dtype="int4", quantize_queries=q8,
                          device="cpu").build(P, pm)
    assert eng.impl == ("plain_q8" if q8 else "plain")
    ji = jeng.index
    np.testing.assert_array_equal(eng.index.P.numpy(), np.asarray(ji.P))
    np.testing.assert_array_equal(eng.index.scales.numpy(),
                                  np.asarray(ji.scales))
    carried = RetrievalEngine.from_index(
        np.asarray(ji.P), np.asarray(ji.pmask), ji.n_docs,
        scales=np.asarray(ji.scales), dtype="int4", quantize_queries=q8,
        device="cpu")
    np.testing.assert_array_equal(carried.score_all(Q, qm),
                                  eng.score_all(Q, qm))
    tol = 3e-2 if q8 else 2e-2
    ref_scores = np.asarray(jeng.score_all(Q, qm))
    ref_vals, ref_idx = (np.asarray(a) for a in jeng.search_dense(Q, qm, k=5))
    vals, idx = carried.search_dense(Q, qm, k=5)
    np.testing.assert_allclose(vals, ref_vals, atol=tol)
    for q in range(Q.shape[0]):
        for a, b in zip(idx[q], ref_idx[q]):
            assert a == b or abs(ref_scores[q, a] - ref_scores[q, b]) <= tol
    np.testing.assert_array_equal(idx[:, 0], 3 * np.arange(10) + 1)
    assert eng.dim == jeng.dim == 32 and eng.n_docs == jeng.n_docs


@pytest.mark.parametrize("normalize", [True, False])
def test_packed_int4_files_load_in_both_packages(tmp_path, normalize):
    # the port writes the JAX package's bytes; a normalized file serves its
    # codes directly, an unnormalized one is dequantized, normalized and
    # packed again, in both engines; a float engine dequantizes
    from evdr_tpu.data.synthetic import make_synthetic_corpus

    c = make_synthetic_corpus(n_docs=30, n_queries=6, dim=32, seed=4)
    files = {}
    for name, conv in (("jax", jax_convert_payload),
                       ("port", convert_payload_to_packed)):
        files[name] = tmp_path / f"{name}.npz"
        np.savez(files[name], **conv(c, dtype="int4", normalize=normalize))
    with np.load(files["jax"]) as a, np.load(files["port"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    from evdr_tpu_torch.tools.convert_packed import load_packed_payload

    payload = load_packed_payload(files["port"])
    Q, qm = payload["Q_norm"], payload["qmask"]
    for path in files.values():
        eng = RetrievalEngine.from_npz(path, dtype="int4", device="cpu")
        ji = JaxEngine.from_npz(path, mesh=make_mesh(1), dtype="int4",
                                impl="xla").index
        np.testing.assert_array_equal(eng.index.P.numpy(), np.asarray(ji.P))
        np.testing.assert_array_equal(eng.index.scales.numpy(),
                                      np.asarray(ji.scales))
        fl = RetrievalEngine.from_npz(path, dtype="float32", device="cpu")
        _, i1 = eng.search_dense(Q, qm, k=1)
        _, i2 = fl.search_dense(Q, qm, k=1)
        assert np.mean(i1 == i2) >= 0.8   # int4 vs its own dequantization


def test_build_from_codes4_takes_tensors_like_arrays():
    # packed codes made where the index lies (a tensor) enter as numpy ones
    # do; only an int4 engine takes them
    Q, P, qm, pm = _corpus()
    packed, scale = int4.quantize_tokens_int4(*_t(P, pm))
    a = RetrievalEngine(dtype="int4", device="cpu").build_from_codes4(
        packed.numpy(), scale.numpy(), pm)
    b = RetrievalEngine(dtype="int4", device="cpu").build_from_codes4(
        packed, scale, torch.from_numpy(pm))
    for x, y in ((a.index.P, b.index.P), (a.index.scales, b.index.scales),
                 (a.index.pmask, b.index.pmask)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert a.index.n_pad == 64 and a.n_docs == 45
    np.testing.assert_array_equal(a.score_all(Q, qm), b.score_all(Q, qm))
    with pytest.raises(ValueError, match="int4"):
        RetrievalEngine(dtype="int8", device="cpu").build_from_codes4(
            packed, scale, pm)
