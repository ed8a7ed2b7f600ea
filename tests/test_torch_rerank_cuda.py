"""Stage 2 of pruned search on the card: the int8 rerank kernel
(``csrc/rerank_int8.cu``, ``ops/pruned.rerank_int8_cuda``) and the
dispatcher that routes to it (``ops/pruned.rerank_scores``).

On the CPU: which index takes the kernel (the route decision, no launch),
that every other index and every CPU tensor takes the plain path with no
launch, that the rerank's results do not depend on its query blocks, and
the wrapper's host side with the launch replaced by a stand-in that
computes the kernel's function from the operands it is handed.

On the card (``-m gpu``): the kernel against its plain version
``_rerank_scores`` at ragged shapes, the mesh's stage 2 against one
device's, pruned search at full cover against exact f32 MaxSim, and the
kernel's error against an f64 product at the pruned cell's shape.
Tolerances: the kernel's dot products of codes and query terms are exact
and the plain version's are f32 sums; they differ in the query's split
(each value to within 2**-24 of its row's largest), where the scale
applies (after the sum over D, or on each widened code) and in summation
order, so each token similarity moves by a few ulps (~1e-7 for unit
tokens) and a score, a sum of <= 45 maxima, by <= ~1e-5.

This file imports no JAX: the tests marked ``gpu`` run on the card.
"""

import types

import numpy as np
import pytest
import torch

from evdr_tpu_torch import RetrievalEngine
from evdr_tpu_torch.ops import cuda_maxsim, pruned
from evdr_tpu_torch.ops.int4 import quantize_tokens_int4
from evdr_tpu_torch.ops.quantize import quantize_tokens_int8


def _unit(x):
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)


def _case(seed, nq=5, lq=4, n=23, lp=9, d=16, c=7, n_pad=3):
    """Queries, an index's f32 pages and masks, candidates: masked query
    and page tokens, one real page with no valid token (row 2), ``n_pad``
    padding rows at the end (no valid token), repeated candidates and a
    padding candidate in every row."""
    rng = np.random.default_rng(seed)
    Q = _unit(rng.normal(size=(nq, lq, d))).astype(np.float32)
    qm = rng.random((nq, lq)) > 0.2
    qm[:, 0] = True
    P = _unit(rng.normal(size=(n, lp, d))).astype(np.float32)
    pm = rng.random((n, lp)) > 0.2
    pm[:, 0] = True
    pm[2] = False
    pm[n - n_pad:] = False
    P = P * pm[..., None]
    cand = rng.integers(0, n, size=(nq, c))
    cand[:, 0] = n - 1
    cand[:, 1] = 2
    cand[:, 2] = cand[:, 3]
    return Q, qm, P, pm, cand.astype(np.int64)


def _t(*xs, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in xs]


def _index(kind, P, pm, rng):
    """(stored P, scales, books) of a float32, bf16, int8, int4 or PQ
    index over the pages."""
    Pt, pmt = _t(P, pm)
    if kind == "float32":
        return Pt, None, None
    if kind == "bfloat16":
        return Pt.to(torch.bfloat16), None, None
    if kind == "int8":
        return (*quantize_tokens_int8(Pt, pmt), None)
    if kind == "int4":
        return (*quantize_tokens_int4(Pt, pmt), None)
    m = 4
    books = torch.from_numpy(rng.normal(size=(m, 16, P.shape[-1] // m))
                             .astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 16, P.shape[:2] + (m,),
                                          dtype=np.uint8))
    return codes, None, books


KINDS = ["float32", "bfloat16", "int8", "int4", "pq"]


# ------------------------------------------------------------------ CPU


def _like(dtype, device):
    return types.SimpleNamespace(dtype=dtype, device=torch.device(device))


def test_route_takes_the_kernel_only_for_int8_with_scales_on_cuda():
    """The route decision alone, on stand-ins of an index's tensors (no
    tensor is made on a card, nothing launches): int8 codes with scales
    on a CUDA device take the kernel; without scales, with PQ books,
    packed int4, float32 and bf16 on the card, and int8 on the CPU, the
    plain path."""
    cuda, cpu = "cuda", "cpu"
    sc = _like(torch.float32, cuda)
    books = _like(torch.float32, cuda)
    assert pruned._rerank_on_kernel(_like(torch.int8, cuda), sc, None)
    assert pruned._rerank_on_kernel(_like(torch.int8, "cuda:1"), sc, None)
    for P, scales, bk in [(_like(torch.int8, cuda), None, None),
                          (_like(torch.uint8, cuda), sc, None),
                          (_like(torch.uint8, cuda), None, books),
                          (_like(torch.float32, cuda), None, None),
                          (_like(torch.bfloat16, cuda), None, None),
                          (_like(torch.int8, cpu), _like(torch.float32, cpu),
                           None)]:
        assert not pruned._rerank_on_kernel(P, scales, bk)


@pytest.mark.parametrize("kind", KINDS)
def test_cpu_indexes_take_the_plain_path_and_launch_nothing(kind):
    """Every tier on the CPU (int8 included): rerank_candidates and
    rerank_scores equal the plain _rerank_scores (then the stable top-k),
    and no wrapper's launch count moves."""
    rng = np.random.default_rng(1)
    Q, qm, P, pm, cand = _case(4)
    Pi, sc, books = _index(kind, P, pm, rng)
    Qt, qmt, pmt, ct = _t(Q, qm, pm, cand)
    before = cuda_maxsim.launch_counts()
    assert "rerank_int8_cuda" in before
    want = pruned._rerank_scores(Qt, qmt, Pi, pmt, ct, sc, books, "take")
    got = pruned.rerank_scores(Qt, qmt, Pi, pmt, ct, sc, books, "take")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    v, i = pruned.rerank_candidates(Qt, qmt, Pi, pmt, ct, 4, scales=sc,
                                    books=books, pq_decode="take")
    vs, pos = torch.sort(want, dim=1, descending=True, stable=True)
    torch.testing.assert_close(v, vs[:, :4], rtol=0, atol=0)
    assert torch.equal(i, torch.gather(ct, 1, pos[:, :4]))
    assert bool((want[:, :2] == -torch.inf).all())  # padding, empty page
    assert cuda_maxsim.launch_counts() == before


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("chunk_q", [1, 2, 3, None])
def test_rerank_results_do_not_depend_on_chunk_q(kind, chunk_q):
    """rerank_candidates in blocks of 1, 2 or 3 queries (the last ragged)
    or the default 32 gives the one-block result: each query's candidates
    are scored and selected on their own."""
    rng = np.random.default_rng(2)
    Q, qm, P, pm, cand = _case(5, nq=7)
    Pi, sc, books = _index(kind, P, pm, rng)
    Qt, qmt, pmt, ct = _t(Q, qm, pm, cand)
    kw = dict(scales=sc, books=books, pq_decode="take")
    one = pruned.rerank_candidates(Qt, qmt, Pi, pmt, ct, 5, chunk_q=7, **kw)
    args = (Qt, qmt, Pi, pmt, ct, 5)
    got = (pruned.rerank_candidates(*args, **kw) if chunk_q is None else
           pruned.rerank_candidates(*args, chunk_q=chunk_q, **kw))
    torch.testing.assert_close(got[0], one[0], rtol=0, atol=1e-6)
    assert torch.equal(got[1], one[1])


def _stand_in(seen):
    """A launch of evdr_rerank_int8 computed on the CPU from the operands
    the wrapper hands over (the kernel's shapes and types enforced)."""
    def launch(lib, func, operands, *args, aligned=()):
        q, qw, P, scales, pmask, cand, out = operands
        nq, lq, n_cand, n_rows, lp, d = args
        assert (lib, func) == ("rerank_int8", "evdr_rerank_int8")
        assert q.dtype == torch.float32 and q.shape == (nq, lq, d)
        assert qw.dtype == torch.float32 and qw.shape == (nq, lq)
        assert P.dtype == torch.int8 and P.shape == (n_rows, lp, d)
        assert d % 16 == 0
        assert cand.dtype == torch.int64 and cand.shape == (nq, n_cand)
        assert all(t.is_contiguous() for t in operands)
        seen.append(args)
        with pruned._f32_products():
            out.copy_(pruned._rerank_scores(q, qw > 0, P, pmask, cand,
                                            scales))
    return launch


@pytest.fixture
def on_card(monkeypatch):
    """The int8 route taken as on the card: CPU tensors treated as CUDA
    ones, each launch handed to the stand-in (``seen`` lists them), the
    wrapper's count from 0."""
    seen = []
    monkeypatch.setattr(pruned, "_rerank_on_kernel",
                        lambda P, scales, books: books is None
                        and scales is not None and P.dtype == torch.int8)
    monkeypatch.setattr(pruned, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(pruned, "call_kernel", _stand_in(seen))
    monkeypatch.setattr(pruned.rerank_int8_cuda, "launches", 0)
    return seen


@pytest.mark.parametrize("d", [16, 40, 128])
def test_kernel_route_scores_every_query_in_one_launch(on_card, d):
    """On the kernel route rerank_candidates launches once per call
    whatever chunk_q is, D off the kernel's granule zero-padded (exact),
    and its results equal the plain path's."""
    Q, qm, P, pm, cand = _case(6, nq=9, lq=33, d=d)
    Qt, qmt, pmt, ct = _t(Q, qm, pm, cand)
    codes, sc = quantize_tokens_int8(*_t(P, pm))
    with pruned._f32_products():
        want = pruned._rerank_scores(Qt, qmt, codes, pmt, ct, sc)
    for n, chunk_q in enumerate((1, 4, 32), start=1):
        v, i = pruned.rerank_candidates(Qt, qmt, codes, pmt, ct, 5,
                                        scales=sc, chunk_q=chunk_q)
        assert pruned.rerank_int8_cuda.launches == n
        vs, pos = torch.sort(want, dim=1, descending=True, stable=True)
        torch.testing.assert_close(v, vs[:, :5], rtol=0, atol=1e-6)
        assert torch.equal(i, torch.gather(ct, 1, pos[:, :5]))
    assert [a[-1] for a in on_card] == [-(-d // 16) * 16] * 3
    with pytest.raises(ValueError, match="cand_idx"):
        pruned.rerank_int8_cuda(Qt, qmt, codes, pmt, ct.float(), sc)


def test_mesh_stage2_launches_once_a_shard(on_card):
    """sharded_rerank on a mesh of two (CPU) shards takes the kernel route
    once per shard and equals the one-device rerank."""
    from evdr_tpu_torch.parallel.mesh import mesh_of
    from evdr_tpu_torch.parallel.sharded_index import build_sharded_index
    from evdr_tpu_torch.parallel.topk import sharded_rerank

    Q, qm, P, pm, cand = _case(8, nq=6, n=150, n_pad=0, c=20)
    Qt, qmt, ct = _t(Q, qm, cand)
    one = build_sharded_index(P, pm, "cpu", dtype="int8")
    two = build_sharded_index(P, pm, mesh_of(["cpu"] * 2), dtype="int8")
    v1, i1 = pruned.rerank_candidates(Qt, qmt, one.P, one.pmask, ct, 10,
                                      scales=one.scales)
    assert pruned.rerank_int8_cuda.launches == 1
    v2, i2 = sharded_rerank(Qt, qmt, two, ct, 10)
    assert pruned.rerank_int8_cuda.launches == 3
    torch.testing.assert_close(v2, v1, rtol=0, atol=1e-6)
    assert torch.equal(i2, i1)


# ------------------------------------------------------------------ card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.set_float32_matmul_precision("highest")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("lq,lp,d", [
    (1, 9, 128), (27, 768, 128), (32, 768, 128), (32, 9, 64),
    (27, 300, 48), (45, 257, 128), (32, 768, 40), (32, 70, 256),
    (33, 130, 144)])
def test_rerank_kernel_matches_plain_version_on_the_card(lq, lp, d):
    """The kernel against _rerank_scores on the card: masked query and
    page tokens, a real page with no valid token and padding rows (-inf,
    exactly where the plain version has it), repeated candidates; Lq 1,
    27, 32, 33 and 45 (passes of 32 rows), Lp 9 to 768 (stages of 64
    tokens, a ragged last one), D 128, 64, 48, 40 (padded to 48), 256 and
    144 (chunks of 128 dims, a ragged last one). Finite scores within 1e-5
    (module docstring); one launch a call."""
    dev = _cuda()
    Q, qm, P, pm, cand = _case(lq + lp + d, nq=11, lq=lq, n=61, lp=lp, d=d,
                               c=37)
    Qt, qmt, Pt, pmt, ct = _t(Q, qm, P, pm, cand, device=dev)
    codes, sc = quantize_tokens_int8(Pt, pmt)
    n0 = pruned.rerank_int8_cuda.launches
    got = pruned.rerank_scores(Qt, qmt, codes, pmt, ct, sc, chunk_q=2)
    torch.cuda.synchronize()
    assert pruned.rerank_int8_cuda.launches == n0 + 1
    with pruned._f32_products():
        want = pruned._rerank_scores(Qt, qmt, codes, pmt, ct, sc)
    dead = want == -torch.inf
    assert bool(dead[:, :2].all())
    assert torch.equal(got == -torch.inf, dead)
    torch.testing.assert_close(got[~dead], want[~dead], rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_mesh_stage2_equals_one_device_on_the_card():
    """Pruned int8 search on a mesh of two shards of the card (each shard
    reranking the candidates it owns through the kernel, one launch a
    shard) equals the one-device engine bit for bit."""
    from evdr_tpu_torch.parallel.mesh import mesh_of

    dev = _cuda()
    rng = np.random.default_rng(11)
    P = _unit(rng.normal(size=(300, 70, 128))).astype(np.float32)
    pm = rng.random((300, 70)) > 0.1
    Q = _unit(rng.normal(size=(12, 27, 128))).astype(np.float32)
    qm = rng.random((12, 27)) > 0.1
    one = RetrievalEngine(dtype="int8", prune_centroids=4,
                          device=dev).build(P, pm)
    two = RetrievalEngine(dtype="int8", prune_centroids=4,
                          mesh=mesh_of([dev] * 2)).build(P, pm)
    for nc in (40, 300):
        n0 = pruned.rerank_int8_cuda.launches
        v2, i2 = two.search_dense(Q, qm, k=10, n_candidates=nc)
        assert pruned.rerank_int8_cuda.launches == n0 + 2
        v1, i1 = one.search_dense(Q, qm, k=10, n_candidates=nc)
        np.testing.assert_array_equal(v2, v1)
        np.testing.assert_array_equal(i2, i1)


@pytest.mark.gpu
@pytest.mark.parametrize("q8", [False, True])
def test_pruned_int8_search_at_full_cover_is_exact_on_the_card(q8):
    """At n_candidates = n_docs pruned int8 search through the kernel (one
    launch a call) returns exact f32 MaxSim's top-10 over the dequantized
    index, in its order at every rank untied by more than 1e-4, with its
    scores (1e-5)."""
    from evdr_tpu_torch.ops.maxsim import maxsim_torch
    from evdr_tpu_torch.parallel.topk import _select_topk

    dev = _cuda()
    rng = np.random.default_rng(12 + q8)
    nd, lp, d, nq, k = 400, 90, 128, 16, 10
    P = _unit(rng.normal(size=(nd, lp, d))).astype(np.float32)
    pm = rng.random((nd, lp)) > 0.1
    pm[5] = False
    Q = _unit(rng.normal(size=(nq, 32, d))).astype(np.float32)
    qm = rng.random((nq, 32)) > 0.15
    qm[:, 0] = True
    eng = RetrievalEngine(dtype="int8", quantize_queries=q8,
                          prune_centroids=4, device=dev).build(P, pm)
    n0 = pruned.rerank_int8_cuda.launches
    vals, idx = eng.search_dense(Q, qm, k=k, n_candidates=nd)
    assert pruned.rerank_int8_cuda.launches == n0 + 1
    ix = eng.index
    T = ix.P[:nd].float() * ix.scales[:nd][..., None]
    Qd, qmd = _t(Q, qm, device=dev)
    sc = maxsim_torch(Qd, T, qmd, ix.pmask[:nd])
    sc[:, 5] = -torch.inf
    ve, ie = (x.cpu().numpy() for x in _select_topk(sc, k + 1))
    np.testing.assert_allclose(vals, ve[:, :k], rtol=0, atol=1e-5)
    step = ve[:, :-1] - ve[:, 1:]
    above = np.concatenate([np.full((nq, 1), np.inf), step], axis=1)
    untied = (above[:, :k] > 1e-4) & (step[:, :k] > 1e-4)
    assert untied.sum() > nq * k // 2
    assert (ie[:, :k][untied] == idx[untied]).all()


def _f64_scores(Q, qm, codes, scales, pm, cand):
    """The rerank's scores in f64, query by query: the exact value both
    f32 paths round."""
    out = torch.empty(cand.shape, dtype=torch.float64, device=Q.device)
    for q in range(Q.shape[0]):
        c = cand[q]
        T = codes[c].double() * scales[c].double()[..., None]
        sim = torch.einsum("nd,cmd->cnm", Q[q].double(), T)
        sim = sim.masked_fill(~pm[c][:, None, :], -1e4)
        mx = sim.amax(dim=-1) * qm[q].double()
        out[q] = torch.where(pm[c].any(-1), mx.sum(-1), -torch.inf)
    return out


@pytest.mark.gpu
def test_rerank_kernel_error_against_f64_at_the_cell_shape():
    """At the pruned cell's shape (256 queries x 32 tokens, 416 candidates
    of 768 x 128, 15% / 10% of query / page tokens masked) over 2,000
    int8 pages, the kernel's and the plain version's scores against an
    f64 product: the kernel's RMS relative error within 2x the plain
    version's and its largest within 1e-6 (both end in a few f32 roundings
    of 2**-24); no one-sided bias, the mean signed error within a quarter
    of the mean absolute one. The kernel's term sums are exact, so only
    the query's split (rounded to nearest) and the f32 adds, scale and
    row sum round; tensor-core sums of terms split value by value round
    toward zero and read about -0.44 there (PERF.md, PR 17)."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(5)
    n, lp, d, nq, lq, c = 2000, 768, 128, 256, 32, 416
    P = torch.randn((n, lp, d), generator=g, device=dev)
    P = P / P.norm(dim=-1, keepdim=True)
    pm = torch.rand((n, lp), generator=g, device=dev) >= 0.1
    codes, sc = quantize_tokens_int8(P * pm[..., None], pm)
    del P
    Q = torch.randn((nq, lq, d), generator=g, device=dev)
    Q = Q / Q.norm(dim=-1, keepdim=True)
    qm = torch.rand((nq, lq), generator=g, device=dev) >= 0.15
    qm[:, 0] = True
    cand = torch.randint(0, n, (nq, c), generator=g, device=dev)
    got = pruned.rerank_int8_cuda(Q, qm, codes, pm, cand, sc)
    with pruned._f32_products():
        plain = torch.cat([pruned._rerank_scores(
            Q[s:s + 8], qm[s:s + 8], codes, pm, cand[s:s + 8], sc)
            for s in range(0, nq, 8)])
    ref = _f64_scores(Q, qm, codes, sc, pm, cand)
    rel_k = (got.double() - ref) / ref.abs()
    rel_p = (plain.double() - ref) / ref.abs()
    rms_k = float(rel_k.pow(2).mean().sqrt())
    rms_p = float(rel_p.pow(2).mean().sqrt())
    assert rms_k <= 2 * rms_p and float(rel_k.abs().max()) <= 1e-6
    assert abs(float(rel_k.mean())) <= 0.25 * float(rel_k.abs().mean())
