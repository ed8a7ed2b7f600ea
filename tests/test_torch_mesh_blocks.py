"""Block builds and the mesh's spans and byte counter, on the CPU.

``RetrievalEngine.build_blocks`` indexes a corpus given as a function of a
row range; the index it builds on a 4-shard mesh of repeated CPU devices
(``parallel/mesh.mesh_of``) and on one device is held bit for bit to
``build`` of the whole array, with the build's blocks cutting across
the source's own blocks and an uneven last shard. Exact search over it is
held to the benchmark's plain references (``evdr_bench/reference.py`` and,
for int4 pages searched by int8 queries, ``evdr_bench/reference_int4q8.py``:
quantized scores in f32, stable top-k). A mesh of ``cpu:0`` .. ``cpu:3``
stands in for four devices where the byte counter needs distinct ones. The
kernels' count of index bytes (``cuda_maxsim.INDEX_BYTES_READ``) is driven
through a stand-in launch, and the device query quantizer is held to the
reference's.
"""

import numpy as np
import pytest
import torch

from evdr_bench import check, reference, reference_int4q8
from evdr_tpu_torch import RetrievalEngine
from evdr_tpu_torch.ops import cuda_maxsim
from evdr_tpu_torch.parallel import mesh as mesh_mod
from evdr_tpu_torch.parallel import sharded_index, topk
from evdr_tpu_torch.parallel.mesh import mesh_of
from evdr_tpu_torch.utils.timing import trace_ctx

# 203 docs pad to 256 on 4 shards of 64 rows: the last shard holds 11
N, LP, D, NQ, LQ, K = 203, 10, 32, 8, 5, 10
# the source makes its rows in blocks of 10, the build asks for 7 at a time
SOURCE_BLOCK, BUILD_BLOCK = 10, 7
DISTINCT = ["cpu:0", "cpu:1", "cpu:2", "cpu:3"]


@pytest.fixture(autouse=True)
def build_blocks_of_seven(monkeypatch):
    monkeypatch.setattr(sharded_index, "BLOCK_ROWS", BUILD_BLOCK)


def _unit(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def _corpus(seed=0, lp=LP):
    g = torch.Generator().manual_seed(seed)
    P = _unit(torch.randn((N, lp, D), generator=g))
    pm = torch.rand((N, lp), generator=g) > 0.15
    pm[:, 0] = True
    pm[5] = False
    P = P * pm[..., None]
    src = torch.randint(0, N, (NQ,), generator=g)
    Q = _unit(P[src, :LQ] + 0.05 * torch.randn((NQ, LQ, D), generator=g))
    qm = torch.ones((NQ, LQ), dtype=torch.bool)
    qm[:, -1] = torch.rand(NQ, generator=g) > 0.5
    return P, pm, Q, qm


class Source:
    """Rows [lo, hi) of (P, pmask), cut from blocks of SOURCE_BLOCK rows
    made one at a time; records every call."""

    def __init__(self, P, pm):
        self.P, self.pm, self.calls = P, pm, []

    def __call__(self, lo, hi, device):
        self.calls.append((lo, hi, torch.device(device)))
        b0, b1 = lo // SOURCE_BLOCK, -(-hi // SOURCE_BLOCK)
        blocks = [(self.P[b * SOURCE_BLOCK:(b + 1) * SOURCE_BLOCK].clone(),
                   self.pm[b * SOURCE_BLOCK:(b + 1) * SOURCE_BLOCK].clone())
                  for b in range(b0, b1)]
        s = lo - b0 * SOURCE_BLOCK
        Pb = torch.cat([p for p, _ in blocks])[s:s + hi - lo]
        mb = torch.cat([m for _, m in blocks])[s:s + hi - lo]
        return Pb.to(device), mb.to(device)


def _parts(ix):
    return [ix] if ix.parts is None else ix.parts


def _assert_same_index(a, b):
    assert (a.n_docs, a.n_pad, a.dim) == (b.n_docs, b.n_pad, b.dim)
    for pa, pb in zip(_parts(a), _parts(b), strict=True):
        assert pa.n_docs == pb.n_docs
        assert pa.P.dtype == pb.P.dtype and pa.P.device == pb.P.device
        same = (pa.P.view(torch.int16), pb.P.view(torch.int16)) \
            if pa.P.dtype == torch.bfloat16 else (pa.P, pb.P)
        assert torch.equal(*same)
        assert torch.equal(pa.pmask, pb.pmask)
        assert (pa.scales is None) == (pb.scales is None)
        if pa.scales is not None:
            assert torch.equal(pa.scales, pb.scales)


@pytest.mark.parametrize("place", ["mesh4", "one"])
@pytest.mark.parametrize("dtype,normalize,lp", [("int8", False, LP),
                                                ("int8", True, LP),
                                                ("bfloat16", False, LP),
                                                ("float32", True, LP),
                                                ("int4", False, LP),
                                                ("int4", True, LP),
                                                ("int4", True, LP - 1)])
def test_block_build_is_bit_equal_to_a_whole_build(place, dtype, normalize,
                                                   lp):
    P, pm, Q, qm = _corpus(lp=lp)
    mesh = mesh_of(["cpu"] * 4) if place == "mesh4" else None
    kw = dict(dtype=dtype, device="cpu", mesh=mesh, quantize_queries=True)
    src = Source(P, pm)
    blk = RetrievalEngine(**kw).build_blocks(src, N, normalize=normalize)
    whole = RetrievalEngine(**kw).build(P, pm, normalize=normalize)
    _assert_same_index(blk.index, whole.index)
    # every call asks for at most a block of one shard's own rows
    rows = blk.index.shard_rows
    for lo, hi, dev in src.calls:
        assert 0 < hi - lo <= BUILD_BLOCK and hi <= N
        assert lo // rows == (hi - 1) // rows
        assert dev == torch.device("cpu")
    covered = sorted((lo, hi) for lo, hi, _ in src.calls)
    assert covered[0][0] == 0 and covered[-1][1] == N
    assert all(a[1] == b[0] for a, b in zip(covered, covered[1:]))
    got = blk.search_dense(Q, qm, k=K)
    want = whole.search_dense(Q, qm, k=K)
    assert np.array_equal(got[1], want[1])
    assert np.array_equal(got[0], want[0])


def test_blocks_reach_the_shards_in_turn():
    """The build hands one block to each shard in turn, so the shards'
    devices fill at once rather than one after another."""
    P, pm, _, _ = _corpus()
    src = Source(P, pm)
    eng = RetrievalEngine(dtype="int8", device="cpu:0", normalize=False,
                          mesh=mesh_of(DISTINCT))
    eng.build_blocks(src, N)
    rows = eng.index.shard_rows
    first = [lo // rows for lo, _, _ in src.calls[:4]]
    assert first == [0, 1, 2, 3]
    assert [d.index for _, _, d in src.calls[:4]] == [0, 1, 2, 3]


@pytest.mark.parametrize("place", ["mesh4", "one"])
@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_exact_search_over_blocks_equals_the_plain_reference(place, dtype):
    P, pm, Q, qm = _corpus(3)
    mesh = mesh_of(["cpu"] * 4) if place == "mesh4" else None
    eng = RetrievalEngine(dtype=dtype, quantize_queries=True, device="cpu",
                          mesh=mesh, normalize=False)
    eng.build_blocks(Source(P, pm), N)
    vals, idx = eng.search_dense(Q, qm, k=K)
    if dtype == "int8":
        ref = reference.quantized_scores(Q, qm, P, pm, 127)
    else:
        with reference.precision():
            ref = reference_int4q8.scores(Q, qm, P, pm)
    want_v, want_i = torch.sort(ref, dim=1, descending=True, stable=True)
    gaps = check.topk_gaps(vals, idx, ref, K, exact=True)
    assert gaps["score_gap"] <= 1e-6 and gaps["rank_gap"] <= 1e-6, gaps
    np.testing.assert_allclose(vals, want_v[:, :K].numpy(), rtol=1e-6,
                               atol=1e-6)
    # the same docs, rank by rank, wherever the reference has no near tie
    top = want_v[:, :K + 1].numpy()
    untied = np.minimum(np.abs(np.diff(top, axis=1))[:, :K],
                        np.abs(np.diff(top[:, :K], axis=1,
                                       prepend=np.inf))) > 1e-5
    assert np.array_equal(idx[untied], want_i[:, :K].numpy()[untied])


@pytest.mark.parametrize("kw", [dict(dtype="pq"),
                                dict(dtype="int8", prune_centroids=2)])
def test_block_builds_refuse_what_needs_the_whole_array(kw):
    P, pm, _, _ = _corpus()
    eng = RetrievalEngine(device="cpu", mesh=mesh_of(["cpu"] * 4), **kw)
    with pytest.raises(ValueError, match="build_blocks"):
        eng.build_blocks(Source(P, pm), N)


def test_every_new_span_fires_under_a_profiler(tmp_path):
    import json

    P, pm, Q, qm = _corpus()
    eng = RetrievalEngine(dtype="int8", quantize_queries=True,
                          device="cpu:0", mesh=mesh_of(DISTINCT),
                          normalize=False)
    with trace_ctx(tmp_path):
        eng.build_blocks(Source(P, pm), N)
        eng.search_dense(Q, qm, k=K)
    with open(tmp_path / "trace.json") as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"]
    blocks = sum(-(-min(64, N - 64 * c) // BUILD_BLOCK) for c in range(4))
    assert names.count("evdr.index.build_block") == blocks
    assert names.count("evdr.mesh.shard") == 4
    assert names.count("evdr.mesh.merge") == 1
    # 3 query copies and 3 mask copies out, 2 gathers of candidates back
    assert names.count("evdr.mesh.gather") == 8


def _counted(eng, Q, qm):
    before = dict(mesh_mod.TRANSFER_BYTES)
    eng.search_dense(Q, qm, k=K)
    return {k: v - before[k] for k, v in mesh_mod.TRANSFER_BYTES.items()}


def test_the_byte_counter_counts_what_crosses_between_devices():
    P, pm, Q, qm = _corpus()
    kw = dict(dtype="int8", quantize_queries=True, normalize=False)
    four = RetrievalEngine(mesh=mesh_of(DISTINCT), **kw).build(P, pm)
    got = _counted(four, Q, qm)
    # queries and masks to the three other devices; from each of them
    # NQ x K candidates (f32 score, int64 id) back to the first
    assert got == {"queries": 3 * (Q.numel() * 4 + qm.numel()),
                   "candidates": 3 * NQ * K * (4 + 8), "scores": 0}
    # a mesh of one device repeated moves nothing between devices
    rep = RetrievalEngine(mesh=mesh_of(["cpu"] * 4), device="cpu",
                          **kw).build(P, pm)
    assert sum(_counted(rep, Q, qm).values()) == 0
    blocks = [torch.zeros((NQ, K)) for _ in range(4)]
    before = mesh_mod.transfer_bytes()
    mesh_mod.gather_blocks(blocks, mesh_of(["cpu"] * 4), "cpu",
                           "candidates")
    assert mesh_mod.transfer_bytes() == before


def test_the_merge_is_the_shards_candidates_in_one_stable_sort():
    """``merge_shard_topk`` on the shards' own outputs gives the mesh's
    answer, and a merge that leaves a shard out loses its docs."""
    P, pm, Q, qm = _corpus(5)
    eng = RetrievalEngine(dtype="int8", quantize_queries=True, device="cpu",
                          mesh=mesh_of(["cpu"] * 4), normalize=False)
    eng.build(P, pm)
    ix = eng.index
    shards = topk.shard_queries(torch.as_tensor(Q), torch.as_tensor(qm),
                                 ix.mesh)
    outs = [topk.shard_topk(q, m, ix, i, K, eng.impl)
            for i, (q, m) in enumerate(shards)]
    v, i = topk.merge_shard_topk([o[0] for o in outs], [o[1] for o in outs],
                                 ix.mesh, K, NQ)
    want = eng.search_dense(Q, qm, k=K)
    assert np.array_equal(i.numpy(), want[1])
    assert np.array_equal(v.numpy(), want[0])
    dropped = [o[0] if s else torch.full_like(o[0], -torch.inf)
               for s, o in enumerate(outs)]
    _, i0 = topk.merge_shard_topk(dropped, [o[1] for o in outs], ix.mesh,
                                  K, NQ)
    assert not (i0.numpy() < ix.shard_rows).any()


def _stand_in(lib, func, operands, *args, aligned=()):
    """A launch that writes zero scores, as the kernel's host side sees it:
    the output is the last operand."""
    operands[-1].zero_()


@pytest.mark.parametrize("dtype", ["int8", "int4", "bfloat16"])
@pytest.mark.parametrize("nq,lq,slices", [(32, 32, 1), (4, 1024, 4)])
def test_the_index_byte_counter_counts_every_query_slice(dtype, nq, lq,
                                                         slices,
                                                         monkeypatch):
    """A launch takes every query of a call, at most 256 tokens of each:
    32 queries of 32 tokens make one launch, queries of 1,024 tokens four
    slices, and each launch covers the whole index once."""
    P, pm, _, _ = _corpus()
    eng = RetrievalEngine(dtype=dtype, quantize_queries=True, device="cpu",
                          normalize=False).build(P, pm)
    ix = eng.index
    want = sum(t.numel() * t.element_size()
               for t in (ix.P, ix.scales, ix.pmask) if t is not None)
    g = torch.Generator().manual_seed(7)
    Q = _unit(torch.randn((nq, lq, D), generator=g))
    qm = torch.ones((nq, lq), dtype=torch.bool)
    before = cuda_maxsim.index_bytes_read()
    eng.search_dense(Q, qm, k=K)
    assert cuda_maxsim.index_bytes_read() == before, "the plain path counts"
    monkeypatch.setattr(cuda_maxsim, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_maxsim, "call_kernel", _stand_in)
    lib = {"int8": "maxsim_int8", "int4": "maxsim_int4",
           "bfloat16": "maxsim_bf16"}[dtype]
    by_lib = dict(cuda_maxsim.INDEX_BYTES_READ)
    eng.search_dense(Q, qm, k=K)
    assert cuda_maxsim.index_bytes_read() - before == slices * want
    assert cuda_maxsim.INDEX_BYTES_READ[lib] - by_lib[lib] == slices * want


@pytest.mark.parametrize("scale", [1.0, 3.7e-3, 251.0])
def test_the_query_quantizer_is_the_reference_bit_for_bit(scale):
    g = torch.Generator().manual_seed(11)
    Q = torch.randn((16, 32, D), generator=g) * scale
    Q[0, 3] = 0.0
    qm = torch.ones((16, 32), dtype=torch.bool)
    codes, qw = cuda_maxsim.quantize_queries_int8(Q, qm)
    want_codes, want_scale = reference.quantize(Q, 127)
    assert torch.equal(codes.float(), want_codes)
    assert torch.equal(qw, want_scale)
