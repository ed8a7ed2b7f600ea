"""Every query length and every token width the JAX package serves, in the
torch port, on the CPU.

The kernels take at most a CTA's query-token rows per launch
(``cuda_maxsim.row_cap``) and D a multiple of 16 up to a bound.
The wrappers score longer queries in slices whose partial scores add up
(``split_queries``) and zero-pad D; the engine pads its stored index once,
at build, and the queries per call. Here:

- ``split_queries`` driven by the plain versions against one pass of the
  same plain version and against the JAX oracles, at Lq 129 and 200;
- each wrapper's host side, the kernel replaced by a stand-in that computes
  the kernel's function from the operands it is handed and refuses any
  shape the kernel refuses (more query tokens than its cap, D off its
  granule): every wrapper at Lq 129 to 257 and D 40 / 72 against its plain
  version, and ``MaxSimFn`` against the JAX package's custom_vjp; K5 at
  K1's row caps (Lq 200 and 300), its M reassembled from the slices;
- engines of every tier built at D 40 and 72 against the JAX engine
  (``impl='xla'``) on the same index, with ``dim`` the true D;
- the bounds that padding cannot lift, each with its message.

Tolerances: a split changes only the order of f32 additions over query
tokens, so against one pass of the same plain version it holds to 1e-6
relative (sums of <= 300 terms, each addition within 2**-24) and 1e-5
absolute. Zero pad lanes add exact zeros. Against the JAX package's f32
oracles the kernels' numerics apply, as in the other port tests: bf16
inputs move each similarity by <= ~4e-3, int8 query codes by <= ~5e-3,
int4 codes and int8 PQ books by more; summed over <= 200 valid query
tokens (stated per case below).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evdr_tpu.engine import RetrievalEngine as JaxEngine
from evdr_tpu.ops.maxsim import maxsim_numpy as jax_maxsim_numpy
from evdr_tpu.ops.maxsim import maxsim_xla
from evdr_tpu.ops.pallas_maxsim import maxsim_pallas
from evdr_tpu.parallel.mesh import make_mesh
from evdr_tpu_torch import RetrievalEngine
from evdr_tpu_torch.ops import cuda_maxsim as cm
from evdr_tpu_torch.ops import cuda_maxsim_train as ct
from evdr_tpu_torch.ops.int4 import quantize_tokens_int4
from evdr_tpu_torch.ops.quantize import quantize_tokens_int8


def _unit(x):
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)


def _case(seed, nq=3, lq=129, nd=7, lp=11, d=40):
    rng = np.random.default_rng(seed)
    Q = _unit(rng.normal(size=(nq, lq, d))).astype(np.float32)
    P = _unit(rng.normal(size=(nd, lp, d))).astype(np.float32)
    qm = rng.random((nq, lq)) > 0.2
    pm = rng.random((nd, lp)) > 0.2
    qm[:, 0] = True
    pm[2] = False  # a doc with no valid token scores 0
    P = P * pm[..., None]
    return Q, P, qm, pm


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _books(rng, m, k, w, scale=0.5):
    return torch.from_numpy(
        (_unit(rng.normal(size=(m, k, w))) * scale).astype(np.float32))


# ------------------------------------------------------- the split helper


@pytest.mark.parametrize("lq", [129, 200])
@pytest.mark.parametrize("cap", [128, 64])
def test_split_queries_adds_up_to_one_pass(lq, cap):
    """The plain versions scored in slices of ``cap`` tokens against one
    pass (1e-6 relative: only the order of f32 additions differs) and against
    the JAX oracles: maxsim_numpy / maxsim_xla in f32 (1e-4), the bf16
    plain version within 4e-3 per valid query token of the f32 oracle."""
    Q, P, qm, pm = _case(lq, lq=lq)
    Qt, Pt, qmt, pmt = _t(Q, P, qm, pm)
    ref = jax_maxsim_numpy(Q, P, qm, pm)
    np.testing.assert_allclose(
        np.asarray(maxsim_xla(*map(jnp.asarray, (Q, P, qm, pm)))), ref,
        rtol=1e-5, atol=1e-4)
    n_tok = qm.sum(axis=1).max()
    for compute, tol in ((torch.float32, 1e-4), (torch.bfloat16,
                                                 4e-3 * n_tok)):
        def score(q, w, c=compute):
            return cm._plain_core(q.to(c).float(), w, Pt, c,
                                  cm.mask_sentinel(pmt))

        one = score(Qt, qmt.float())
        got = cm.split_queries(score, Qt, qmt.float(), cap)
        torch.testing.assert_close(got, one, rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)
        assert got[:, 2].abs().max().item() == 0.0
    # int8full: the quantized queries slice with their weights
    codes, sc = quantize_tokens_int8(Pt, pmt)
    Q8, qw8 = cm.quantize_queries_int8(Qt, qmt)

    def score8(q, w):
        return cm._plain_core(q.float(), w, codes, torch.float32,
                              cm.mask_sentinel(pmt, sc))

    torch.testing.assert_close(cm.split_queries(score8, Q8, qw8, cap),
                               cm.maxsim_int8full_plain(Qt, codes, sc, qmt,
                                                        pmt),
                               rtol=1e-6, atol=1e-5)


def test_split_queries_within_the_cap_runs_once_on_the_inputs():
    calls = []
    Q, qw = torch.zeros(2, 128, 16), torch.ones(2, 128)
    cm.split_queries(lambda q, w: calls.append((q, w)), Q, qw, 128)
    assert len(calls) == 1 and calls[0][0] is Q and calls[0][1] is qw
    calls.clear()
    cm.split_queries(lambda q, w: calls.append(q.shape[1]) or 0,
                     torch.zeros(2, 300, 16), torch.ones(2, 300), 128)
    assert calls == [128, 128, 44]


# ------------------------------------- the wrappers' host sides, on the CPU


def _kernel_stand_in(seen):
    """A stand-in for ``call_kernel``: checks that the launch is one the
    kernel takes (query tokens within its library's cap, D on its granule,
    16-byte aligned operands), then writes what the kernel computes from
    the operands it was handed, by the plain versions' arithmetic. K5's M
    and K6's recompute take one query token at a time, so that each
    similarity is the same bits whatever slice of the query a launch holds,
    as the kernels' products are (K5 slices at K1's row cap, K6 at its
    own)."""

    def run(lib, func, ops, *args, aligned=()):
        seen.append((lib, func) + tuple(args))
        assert all(t.is_contiguous() for t in ops if t is not None)
        nq, lq, nd, lp, d = args[:5]
        f32 = func.endswith("_f32")
        comp = torch.float32 if f32 else torch.bfloat16
        if func.startswith("evdr_maxsim_fwd_train"):
            # K5: K1's kernel with the M store, in K1's library
            assert lib == ("maxsim_f32" if f32 else "maxsim_bf16")
            assert lq <= cm.row_cap(lib, d) and d % cm.D_GRANULE == 0
            q, qw, p, pmask, out, M = ops
            out.copy_(cm._plain_core(q.float(), qw, p, comp,
                                     cm.mask_sentinel(pmask)))
            M.view(nq, lq, nd).copy_(torch.stack([
                cm._plain_core(q[:, t:t + 1].float(), qw[:, t:t + 1], p,
                               comp, cm.mask_sentinel(pmask), want_m=True)[1]
                for t in range(lq)], dim=1))
            return
        if lib == "maxsim_train":
            assert lq <= cm.ROW_CAP[lib] and d % cm.D_GRANULE == 0
            # K6: the bound of K5's mode, a cluster of 1-8 CTAs, one dQ
            # partial a doc slice and one dP a cluster of query blocks
            db, cluster = args[5:7]
            assert d <= (cm.F32_MAX_D if f32 else cm.MAX_D)
            assert cluster in (1, 2, 4, 8)
            q, qw, p, pmask, M, g2, dq_part, dp_out = ops
            n_qb = -(-nq // (cm.ROW_CAP[lib] // lq))
            assert dp_out.shape == (-(-n_qb // cluster), nd, lp, d)
            assert dq_part.shape == (-(-nd // db), nq * lq, d)
            dq_part.zero_()
            dp_out.zero_()
            M3 = M.view(nq, lq, nd)
            for t in range(lq):
                dq, dp = ct.maxsim_bwd_plain(
                    q[:, t:t + 1].float(), p.float(), qw[:, t:t + 1] > 0,
                    pmask, M3[:, t], g2, comp)
                dq_part[0].view(nq, lq, d)[:, t] = dq[:, 0]
                dp_out[0] += dp
            return
        assert lq <= cm.row_cap(lib, d), (lib, lq)
        assert d % cm.D_GRANULE == 0 and d <= cm.MAX_D
        if lib == "maxsim_pq":
            q, qw, codes, kb, pmask, out = ops
            m = codes.shape[-1]
            if func == "evdr_maxsim_pq_sum":
                full = kb.to(torch.int32)
            else:
                assert kb.shape[-1] % 4 == 0 and m * kb.shape[-1] == d
                full = cm.pq_full_books(kb, True, d)
            tile = torch.float32 if func == "evdr_maxsim_pqfull" \
                else torch.bfloat16
            out.copy_(cm._plain_core(
                q.float(), qw, codes,
                lambda c: cm.pq_decode_int(c, full).to(tile).float(),
                cm.mask_sentinel(pmask)))
            return
        q, qw, p, scales, pmask, out = ops
        if lib == "maxsim_int4":
            decode = lambda x: cm.unpack_int4_torch(x, lp).float()  # noqa
        else:
            decode = torch.float32
        out.copy_(cm._plain_core(q.float(), qw, p, decode,
                                 cm.mask_sentinel(pmask, scales)))

    return run


@pytest.fixture
def on_card(monkeypatch):
    """The wrappers' host sides as they run on the card: every tensor
    treated as a CUDA one, each launch handed to the stand-in (``seen``
    lists them), K6's occupancy that of a card holding 16 clusters, the
    launch counts from 0."""
    seen = []
    monkeypatch.setattr(cm, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(ct, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(ct, "bwd_config", lambda dtype, d, cluster: dict(
        ctas_per_sm=1, clusters=16, stages=3, smem_bytes=0))
    monkeypatch.setattr(cm, "call_kernel", _kernel_stand_in(seen))
    monkeypatch.setattr(ct, "call_kernel", _kernel_stand_in(seen))
    for w in cm.all_wrappers():
        monkeypatch.setattr(w, "launches", 0)
    monkeypatch.setattr(cm, "launch_shapes", cm.Counter())
    return seen


def _wrapper_cases(Q, P, qm, pm, rng):
    """(wrapper, plain version, args) for every forward wrapper."""
    d = Q.shape[-1]
    codes, sc = quantize_tokens_int8(P, pm)
    packed, sc4 = quantize_tokens_int4(P, pm)
    i8, i4 = (Q, codes, sc, qm, pm), (Q, packed, sc4, qm, pm)
    m = 8
    compact = _books(rng, m, 200, d // m)
    expanded = _books(rng, 4, 40, d, 0.3)
    pq_codes = torch.from_numpy(rng.integers(0, 40, (P.shape[0], P.shape[1],
                                                    m), np.uint8))
    opq_codes = pq_codes[..., :4].contiguous()
    return [
        (cm.maxsim_cuda, cm.maxsim_plain, (Q, P.to(torch.bfloat16), qm, pm)),
        (cm.maxsim_cuda_f32,
         lambda *a: cm.maxsim_plain(*a, compute=torch.float32),
         (Q, P, qm, pm)),
        (cm.maxsim_cuda_int8, cm.maxsim_int8_plain, i8),
        (cm.maxsim_cuda_int8full, cm.maxsim_int8full_plain, i8),
        (cm.maxsim_cuda_int8_deferred, cm.maxsim_int8_plain, i8),
        (cm.maxsim_cuda_int8full_deferred, cm.maxsim_int8full_plain, i8),
        (cm.maxsim_cuda_int4, cm.maxsim_int4_plain, i4),
        (cm.maxsim_cuda_int4full, cm.maxsim_int4full_plain, i4),
        (cm.maxsim_cuda_pq, cm.maxsim_pq_plain,
         (Q, pq_codes, qm, pm, compact)),
        (cm.maxsim_cuda_pqfull, cm.maxsim_pqfull_plain,
         (Q, pq_codes, qm, pm, compact)),
        (cm.maxsim_cuda_pq, cm.maxsim_pq_plain,
         (Q, opq_codes, qm, pm, expanded)),
        (cm.maxsim_cuda_pqfull, cm.maxsim_pqfull_plain,
         (Q, opq_codes, qm, pm, expanded)),
    ]


@pytest.mark.parametrize("lq,d", [(129, 40), (200, 72), (200, 128),
                                  (32, 72), (256, 40), (257, 72)])
def test_wrappers_split_and_pad_for_the_kernels(on_card, lq, d):
    """Each forward wrapper's launches take only shapes the kernel takes,
    one launch per slice of ``row_cap`` tokens (counted), and add up to the
    plain version of the whole call (1e-6 relative: summation order
    alone). At Lq 200 and 256 K1 bf16 and float32 and K2b (256 rows a
    launch at these D) launch once, K3 (128) twice; at 257 the first three
    launch twice."""
    rng = np.random.default_rng(lq + d)
    Q, P, qm, pm = _t(*_case(lq + d, lq=lq, d=d))
    for wrapper, plain, args in _wrapper_cases(Q, P, qm, pm, rng):
        n0, k0 = wrapper.launches, len(on_card)
        got = wrapper(*args)
        lib = on_card[-1][0]
        cap = cm.row_cap(lib, cm.kernel_dim(d))
        slices = -(-lq // cap)
        assert wrapper.launches - n0 == len(on_card) - k0 == slices, (
            wrapper.__name__)
        assert [c[3] for c in on_card[k0:]] == [
            min(cap, lq - s * cap) for s in range(slices)]
        want = plain(*args)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5,
                                   msg=wrapper.__name__)
        assert got[:, 2].abs().max().item() == 0.0


@pytest.mark.parametrize("lq,d,tdtype,jdtype", [
    (129, 40, torch.float32, jnp.float32),
    (200, 72, torch.bfloat16, jnp.bfloat16),
    (150, 128, torch.float32, jnp.float32),
    (129, 160, torch.bfloat16, jnp.bfloat16),
    (40, 192, torch.float32, jnp.float32),
    (40, 192, torch.bfloat16, jnp.bfloat16)])
def test_maxsimfn_splits_and_pads_as_the_jax_custom_vjp(on_card, lq, d,
                                                         tdtype, jdtype):
    """MaxSimFn with K5 and K6 run per slice (their host sides on the
    stand-in): scores, dQ and dP against the JAX package's maxsim_pallas
    custom_vjp in interpret mode (which pads Lq and D itself); float32 to
    1e-4, bf16 within bf16's rounding of the inputs (2e-2 on scores summed
    over ~160 tokens, 2e-2 on the gradients). K5 slices at K1's row cap,
    K6 at its own 128 rows; K6's dQ drops its pad columns and dP sums over
    the slices."""
    rng = np.random.default_rng(d)
    Q, P, qm, pm = _case(d, nq=2, lq=lq, nd=5, lp=9, d=d)
    g = rng.normal(size=(2, 5)).astype(np.float32)
    out, vjp = jax.vjp(
        lambda q, p: maxsim_pallas(q, p, jnp.asarray(qm), jnp.asarray(pm),
                                   jdtype, True),
        jnp.asarray(Q), jnp.asarray(P))
    want_dq, want_dp = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    Qt, Pt, qmt, pmt, gt = _t(Q, P, qm, pm, g)
    Qt.requires_grad_(True)
    Pt.requires_grad_(True)
    got = ct.MaxSimFn.apply(Qt, Pt, qmt, pmt, tdtype)
    got.backward(gt)
    lib = "maxsim_f32" if tdtype == torch.float32 else "maxsim_bf16"
    fwd, bwd = ((ct.maxsim_cuda_fwd_train_f32, ct.maxsim_cuda_bwd_f32)
                if tdtype == torch.float32
                else (ct.maxsim_cuda_fwd_train, ct.maxsim_cuda_bwd))
    assert fwd.launches == -(-lq // cm.row_cap(lib, cm.kernel_dim(d)))
    assert bwd.launches == -(-lq // cm.ROW_CAP["maxsim_train"])
    tol = 1e-4 if tdtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=0, atol=tol)
    assert Qt.grad.shape == Qt.shape and Pt.grad.shape == Pt.shape
    np.testing.assert_allclose(Qt.grad.numpy(), want_dq, rtol=0, atol=tol)
    np.testing.assert_allclose(Pt.grad.numpy(), want_dp, rtol=0, atol=tol)


@pytest.mark.parametrize("lq", [200, 300])
@pytest.mark.parametrize("compute,d,cap", [(torch.bfloat16, 72, 256),
                                           (torch.float32, 72, 256),
                                           (torch.float32, 160, 128)])
def test_k5_slices_at_k1s_row_caps_and_reassembles_m(on_card, lq, compute, d,
                                                     cap):
    """K5's host side at its row caps, K1's (bf16 256; float32 256 up to D
    144, 128 above): one launch a slice in K1's library, in order, each
    with its own rows of M; the slices' M rows reassembled in (query,
    token) order equal the plain version's M, and the scores its scores
    (1e-6 relative: summation order over the slices alone), and equal K1's
    on the same inputs bit for bit (the same slices)."""
    Q, P, qm, pm = _t(*_case(lq + d, lq=lq, d=d))
    lib = "maxsim_f32" if compute == torch.float32 else "maxsim_bf16"
    assert cm.row_cap(lib, cm.kernel_dim(d)) == cap
    k0 = len(on_card)
    out, M = ct.maxsim_cuda_fwd_train(Q, P, qm, pm, compute)
    calls = on_card[k0:]
    slices = [min(cap, lq - s) for s in range(0, lq, cap)]
    assert [c[:2] for c in calls] == [(lib, "evdr_maxsim_fwd_train"
                                       + ("_f32" if lib == "maxsim_f32"
                                          else ""))] * len(slices)
    assert [c[3] for c in calls] == slices
    out_p, M_p = ct.maxsim_fwd_train_plain(Q, P, qm, pm, compute)
    assert M.shape == M_p.shape == (Q.shape[0] * lq, P.shape[0])
    torch.testing.assert_close(M, M_p, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(out, out_p, rtol=1e-6, atol=1e-5)
    assert torch.equal(out, cm.maxsim_cuda(Q, P, qm, pm, compute))


# --------------------------------------------------------- the D pad at build


def _corpus(seed, d, nd=40, lp=13, nq=10, lq=5):
    Q, P, qm, pm = _case(seed, nq=nq, lq=lq, nd=nd, lp=lp, d=d)
    pm[2] = True
    # planted: query i copies tokens of doc 3 i + 1 (well separated top-1)
    for i in range(nq):
        src = P[3 * i + 1][pm[3 * i + 1]]
        Q[i] = _unit(src[np.arange(lq) % len(src)]
                     + 0.05 * np.random.default_rng(i).normal(size=(lq, d)))
    qm[:] = True
    return Q.astype(np.float32), P, qm, pm


@pytest.mark.parametrize("d", [40, 72])
@pytest.mark.parametrize("dtype,q8,pq_opq,tol", [
    ("bfloat16", False, False, 2e-2), ("int8", False, False, 2e-2),
    ("int8", True, False, 3e-2), ("int4", False, False, 2e-2),
    ("pq", False, False, 5e-2), ("pq", True, False, 5e-2),
    ("pq", False, True, 5e-2)])
def test_index_padded_once_at_build_scores_as_the_jax_engine(d, dtype, q8,
                                                             pq_opq, tol):
    """An index of D 40 or 72 stores its tokens (or PQ books) zero-padded
    to a multiple of 16, once; ``dim`` reads the true D. Quantized codes
    and books are the JAX engine's (quantized before the pad); the scores
    match the JAX engine (impl='xla', f32) on the same index within the
    kernels' numerics (bf16 queries 2e-2, int8 queries 3e-2, int8 PQ
    books 5e-2 over 5 query tokens), top-1 equal."""
    Q, P, qm, pm = _corpus(d, d)
    kw = dict(pq_m=8, pq_opq=pq_opq) if dtype == "pq" else {}
    jeng = JaxEngine(mesh=make_mesh(1), dtype=dtype, impl="xla",
                     **kw).build(P, pm)
    eng = RetrievalEngine(dtype=dtype, quantize_queries=q8, device="cpu",
                          **kw).build(P, pm)
    ji, ix = jeng.index, eng.index
    assert eng.dim == jeng.dim == d == ix.dim
    if dtype == "pq":
        b, jb = ix.books.numpy(), np.asarray(ji.books)
        m = jb.shape[0]
        w = jb.shape[-1]
        assert (b.shape[-1] if pq_opq else m * b.shape[-1]) % 16 == 0
        np.testing.assert_array_equal(b[..., :w], jb)
        assert not b[..., w:].any()
        np.testing.assert_array_equal(ix.P.numpy(), np.asarray(ji.P))
    else:
        stored = ix.P.float().numpy() if dtype == "bfloat16" \
            else ix.P.numpy()
        jp = np.asarray(ji.P)
        jp = jp.astype(np.float32) if dtype == "bfloat16" else jp
        assert stored.shape[-1] % 16 == 0 and stored.shape[-1] >= d
        np.testing.assert_array_equal(stored[..., :d], jp)
        assert not stored[..., d:].any()
        if ix.scales is not None:
            np.testing.assert_array_equal(ix.scales.numpy(),
                                          np.asarray(ji.scales))
    ref = np.asarray(jeng.score_all(Q, qm))
    got = eng.score_all(Q, qm)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    _, idx = eng.search_dense(Q, qm, k=3)
    np.testing.assert_array_equal(idx[:, 0], 3 * np.arange(10) + 1)


@pytest.mark.parametrize("dtype,q8,pq_opq", [
    ("bfloat16", False, False), ("int8", True, False), ("int8", False, False),
    ("int4", True, False), ("int4", False, False), ("pq", True, False),
    ("pq", False, False), ("pq", False, True)])
def test_engine_serves_long_queries_on_a_narrow_index_through_the_kernels(
        on_card, dtype, q8, pq_opq):
    """search_dense at Lq 200 on a D = 72 index, every tier, through the
    wrappers' host sides as on the card (the stand-in kernel refuses Lq
    above the cap and D off the granule): the same top-k as the CPU
    engine's plain path (1e-6 relative)."""
    Q, P, qm, pm = _corpus(5, 72, lq=200)
    kw = dict(pq_m=8, pq_opq=pq_opq) if dtype == "pq" else {}
    eng = RetrievalEngine(dtype=dtype, quantize_queries=q8, device="cpu",
                          **kw).build(P, pm)
    vals, idx = eng.search_dense(Q, qm, k=5)
    assert on_card and all(c[6] % cm.D_GRANULE == 0 for c in on_card)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cm, "_on_cuda", lambda *t: False)
        want_vals, want_idx = eng.search_dense(Q, qm, k=5)
    np.testing.assert_allclose(vals, want_vals, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(idx[:, 0], want_idx[:, 0])
    np.testing.assert_array_equal(idx[:, 0], 3 * np.arange(10) + 1)


# ------------------------------------------------- bounds padding cannot lift


def test_widths_that_padding_cannot_lift_raise_with_their_bound(on_card):
    """D above 256 (every kernel) and above 192 (K1, K5 and K6 in float32
    mode): the operand tiles live in shared memory and a max over tokens
    does not split over D, so each is refused with its bound; no launch is
    made. K6 takes every D that K5 takes: 136 and 192 launch in both
    modes."""
    rng = np.random.default_rng(0)

    def case(d):
        return _t(*_case(1, nq=2, lq=4, nd=3, lp=5, d=d))

    Q, P, qm, pm = case(264)
    codes, sc = quantize_tokens_int8(P, pm)
    packed, sc4 = quantize_tokens_int4(P, pm)
    pq_codes = torch.from_numpy(rng.integers(0, 8, (3, 5, 8), np.uint8))
    for call in (lambda: cm.maxsim_cuda(Q, P, qm, pm),
                 lambda: cm.maxsim_cuda_int8(Q, codes, sc, qm, pm),
                 lambda: cm.maxsim_cuda_int8full(Q, codes, sc, qm, pm,
                                                 deferred=True),
                 lambda: cm.maxsim_cuda_int4full(Q, packed, sc4, qm, pm),
                 lambda: cm.maxsim_cuda_pq(Q, pq_codes, qm, pm,
                                           _books(rng, 8, 8, 33))):
        with pytest.raises(ValueError,
                           match=r"D must lie in \[1, 256\].*got 264"):
            call()
    Q, P, qm, pm = case(200)
    for call, who in (
            (lambda: cm.maxsim_cuda_f32(Q, P, qm, pm), "K1's float32 mode"),
            (lambda: ct.maxsim_cuda_fwd_train(Q, P, qm, pm, torch.float32),
             "K5's float32 mode")):
        with pytest.raises(ValueError,
                           match=rf"{who}: D must lie in \[1, 192\]"):
            call()
    M = torch.zeros(2 * 4, 3)
    g = torch.ones(2, 3)
    with pytest.raises(ValueError,
                       match=r"K6's float32 mode: D must lie in \[1, 192\]"
                             r".*200"):
        ct.maxsim_cuda_bwd(Q, P, qm, pm, M, g, torch.float32)
    Q, P, qm, pm = case(264)
    with pytest.raises(ValueError, match=r"K6: D must lie in \[1, 256\].*264"):
        ct.maxsim_cuda_bwd(Q, P, qm, pm, M, g)
    assert on_card == []
    assert all(w.launches == 0 for w in cm.all_wrappers())
    # at the bounds themselves the wrappers launch, and K6 at every width
    # K5 takes: 136 and 192 in both modes (and 256 in bf16)
    Q, P, qm, pm = case(192)
    cm.maxsim_cuda_f32(Q, P, qm, pm)
    for d, modes in ((136, (torch.bfloat16, torch.float32)),
                     (192, (torch.bfloat16, torch.float32)),
                     (256, (torch.bfloat16,))):
        Q, P, qm, pm = case(d)
        for cd in modes:
            out, M = ct.maxsim_cuda_fwd_train(Q, P, qm, pm, cd)
            ct.maxsim_cuda_bwd(Q, P, qm, pm, M, g, cd)
            assert on_card[-1][6] == -(-d // cm.D_GRANULE) * cm.D_GRANULE
    assert [c[1] for c in on_card] == ["evdr_maxsim_f32"] + [
        "evdr_maxsim_fwd_train", "evdr_maxsim_bwd",
        "evdr_maxsim_fwd_train_f32", "evdr_maxsim_bwd_f32"] * 2 + [
        "evdr_maxsim_fwd_train", "evdr_maxsim_bwd"]
    Q, P, qm, pm = case(120)
    out, M = ct.maxsim_cuda_fwd_train(Q, P, qm, pm)
    ct.maxsim_cuda_bwd(Q, P, qm, pm, M, g)
    assert on_card[-1][6] == 128  # K6 at 120 runs 128 wide


def test_http_group_with_a_long_query_answers_every_request(on_card):
    """tools/serve_http pads a coalesced group to its longest query: one
    request of 300 tokens beside three of 32 (a group of up to 4) over a
    bf16 engine of D = 72, its launches on the stand-in kernel (which
    refuses more than K1's 256 query tokens a launch, so the group is
    scored in slices). Every request is answered, each with the top-1 of
    search_dense on its own query."""
    import json
    import threading
    import urllib.request

    from evdr_tpu_torch.data.packing import preprocess_queries
    from evdr_tpu_torch.tools.serve_http import make_server

    Q, P, qm, pm = _corpus(11, 72, lq=300)
    eng = RetrievalEngine(dtype="bfloat16", device="cpu").build(P, pm)
    srv = make_server(eng, port=0, batch_wait_ms=300.0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    lens = [300, 32, 32, 32]
    qs = [Q[i, :n] for i, n in enumerate(lens)]
    replies = [None] * len(qs)

    def post(i):
        body = json.dumps({"queries": [qs[i].tolist()], "k": 3}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/search", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            replies[i] = (r.status, json.loads(r.read()))

    try:
        posts = [threading.Thread(target=post, args=(i,))
                 for i in range(len(qs))]
        for t in posts:
            t.start()
        for t in posts:
            t.join(timeout=120)
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    assert all(r is not None and r[0] == 200 for r in replies)
    assert max(r[1]["batched_with"] for r in replies) > 1
    assert max(c[3] for c in on_card) == cm.ROW_CAP["maxsim_bf16"]
    for q, (_, reply) in zip(qs, replies):
        qobj = np.empty(1, dtype=object)
        qobj[0] = q
        Qh, qmh = preprocess_queries(qobj, None, length_multiple=8)
        _, idx = eng.search_dense(Qh, qmh, k=3)
        assert reply["docids"][0][0] == eng.ids_for(idx)[0][0]
