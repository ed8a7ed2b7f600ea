"""Every query length and every token width the JAX package serves, in the
torch port, on the CPU.

The kernels take at most a CTA's query-token rows per launch
(``cuda_maxsim.row_cap``) and D a multiple of 16; above the fast kernels'
bound a wrapper launches its library's wide function.
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
- every D above the fast kernels' bound (256; float32 192): each wrapper
  routed to its wide function, the plain versions there against the JAX
  kernels, and engines of every tier at D 320 against the JAX engine.

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
    kernel takes (query tokens within its library's cap, D on its granule
    and, for a fast kernel, within its bound; a wide function's own checks:
    at most 256 query tokens but for K6, K3 without clusters and compact
    books of a 4-byte multiple; 16-byte aligned operands), then writes what
    the kernel computes from the operands it was handed, by the plain
    versions' arithmetic. K5's M and K6's recompute take one query token at
    a time, so that each similarity is the same bits whatever slice of the
    query a launch holds, as the kernels' products are (K5 slices at K1's
    row cap, the fast K6 at its own, the wide K6 takes every token)."""

    def run(lib, func, ops, *args, aligned=()):
        seen.append((lib, func) + tuple(args))
        assert all(t.is_contiguous() for t in ops if t is not None)
        nq, lq, nd, lp, d = args[:5]
        wide = func.endswith("_wide")
        fast = func[:-len("_wide")] if wide else func
        f32 = fast.endswith("_f32")
        comp = torch.float32 if f32 else torch.bfloat16
        assert d >= cm.D_GRANULE and d % cm.D_GRANULE == 0
        if not wide:
            assert d <= (cm.F32_MAX_D if "f32" in fast else cm.MAX_D), func
        if func.startswith("evdr_maxsim_fwd_train"):
            # K5: K1's kernel (or its wide loop) with the M store, in K1's
            # library
            assert lib == ("maxsim_f32" if f32 else "maxsim_bf16")
            assert lq <= cm.row_cap(lib, d)
            q, qw, p, pmask, out, M = ops
            out.copy_(cm._plain_core(q.float(), qw, p, comp,
                                     cm.mask_sentinel(pmask)))
            M.view(nq, lq, nd).copy_(torch.stack([
                cm._plain_core(q[:, t:t + 1].float(), qw[:, t:t + 1], p,
                               comp, cm.mask_sentinel(pmask), want_m=True)[1]
                for t in range(lq)], dim=1))
            return
        if lib == "maxsim_train" and wide:
            # the wide K6: every query token at once, its hit masks, then
            # dQ (nq * lq, d) and dP (nd, lp, d) whole
            q, qw, p, pmask, M, g2, rowbits, colbits, dq_out, dp_out = ops
            assert -(-nq * lq // cm.KERNEL_ROWS) <= 65535
            assert rowbits.shape == (nq * lq, nd, -(-lp // 64), 2)
            assert colbits.shape == (nd * lp, -(-nq * lq // 32))
            assert dq_out.shape == (nq * lq, d) and dp_out.shape == (nd, lp,
                                                                    d)
            dp_out.zero_()
            M3 = M.view(nq, lq, nd)
            dq3 = dq_out.view(nq, lq, d)
            for t in range(lq):
                dq, dp = ct.maxsim_bwd_plain(
                    q[:, t:t + 1].float(), p.float(), qw[:, t:t + 1] > 0,
                    pmask, M3[:, t], g2, comp)
                dq3[:, t] = dq[:, 0]
                dp_out += dp
            return
        if lib == "maxsim_train":
            assert lq <= cm.ROW_CAP[lib]
            # K6: the bound of K5's mode, a cluster of 1-8 CTAs, one dQ
            # partial a doc slice and one dP a cluster of query blocks
            db, cluster = args[5:7]
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
        if lib == "maxsim_pq":
            q, qw, codes, kb, pmask, out = ops
            m = codes.shape[-1]
            assert args[6] == 1 or not wide  # no cluster on the wide path
            if fast == "evdr_maxsim_pq_sum":
                full = kb.to(torch.int32)
            else:
                assert kb.shape[-1] % 4 == 0 and m * kb.shape[-1] == d
                full = cm.pq_full_books(kb, True, d)
            tile = torch.float32 if fast == "evdr_maxsim_pqfull" \
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


# ------------------------------------------ every width: the wide functions

# (D, float32 D) above the fast kernels' bounds (256; float32 192)
WIDE = [(264, 200), (320, 256), (512, 320)]


@pytest.mark.parametrize("d,d32", WIDE)
def test_wide_widths_route_to_the_wide_functions(on_card, d, d32):
    """Above the fast kernels' bound every wrapper launches its library's
    wide function (``<func>_wide``, csrc/maxsim_wide.cuh) on 256-row tiles:
    Lq 300 in two launches (256 + 44 tokens), each counted on its wrapper
    and under the wide function's name in launch_shapes, no ValueError; the
    scores add up to the plain version's (1e-6 relative: summation order
    alone). K3's compact books run the wide compact kernel where their
    stored width is a multiple of 4 bytes (D 320, 512), else the
    full-width one (D 264: 33 -> 34). MaxSimFn: K5 slices as K1 and its
    scores equal K1's bit for bit; the wide K6 takes all 300 tokens in one
    launch; dQ and dP equal the plain pair's (1e-5)."""
    lq = 300
    rng = np.random.default_rng(d)
    cases = []
    for dd in (d, d32):
        Q, P, qm, pm = _t(*_case(dd, nq=2, lq=lq, nd=5, lp=9, d=dd))
        cases += [c for c in _wrapper_cases(Q, P, qm, pm, rng)
                  if (c[0] is cm.maxsim_cuda_f32) == (dd == d32)]
    assert len(cases) == 12
    for wrapper, plain, args in cases:
        n0, k0 = wrapper.launches, len(on_card)
        got = wrapper(*args)
        calls = on_card[k0:]
        assert all(c[1].endswith("_wide") for c in calls), calls
        assert [c[3] for c in calls] == [256, 44], wrapper.__name__
        assert wrapper.launches - n0 == 2
        assert cm.func_launches(calls[0][1]) >= 2
        if wrapper in (cm.maxsim_cuda_pq, cm.maxsim_cuda_pqfull) \
                and args[-1].shape[0] == 8:
            assert calls[0][1] == ("evdr_maxsim_pq_sum_wide" if d == 264
                                   else wrapper.__name__.replace(
                                       "maxsim_cuda", "evdr_maxsim") + "_wide")
        torch.testing.assert_close(got, plain(*args), rtol=1e-6, atol=1e-5,
                                   msg=wrapper.__name__)
        assert got[:, 2].abs().max().item() == 0.0
    for cd, dd in ((torch.bfloat16, d), (torch.float32, d32)):
        Q, P, qm, pm = _t(*_case(dd + 1, nq=2, lq=lq, nd=5, lp=9, d=dd))
        g = torch.from_numpy(rng.normal(size=(2, 5)).astype(np.float32))
        k0 = len(on_card)
        Qg, Pg = Q.clone().requires_grad_(True), P.clone().requires_grad_(True)
        out = ct.MaxSimFn.apply(Qg, Pg, qm, pm, cd)
        out.backward(g)
        suffix = "_f32" if cd == torch.float32 else ""
        assert [(c[1], c[3]) for c in on_card[k0:]] == [
            (f"evdr_maxsim_fwd_train{suffix}_wide", 256),
            (f"evdr_maxsim_fwd_train{suffix}_wide", 44),
            (f"evdr_maxsim_bwd{suffix}_wide", lq)]
        assert torch.equal(out.detach(), cm.maxsim_cuda(Q, P, qm, pm, cd))
        out_p, M_p = ct.maxsim_fwd_train_plain(Q, P, qm, pm, cd)
        dq_p, dp_p = ct.maxsim_bwd_plain(Q, P, qm, pm, M_p, g, cd)
        torch.testing.assert_close(out.detach(), out_p, rtol=1e-6, atol=1e-5)
        torch.testing.assert_close(Qg.grad, dq_p, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(Pg.grad, dp_p, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d,f32_wide,wide", [
    (120, False, False), (136, False, False), (192, False, False),
    (208, True, False), (256, True, False), (272, True, True)])
def test_fast_kernels_keep_every_width_up_to_their_bound(on_card, d,
                                                         f32_wide, wide):
    """The switch between the two instantiations is the fast kernels'
    bound, by D at the kernel width: K2 and K5/K6 bf16 stay fast up to 256,
    the float32 modes (K1, K5, K6) up to 192; the float32 modes take their
    wide functions from 208 (the next width of 16), every mode from 272.
    K6 runs 120 at 128 wide, as K5."""
    Q, P, qm, pm = _t(*_case(1, nq=2, lq=4, nd=3, lp=5, d=d))
    g = torch.ones(2, 3)
    codes, sc = quantize_tokens_int8(P, pm)
    cm.maxsim_cuda_int8(Q, codes, sc, qm, pm)
    cm.maxsim_cuda_f32(Q, P, qm, pm)
    for cd in (torch.bfloat16, torch.float32):
        out, M = ct.maxsim_cuda_fwd_train(Q, P, qm, pm, cd)
        ct.maxsim_cuda_bwd(Q, P, qm, pm, M, g, cd)
    assert all(c[6] == -(-d // 16) * 16 for c in on_card)
    w, w32 = ("_wide" if wide else ""), ("_wide" if f32_wide else "")
    assert [c[1] for c in on_card] == [
        "evdr_maxsim_int8" + w, "evdr_maxsim_f32" + w32,
        "evdr_maxsim_fwd_train" + w, "evdr_maxsim_bwd" + w,
        "evdr_maxsim_fwd_train_f32" + w32, "evdr_maxsim_bwd_f32" + w32]


def _jax_vjp(Q, P, qm, pm, g, jdtype):
    out, vjp = jax.vjp(
        lambda q, p: maxsim_pallas(q, p, jnp.asarray(qm), jnp.asarray(pm),
                                   jdtype, True),
        jnp.asarray(Q), jnp.asarray(P))
    dq, dp = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(dq), np.asarray(dp)


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


WIDE_KERNELS = ["k1", "k1_f32", "k2", "k2full", "k2b", "k2bfull", "k4",
                "k4full", "k3_compact", "k3full_compact", "k3_expanded",
                "k3full_expanded", "k5_k6", "k5_k6_f32"]


@pytest.mark.parametrize("kernel", WIDE_KERNELS)
@pytest.mark.parametrize("d,d32", WIDE)
def test_plain_versions_at_wide_d_match_the_jax_kernels(kernel, d, d32):
    """The plain version each wide kernel is held against on the card, at
    D above the fast bound, against the JAX package's Pallas kernel in
    interpret mode (which pads D to a multiple of 128 and takes any D),
    with the tolerance of the same function's test at D <= 256: K1, K2,
    K2b (deferred=True on both sides), K4 and K3 in f32 compute 1e-5 (the
    bf16 K1 and K5/K6 on bf16 inputs with f32 sums 1e-5), the exact
    integer products of int8full/int4full and of pqfull on compact books
    1e-6 (K2's int8full 1e-5), K3 on expanded books 1e-5; K5's M against
    each row's max of the compute-dtype similarities (float64, 1e-5
    relative), K6's dQ and dP through jax.vjp of maxsim_pallas."""
    from evdr_tpu.ops.int4 import quantize_tokens_int4 as j_int4
    from evdr_tpu.ops.pallas_maxsim import (maxsim_pallas_int4,
                                            maxsim_pallas_int4full,
                                            maxsim_pallas_int8,
                                            maxsim_pallas_int8full,
                                            maxsim_pallas_pq,
                                            maxsim_pallas_pqfull)
    from evdr_tpu.ops.quantize import quantize_tokens_int8 as j_int8

    dd = d32 if kernel.endswith("_f32") else d
    Q, P, qm, pm = _case(dd, nq=2, lq=6, nd=5, lp=9, d=dd)
    rng = np.random.default_rng(dd)
    f32 = dict(compute_dtype=jnp.float32, interpret=True)
    if kernel in ("k1", "k1_f32"):
        cd, jd = ((torch.float32, jnp.float32) if kernel == "k1_f32"
                  else (torch.bfloat16, jnp.bfloat16))
        want = np.asarray(maxsim_pallas(*_j(Q, P, qm, pm), jd, True))
        got = cm.maxsim_plain(*_t(Q, P, qm, pm), compute=cd).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    if kernel.startswith("k2"):
        codes, sc = j_int8(P, pm)
        args = _j(Q, codes, sc, qm, pm)
        deferred = kernel.startswith("k2b")
        if kernel.endswith("full"):
            want = maxsim_pallas_int8full(*args, interpret=True,
                                          deferred=deferred)
            got = cm.maxsim_int8full_plain(*_t(Q, codes, sc, qm, pm))
        else:
            want = maxsim_pallas_int8(*args, deferred=deferred, **f32)
            got = cm.maxsim_int8_plain(*_t(Q, codes, sc, qm, pm),
                                       compute=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        return
    if kernel.startswith("k4"):
        packed, sc = j_int4(P, pm)
        args = _j(Q, packed, sc, qm, pm)
        if kernel == "k4full":
            want = maxsim_pallas_int4full(*args, interpret=True)
            got = cm.maxsim_int4full_plain(*_t(Q, packed, sc, qm, pm))
            tol = 1e-6
        else:
            want = maxsim_pallas_int4(*args, **f32)
            got = cm.maxsim_int4_plain(*_t(Q, packed, sc, qm, pm),
                                       compute=torch.float32)
            tol = 1e-5
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=tol)
        return
    if kernel.startswith("k3"):
        m = 8
        expanded = kernel.endswith("expanded")
        books = (_unit(rng.normal(size=(m, 64, dd))) * 0.3 if expanded
                 else _unit(rng.normal(size=(m, 64, dd // m))) * 0.5
                 ).astype(np.float32)
        codes = rng.integers(0, 64, (5, 9, m), dtype=np.uint8)
        args = (Q, codes, qm, pm, books)
        if kernel.startswith("k3full"):
            want = maxsim_pallas_pqfull(*_j(*args), **f32)
            got = cm.maxsim_pqfull_plain(*_t(*args), compute=torch.float32)
            tol = 1e-5 if expanded else 1e-6
        else:
            want = maxsim_pallas_pq(*_j(*args), **f32)
            got = cm.maxsim_pq_plain(*_t(*args), compute=torch.float32)
            tol = 1e-5
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=tol)
        return
    cd, jd = ((torch.float32, jnp.float32) if kernel.endswith("_f32")
              else (torch.bfloat16, jnp.bfloat16))
    g = rng.normal(size=(2, 5)).astype(np.float32)
    want_out, want_dq, want_dp = _jax_vjp(Q, P, qm, pm, g, jd)
    Qt, Pt, qmt, pmt, gt = _t(Q, P, qm, pm, g)
    out, M = ct.maxsim_fwd_train_plain(Qt, Pt, qmt, pmt, cd)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=1e-5, atol=1e-5)
    sim = np.einsum("qtd,cmd->qtcm", Qt.to(cd).double().numpy(),
                    Pt.to(cd).double().numpy())
    sim = np.where(pm[None, None], sim, -1e30).max(axis=-1)
    np.testing.assert_allclose(M.numpy(), sim.reshape(-1, P.shape[0]),
                               rtol=1e-5, atol=1e-6)
    dq, dp = ct.maxsim_bwd_plain(Qt, Pt, qmt, pmt, M, gt, cd)
    np.testing.assert_allclose(dq.numpy(), want_dq, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dp.numpy(), want_dp, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,q8,pq_opq,tol", [
    ("bfloat16", False, False, 2e-2), ("int8", False, False, 2e-2),
    ("int8", True, False, 3e-2), ("int4", False, False, 2e-2),
    ("int4", True, False, 3e-2), ("pq", False, False, 5e-2),
    ("pq", True, False, 5e-2), ("pq", False, True, 5e-2)])
def test_engines_at_d320_score_as_the_jax_engine(on_card, dtype, q8, pq_opq,
                                                 tol):
    """An index of D = 320 on every tier, built by both packages, scored
    through the wrappers' host sides as on the card (every launch a wide
    function) against the JAX engine (impl='xla', f32) on the same index,
    with the tolerances of the D 40 / 72 test (bf16 queries 2e-2, int8
    queries 3e-2, int8 PQ books 5e-2 over 5 query tokens); top-1 equal."""
    Q, P, qm, pm = _corpus(320, 320)
    kw = dict(pq_m=16, pq_opq=pq_opq) if dtype == "pq" else {}
    jeng = JaxEngine(mesh=make_mesh(1), dtype=dtype, impl="xla",
                     **kw).build(P, pm)
    eng = RetrievalEngine(dtype=dtype, quantize_queries=q8, device="cpu",
                          **kw).build(P, pm)
    assert eng.dim == jeng.dim == 320
    ref = np.asarray(jeng.score_all(Q, qm))
    got = eng.score_all(Q, qm)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    _, idx = eng.search_dense(Q, qm, k=3)
    np.testing.assert_array_equal(idx[:, 0], 3 * np.arange(10) + 1)
    assert on_card and all(c[1].endswith("_wide") for c in on_card)


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
