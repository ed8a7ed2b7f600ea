"""The torch port's MaxSim scorers against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
plain versions of the CUDA kernels (``evdr_tpu_torch.ops.cuda_maxsim``) are
held against the Pallas kernels in interpret mode, as the JAX package's own
tests run them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evdr_tpu.ops.maxsim import maxsim_numpy as jax_maxsim_numpy
from evdr_tpu.ops.maxsim import maxsim_xla
from evdr_tpu.ops.maxsim import score_multi_vector as jax_score_multi
from evdr_tpu.ops.maxsim import score_single_vector as jax_score_single
from evdr_tpu.ops.pallas_maxsim import (maxsim_pallas, maxsim_pallas_int8,
                                        maxsim_pallas_int8full)
from evdr_tpu.ops.quantize import quantize_tokens_int8 as jax_quantize
from evdr_tpu_torch.ops import cuda_maxsim
from evdr_tpu_torch.ops.maxsim import (maxsim_numpy, maxsim_torch,
                                       score_multi_vector,
                                       score_single_vector)
from evdr_tpu_torch.ops.quantize import quantize_tokens_int8


def _unit(x):
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)


def _case(seed, nq=4, lq=7, nd=9, lp=19, d=32, negative=False):
    """Masked random inputs with one all-invalid doc and one all-masked
    query; ``negative`` makes every similarity of query 0 negative."""
    rng = np.random.default_rng(seed)
    Q = _unit(rng.normal(size=(nq, lq, d))).astype(np.float32)
    P = _unit(rng.normal(size=(nd, lp, d))).astype(np.float32)
    if negative:
        P[:, :, :] = -np.abs(P)
        Q[0] = np.abs(Q[0])
    qm = rng.random((nq, lq)) > 0.2
    pm = rng.random((nd, lp)) > 0.2
    pm[2] = False       # a doc with no valid token scores 0
    qm[1] = False       # an all-masked query scores 0
    qm[0, 0] = True
    P = P * pm[..., None]
    return Q, P, qm, pm


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


CASES = [dict(seed=0), dict(seed=1, lq=5, lp=37, d=48),
         dict(seed=2, negative=True), dict(seed=3, nq=2, nd=3, lp=3)]


@pytest.mark.parametrize("case", CASES)
def test_maxsim_torch_matches_numpy_and_xla(case):
    # f32 everywhere; only summation order differs -> 1e-5
    Q, P, qm, pm = _case(**case)
    want_np = jax_maxsim_numpy(Q, P, qm, pm)
    want_xla = np.asarray(maxsim_xla(*_j(Q, P, qm, pm), chunk_p=4))
    for chunk in (1, 4, 128):
        got = maxsim_torch(*_t(Q, P, qm, pm), chunk_p=chunk).numpy()
        np.testing.assert_allclose(got, want_np, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, want_xla, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(maxsim_numpy(Q, P, qm, pm), want_np)
    assert np.all(got[:, 2] == 0.0) and np.all(got[1] == 0.0)
    if case.get("negative"):
        assert np.all(got[0][pm.any(axis=1)] < 0)  # negatives are kept


def test_maxsim_torch_grads_match_jax_vjp():
    # gradients route to the argmax token in both; f32 -> 1e-5
    Q, P, qm, pm = _case(seed=4)
    g = np.random.default_rng(5).normal(size=(Q.shape[0], P.shape[0])
                                        ).astype(np.float32)
    _, vjp = jax.vjp(lambda q, p: maxsim_xla(q, p, jnp.asarray(qm),
                                             jnp.asarray(pm)),
                     jnp.asarray(Q), jnp.asarray(P))
    dq_j, dp_j = vjp(jnp.asarray(g))
    Qt, Pt = (torch.tensor(Q, requires_grad=True),
              torch.tensor(P, requires_grad=True))
    maxsim_torch(Qt, Pt, *_t(qm, pm), chunk_p=3).backward(torch.from_numpy(g))
    np.testing.assert_allclose(Qt.grad.numpy(), np.asarray(dq_j), atol=1e-5)
    np.testing.assert_allclose(Pt.grad.numpy(), np.asarray(dp_j), atol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_maxsim_plain_f32_matches_pallas_interpret(case):
    # both compute in f32 (Pallas HIGHEST precision) -> 1e-5
    Q, P, qm, pm = _case(**case)
    want = np.asarray(maxsim_pallas(*_j(Q, P, qm, pm), jnp.float32, True))
    got = cuda_maxsim.maxsim_plain(*_t(Q, P, qm, pm),
                                   compute=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(got[:, 2] == 0.0)


def test_maxsim_plain_bf16_is_bf16_rounded_inputs():
    # the kernel's numerics: bf16 inputs, f32 sums. Against the f32 oracle on
    # the bf16-rounded inputs the only difference is summation order (1e-5);
    # against unrounded inputs bf16 costs ~3 decimal digits per term (2e-2
    # on sums of <= 7 terms of magnitude <= 1).
    Q, P, qm, pm = _case(seed=6)
    rb = lambda x: torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    got = cuda_maxsim.maxsim_plain(*_t(Q, P, qm, pm)).numpy()
    np.testing.assert_allclose(got, jax_maxsim_numpy(rb(Q), rb(P), qm, pm),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, jax_maxsim_numpy(Q, P, qm, pm), atol=2e-2)


@pytest.mark.parametrize("case", CASES)
def test_maxsim_int8full_plain_matches_pallas_interpret(case):
    # identical int8 codes and scales on both sides; the int8 x int8 dots are
    # exact, so only the Lq-sum order differs -> 1e-5
    Q, P, qm, pm = _case(**case)
    codes, scales = jax_quantize(P, pm)
    # query codes: the port's quantizer vs the TPU driver's own formula
    # (pallas_maxsim.py:805-809), bit for bit
    Qj = jnp.asarray(Q)
    sq = jnp.max(jnp.abs(Qj), axis=-1) / 127.0
    safe = jnp.where(sq > 0, sq, 1.0)
    want_codes = np.asarray(jnp.clip(jnp.round(Qj / safe[..., None]),
                                     -127, 127).astype(jnp.int8))
    q_codes, q_w = cuda_maxsim.quantize_queries_int8(*_t(Q, qm))
    np.testing.assert_array_equal(q_codes.numpy(), want_codes)
    np.testing.assert_array_equal(q_w.numpy(), np.asarray(
        jnp.asarray(qm).astype(jnp.float32) * sq))

    want = np.asarray(maxsim_pallas_int8full(*_j(Q, codes, scales, qm, pm),
                                             interpret=True))
    got = cuda_maxsim.maxsim_int8full_plain(
        *_t(Q, codes, scales, qm, pm)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(got[:, 2] == 0.0)


@pytest.mark.parametrize("case", CASES)
def test_maxsim_int8_plain_f32_matches_pallas_interpret(case):
    # f32 queries x exact codes on both sides -> 1e-5
    Q, P, qm, pm = _case(**case)
    codes, scales = jax_quantize(P, pm)
    want = np.asarray(maxsim_pallas_int8(
        *_j(Q, codes, scales, qm, pm), compute_dtype=jnp.float32,
        interpret=True))
    got = cuda_maxsim.maxsim_int8_plain(*_t(Q, codes, scales, qm, pm),
                                        compute=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_int8_valid_zero_scale_token_is_not_masked():
    # a valid all-zero token (scale 0) takes part in the max with sim 0,
    # as in the TPU kernel (pallas_maxsim.py:650-654)
    Q, P, qm, pm = _case(seed=7, nd=4, lp=3)
    Q[0] = -np.abs(Q[0])
    P[1] = np.abs(P[1])
    pm[1] = True
    P[1, 0] = 0.0
    codes, scales = jax_quantize(P, pm)
    assert scales[1, 0] == 0.0
    args = _j(Q, codes, scales, qm, pm)
    pairs = [
        (lambda *a: cuda_maxsim.maxsim_int8_plain(*a, compute=torch.float32),
         maxsim_pallas_int8(*args, compute_dtype=jnp.float32,
                            interpret=True)),
        (cuda_maxsim.maxsim_int8full_plain,
         maxsim_pallas_int8full(*args, interpret=True)),
    ]
    for fn, want in pairs:
        got = fn(*_t(Q, codes, scales, qm, pm)).numpy()
        np.testing.assert_allclose(got[:, 1], np.asarray(want)[:, 1],
                                   atol=1e-5)
        assert got[0, 1] == 0.0  # the zero token beats every negative sim


def test_quantize_tokens_int8_matches_jax_package():
    # numpy branch: a copy of evdr_tpu.ops.quantize, bit for bit; torch
    # branch: the same codes and scales (round half to even in both)
    _, P, _, pm = _case(seed=8)
    P[0, 0, :4] = [0.5 / 127, 1.5 / 127, -2.5 / 127, 1.0]  # exact halves
    want_c, want_s = jax_quantize(P, pm)
    got_c, got_s = quantize_tokens_int8(P, pm)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_s, want_s)
    tc, ts = quantize_tokens_int8(*_t(P, pm))
    np.testing.assert_array_equal(tc.numpy(), want_c)
    np.testing.assert_allclose(ts.numpy(), want_s, rtol=1e-7, atol=0)


def test_list_scorers_match_jax_package():
    # f32 on both sides -> 1e-5
    rng = np.random.default_rng(9)
    qs = [rng.normal(size=(int(rng.integers(3, 8)), 16)).astype(np.float32)
          for _ in range(5)]
    ps = [rng.normal(size=(int(rng.integers(4, 12)), 16)).astype(np.float32)
          for _ in range(6)]
    timing = []
    got = score_multi_vector(qs, ps, batch_size=2, timing=timing,
                             device="cpu")
    want = jax_score_multi(qs, ps, batch_size=2, impl="xla")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert len(timing) == 9
    np.testing.assert_allclose(
        score_single_vector([q[0] for q in qs], [p[0] for p in ps],
                            device="cpu"),
        jax_score_single([q[0] for q in qs], [p[0] for p in ps]),
        rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        score_multi_vector([], ps, device="cpu")


@pytest.mark.parametrize("mode", ["int8full", "int8"])
def test_deferred_int8_plain_route_matches_pallas_deferred(mode):
    """K2b through its entry points (``deferred=True``) on CPU tensors takes
    K2's plain version (the same scores), against the TPU's deferred kernel
    in interpret mode at a tiling that engages it (tests/test_maxsim.py's:
    128 queries x 4 tokens, 3 docs x 16 tokens, D = 32). Only the order of
    the sums differs -> 1e-5."""
    from evdr_tpu.ops.pallas_maxsim import _pick_tiles, _resolve_epilogue

    nq, lq, nd, lp, d, rows, cols = 128, 4, 3, 16, 32, 1024, 128
    qb, _, db, _ = _pick_tiles(lq, lp, rows, cols, nq=nq)
    assert _resolve_epilogue("auto", qb, db, deferred=True)[1]
    rng = np.random.default_rng(11)
    Q = rng.normal(size=(nq, lq, d)).astype(np.float32)
    P = rng.normal(size=(nd, lp, d)).astype(np.float32)
    qm = rng.random((nq, lq)) > 0.2
    pm = rng.random((nd, lp)) > 0.2
    codes, scales = jax_quantize(P * pm[..., None], pm)
    jfn, tfn = ((maxsim_pallas_int8full, cuda_maxsim.maxsim_cuda_int8full)
                if mode == "int8full" else
                (maxsim_pallas_int8, cuda_maxsim.maxsim_cuda_int8))
    want = np.asarray(jfn(*_j(Q, codes, scales, qm, pm), interpret=True,
                          target_rows=rows, target_cols=cols, deferred=True))
    args = _t(Q, codes, scales, qm, pm)
    before = cuda_maxsim.launch_counts()
    got = tfn(*args, deferred=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, tfn(*args))
    assert cuda_maxsim.launch_counts() == before  # no kernel launched


def test_deferred_int8_routes_to_k2b_on_the_card(monkeypatch):
    # with the device check and the launch stubbed: deferred=True hands the
    # same operands to K2b's entries (their own library and launch counts)
    calls = []
    monkeypatch.setattr(cuda_maxsim, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_maxsim, "call_kernel",
                        lambda lib, func, ops, *a, aligned=(): calls.append(
                            (lib, func, ops[0].dtype)))
    for w in cuda_maxsim.KERNEL_WRAPPERS:
        monkeypatch.setattr(w, "launches", 0)
    Q, P, qm, pm = _case(4)
    args = _t(Q, *quantize_tokens_int8(P, pm), qm, pm)
    for deferred in (False, True):
        cuda_maxsim.maxsim_cuda_int8(*args, deferred=deferred)
        cuda_maxsim.maxsim_cuda_int8full(*args, deferred=deferred)
    assert calls == [
        ("maxsim_int8", "evdr_maxsim_int8", torch.bfloat16),
        ("maxsim_int8", "evdr_maxsim_int8full", torch.int8),
        ("maxsim_int8_defer", "evdr_maxsim_int8_defer", torch.bfloat16),
        ("maxsim_int8_defer", "evdr_maxsim_int8full_defer", torch.int8)]
    counts = cuda_maxsim.launch_counts()
    assert all(counts[w.__name__] == 1 for w in (
        cuda_maxsim.maxsim_cuda_int8, cuda_maxsim.maxsim_cuda_int8full,
        cuda_maxsim.maxsim_cuda_int8_deferred,
        cuda_maxsim.maxsim_cuda_int8full_deferred))


@pytest.mark.parametrize("lp,d,func", [
    (64, 32, "evdr_maxsim_int8full_wg"), (65, 96, "evdr_maxsim_int8full_wg"),
    (768, 128, "evdr_maxsim_int8full_wg"),
    (700, 256, "evdr_maxsim_int8full_wg"), (4, 128, "evdr_maxsim_int8full"),
    (63, 128, "evdr_maxsim_int8full"), (64, 264, "evdr_maxsim_int8full_wide"),
    (4, 320, "evdr_maxsim_int8full_wide")])
def test_int8full_routes_by_page_width_on_the_card(monkeypatch, lp, d, func):
    # with the device check and the launch stubbed: pages of at least one
    # whole page tile at D <= MAX_D reach K2 int8full's wgmma kernel,
    # shorter pages (pruned stage 1 at Lp 4) the mma.sync loop, D above
    # MAX_D the wide function; deferred=True still reaches K2b. Each
    # launch counts under its function's name.
    calls = []
    monkeypatch.setattr(cuda_maxsim, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_maxsim, "call_kernel",
                        lambda lib, f, ops, *a, aligned=(): calls.append(
                            (lib, f, ops[0].dtype, a)))
    monkeypatch.setattr(cuda_maxsim, "launch_shapes", cuda_maxsim.Counter())
    for w in cuda_maxsim.KERNEL_WRAPPERS:
        monkeypatch.setattr(w, "launches", 0)
    Q, P, qm, pm = _case(5, nq=3, lq=5, nd=4, lp=lp, d=d)
    args = _t(Q, *quantize_tokens_int8(P, pm), qm, pm)
    cuda_maxsim.maxsim_cuda_int8full(*args)
    cuda_maxsim.maxsim_cuda_int8full(*args, deferred=True)
    dk = cuda_maxsim.kernel_dim(d)
    defer = "evdr_maxsim_int8full_defer" + ("_wide" if dk > 256 else "")
    assert calls == [("maxsim_int8", func, torch.int8, (3, 5, 4, lp, dk)),
                     ("maxsim_int8_defer", defer, torch.int8,
                      (3, 5, 4, lp, dk))]
    assert cuda_maxsim.int8full_func(lp, dk) == func.replace("_wide", "")
    for f in {func, defer, "evdr_maxsim_int8full_wg",
              "evdr_maxsim_int8full"}:
        assert cuda_maxsim.func_launches(f) == (f in (func, defer)), f
    counts = cuda_maxsim.launch_counts()
    assert counts["maxsim_cuda_int8full"] == 1
    assert counts["maxsim_cuda_int8full_deferred"] == 1
