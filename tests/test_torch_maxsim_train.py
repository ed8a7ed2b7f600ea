"""The port's differentiable MaxSim op (K5 forward, K6 backward, ``MaxSimFn``)
and K1's float32 mode against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. On CPU
tensors the wrappers take their plain versions; the JAX side runs
``maxsim_pallas`` in interpret mode, as the JAX package's own tests do, and
is differentiated with ``jax.vjp`` (its custom_vjp: K5 forward, K6
backward). The card's kernels are held against the same plain versions by
the ``gpu``-marked tests in ``test_torch_hygiene.py`` (which imports no JAX)
and by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evdr_tpu.ops.maxsim import maxsim_xla
from evdr_tpu.ops.maxsim import score_multi_vector as jax_score_multi
from evdr_tpu.ops.pallas_maxsim import maxsim_pallas
from evdr_tpu.ops.pallas_maxsim_bwd import (maxsim_pallas_bwd,
                                            maxsim_pallas_fwd_train)
from evdr_tpu_torch.ops import cuda_maxsim, cuda_maxsim_train
from evdr_tpu_torch.ops.cuda_maxsim_train import (MaxSimFn, maxsim_bwd_plain,
                                                  maxsim_cuda_bwd,
                                                  maxsim_cuda_fwd_train,
                                                  maxsim_fwd_train_plain)
from evdr_tpu_torch.ops.maxsim import maxsim, maxsim_torch, score_multi_vector

DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def _unit(x):
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)


def _case(seed, nq=3, lq=5, nd=4, lp=9, d=32, empty_doc=True):
    rng = np.random.default_rng(seed)
    Q = _unit(rng.normal(size=(nq, lq, d))).astype(np.float32)
    P = rng.normal(size=(nd, lp, d)).astype(np.float32)
    qm = rng.random((nq, lq)) > 0.2
    qm[:, 0] = True
    pm = rng.random((nd, lp)) > 0.2
    if empty_doc:
        pm[1] = False  # a doc with no valid token: scores 0, gets no gradient
    g = rng.normal(size=(nq, nd)).astype(np.float32)
    return Q, P, qm, pm, g


def _jax_vjp(Q, P, qm, pm, g, jdtype):
    out, vjp = jax.vjp(
        lambda q, p: maxsim_pallas(q, p, jnp.asarray(qm), jnp.asarray(pm),
                                   jdtype, True),
        jnp.asarray(Q), jnp.asarray(P))
    dq, dp = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(dq), np.asarray(dp)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


CASES = [dict(seed=0), dict(seed=1, nq=5, lq=7, nd=6, lp=23, d=48),
         dict(seed=2, nq=2, lq=3, nd=3, lp=70, d=16, empty_doc=False)]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("tdtype,jdtype", DTYPES)
def test_maxsimfn_matches_jax_custom_vjp(case, tdtype, jdtype):
    # both sides round Q and P to the compute dtype and sum exact products
    # in f32 (bf16 x bf16 products are exact in f32); only the order of the
    # sums differs -> 1e-5
    Q, P, qm, pm, g = _case(**case)
    want_out, want_dq, want_dp = _jax_vjp(Q, P, qm, pm, g, jdtype)
    Qt, Pt = (t.requires_grad_(True) for t in _t(Q, P))
    qmt, pmt, gt = _t(qm, pm, g)
    out = MaxSimFn.apply(Qt, Pt, qmt, pmt, tdtype)
    out.backward(gt)
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(Qt.grad.numpy(), want_dq, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(Pt.grad.numpy(), want_dp, rtol=1e-5, atol=1e-5)
    assert Qt.grad.dtype == torch.float32 and Pt.grad.dtype == torch.float32
    if not pm[1].any():
        assert float(Pt.grad[1].abs().max()) == 0.0


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("tdtype,jdtype", DTYPES)
def test_plain_k5_k6_match_jax(case, tdtype, jdtype):
    # the plain versions directly: K5's scores and M (M against each row's
    # max of the compute-dtype similarities), K6's dQ and dP
    Q, P, qm, pm, g = _case(**case)
    want_out, want_dq, want_dp = _jax_vjp(Q, P, qm, pm, g, jdtype)
    Qt, Pt, qmt, pmt, gt = _t(Q, P, qm, pm, g)
    out, M = maxsim_fwd_train_plain(Qt, Pt, qmt, pmt, tdtype)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=1e-5, atol=1e-5)
    Qr = Qt.to(tdtype).double().numpy()
    Pr = Pt.to(tdtype).double().numpy()
    sim = np.einsum("qtd,cmd->qtcm", Qr, Pr)
    sim = np.where(pm[None, None], sim, -1e30).max(axis=-1)
    np.testing.assert_allclose(M.numpy(), sim.reshape(-1, P.shape[0]),
                               rtol=1e-5, atol=1e-6)
    dq, dp = maxsim_bwd_plain(Qt, Pt, qmt, pmt, M, gt, tdtype)
    np.testing.assert_allclose(dq.numpy(), want_dq, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dp.numpy(), want_dp, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lp", [137, 154])
@pytest.mark.parametrize("tdtype,jdtype", DTYPES)
def test_plain_k5_matches_pallas_fwd_train_at_student_pages(lp, tdtype,
                                                            jdtype):
    """K5's plain version against maxsim_pallas_fwd_train in interpret mode
    at the mf5 student's page lengths (Lp 137 and 154, which 64-token tiles
    fill in three tiles, the last ragged): the scores, and M (the TPU's
    (query block, doc block, doc, row) blocks laid out as (q * Lq + t,
    doc)) on every valid query row. Both round Q and P to the compute dtype
    and sum exact products in f32; only the order of the sums differs ->
    1e-5, as the cases above."""
    from evdr_tpu.ops.pallas_maxsim_bwd import _prep

    Q, P, qm, pm, g = _case(lp, nq=5, lq=9, nd=6, lp=lp, d=48)
    out_j, M_j = maxsim_pallas_fwd_train(*map(jnp.asarray, (Q, P, qm, pm)),
                                         jdtype, True)
    dm = _prep(*map(jnp.asarray, (Q, P, qm, pm)), jdtype, 1024, 1024)[-1]
    M_j = np.asarray(M_j).transpose(0, 3, 1, 2).reshape(
        dm["n_qb"] * dm["qb"], dm["lq_pad"], -1)[:5, :9, :6]
    Qt, Pt, qmt, pmt = _t(Q, P, qm, pm)
    out, M = maxsim_fwd_train_plain(Qt, Pt, qmt, pmt, tdtype)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(M.numpy().reshape(5, 9, 6)[qm], M_j[qm],
                               rtol=1e-5, atol=1e-5)


def test_wrappers_route_cpu_tensors_to_the_plain_versions(monkeypatch):
    Q, P, qm, pm, g = _case(3)
    Qt, Pt, qmt, pmt, gt = _t(Q, P, qm, pm, g)
    before = cuda_maxsim.launch_counts()
    out, M = maxsim_cuda_fwd_train(Qt, Pt, qmt, pmt)
    out_p, M_p = maxsim_fwd_train_plain(Qt, Pt, qmt, pmt)
    torch.testing.assert_close(out, out_p, rtol=0, atol=0)
    torch.testing.assert_close(M, M_p, rtol=0, atol=0)
    dq, dp = maxsim_cuda_bwd(Qt, Pt, qmt, pmt, M, gt)
    dq_p, dp_p = maxsim_bwd_plain(Qt, Pt, qmt, pmt, M, gt)
    torch.testing.assert_close(dq, dq_p, rtol=0, atol=0)
    torch.testing.assert_close(dp, dp_p, rtol=0, atol=0)
    torch.testing.assert_close(
        cuda_maxsim.maxsim_cuda_f32(Qt, Pt, qmt, pmt),
        cuda_maxsim.maxsim_plain(Qt, Pt, qmt, pmt, compute=torch.float32),
        rtol=0, atol=0)
    assert cuda_maxsim.launch_counts() == before  # no kernel launched
    assert {w.__name__ for w in cuda_maxsim_train.KERNEL_WRAPPERS} <= set(
        before)
    # compute_dtype float32 takes the float32 kernels (no longer refused):
    # with the device check, K6's occupancy query and the launch stubbed,
    # the wrappers hand f32 operands to the _f32 entries and count on the
    # _f32 wrappers
    calls = []
    monkeypatch.setattr(cuda_maxsim_train, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_maxsim_train, "bwd_config",
                        lambda *a: {"clusters": 16})
    monkeypatch.setattr(cuda_maxsim_train, "call_kernel",
                        lambda lib, func, ops, *a, aligned=(): calls.append(
                            (func, ops[0].dtype, ops[2].dtype)))
    for w in cuda_maxsim_train.KERNEL_WRAPPERS:
        monkeypatch.setattr(w, "launches", 0)
    maxsim_cuda_fwd_train(Qt, Pt, qmt, pmt, torch.float32)
    maxsim_cuda_bwd(Qt, Pt, qmt, pmt, M, gt, torch.float32)
    maxsim_cuda_bwd(Qt, Pt, qmt, pmt, M, gt)
    assert calls == [("evdr_maxsim_fwd_train_f32",) + (torch.float32,) * 2,
                     ("evdr_maxsim_bwd_f32",) + (torch.float32,) * 2,
                     ("evdr_maxsim_bwd",) + (torch.bfloat16,) * 2]
    assert {w.__name__: w.launches
            for w in cuda_maxsim_train.KERNEL_WRAPPERS} == {
        "maxsim_cuda_fwd_train": 0, "maxsim_cuda_fwd_train_f32": 1,
        "maxsim_cuda_bwd": 1, "maxsim_cuda_bwd_f32": 1}
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        maxsim_cuda_fwd_train(Qt, Pt, qmt, pmt, torch.float16)


@pytest.mark.parametrize("case", CASES)
def test_k1_f32_plain_matches_pallas_f32_interpret(case):
    # K1's float32 mode (the trainer's eval and teacher scorer): f32 on both
    # sides (Pallas at HIGHEST precision) -> 1e-5
    Q, P, qm, pm, _ = _case(**case)
    want = np.asarray(maxsim_pallas(jnp.asarray(Q), jnp.asarray(P),
                                    jnp.asarray(qm), jnp.asarray(pm),
                                    jnp.float32, True))
    Qt, Pt, qmt, pmt = _t(Q, P, qm, pm)
    for got in (cuda_maxsim.maxsim_cuda_f32(Qt, Pt, qmt, pmt),
                cuda_maxsim.maxsim_cuda(Qt, Pt, qmt, pmt,
                                        compute_dtype=torch.float32)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tdtype,jdtype", DTYPES)
def test_planted_tie_sums_the_gradient_like_the_tpu_kernel(tdtype, jdtype):
    # doc 0 holds one token twice and query 0's first token points at it:
    # the argmax ties. K6 (TPU and plain) routes the full gradient to BOTH
    # tied tokens (pallas_maxsim_bwd.py:18-20); torch.amax's autograd splits
    # it evenly, so autograd of maxsim_torch differs exactly there.
    Q, P, qm, pm, g = _case(4, empty_doc=False)
    pm[0, 2] = pm[0, 5] = True
    P[0, 5] = P[0, 2]
    Q[0, 0] = _unit(P[0, 2].astype(np.float64) * 3.0).astype(np.float32)
    qm[0, 0] = True
    _, want_dq, want_dp = _jax_vjp(Q, P, qm, pm, g, jdtype)
    Qt, Pt, qmt, pmt, gt = _t(Q, P, qm, pm, g)
    _, M = maxsim_fwd_train_plain(Qt, Pt, qmt, pmt, tdtype)
    dq, dp = maxsim_bwd_plain(Qt, Pt, qmt, pmt, M, gt, tdtype)
    np.testing.assert_allclose(dq.numpy(), want_dq, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dp.numpy(), want_dp, rtol=1e-5, atol=1e-5)
    # both tied tokens got query 0 token 0's full weighted gradient
    np.testing.assert_allclose(dp[0, 2].numpy(), dp[0, 5].numpy(), atol=0)

    Pr = Pt.to(tdtype).float().requires_grad_(True)
    maxsim_torch(Qt.to(tdtype).float(), Pr, qmt, pmt).backward(gt)
    split = Pr.grad[0, 2].numpy()
    assert np.abs(split - dp[0, 2].numpy()).max() > 1e-3
    np.testing.assert_allclose(Pr.grad[0, 2].numpy(), Pr.grad[0, 5].numpy(),
                               atol=0)


def _hit_grads(Q, P, qm, pm, g, tdtype):
    """The arithmetic K6 implements, in numpy: per row and doc the tied
    positions (hits) of the max over valid tokens, of similarities of the
    operands rounded to the compute dtype; e = W = g * qmask *
    doc_has_token (rounded to bf16 in bf16 mode); dQ[r] = sum of e *
    P[d, m] and dP[d, m] = sum of e * Q[r] over the hits, products and sums
    in f32."""
    def rnd(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(
            tdtype).float().numpy()

    Qr, Pr = rnd(Q), rnd(P)
    nq, lq, d = Q.shape
    nd = P.shape[0]
    rows = Qr.reshape(nq * lq, d)
    # products of the rounded values are exact in f64; a tie is a tie
    sim = np.einsum("rd,cmd->rcm", rows.astype(np.float64),
                    Pr.astype(np.float64))
    sim = np.where(pm[None], sim, -np.inf)
    has = pm.any(axis=1)
    w = (g[:, None, :] * qm[:, :, None] * has[None, None, :]).reshape(
        nq * lq, nd).astype(np.float32)
    e = rnd(w)
    hits = (sim == sim.max(axis=-1, keepdims=True)) & pm[None] & (
        e != 0)[..., None]
    dq = np.zeros((nq * lq, d), np.float32)
    dp = np.zeros(P.shape, np.float32)
    for r, c, m in zip(*np.nonzero(hits)):
        dq[r] += e[r, c] * Pr[c, m]
        dp[c, m] += e[r, c] * rows[r]
    return dq.reshape(Q.shape), dp


HIT_CASES = {
    # a page token duplicated in its doc, query 0's first token on it
    "planted_tie": dict(seed=6, nq=3, lq=5, nd=4, lp=9),
    # a zero query row with qmask 1 ties with every valid token
    "zero_row": dict(seed=7, nq=3, lq=5, nd=4, lp=9),
    "empty_doc": dict(seed=8, nq=3, lq=5, nd=4, lp=9),
    # Lq 7: 18 queries a 128-row block, 150 queries span 9 blocks
    "lq7_nine_blocks": dict(seed=9, nq=150, lq=7, nd=3, lp=11),
}


@pytest.mark.parametrize("name", sorted(HIT_CASES))
@pytest.mark.parametrize("tdtype,jdtype", DTYPES)
def test_hit_arithmetic_matches_the_tpu_backward(name, tdtype, jdtype):
    """The numpy hit arithmetic K6 implements (``_hit_grads``) against the
    JAX package's fused backward in interpret mode (``maxsim_pallas_bwd``
    on ``maxsim_pallas_fwd_train``'s M), and the port's plain K6 against
    the same numbers: summation order alone differs -> 1e-5."""
    Q, P, qm, pm, g = _case(**HIT_CASES[name], empty_doc=name == "empty_doc")
    if name == "planted_tie":
        pm[0, 2] = pm[0, 5] = True
        P[0, 5] = P[0, 2]
        Q[0, 0] = _unit(P[0, 2].astype(np.float64) * 3.0).astype(np.float32)
        qm[0, 0] = True
    if name == "zero_row":
        Q[1, 2] = 0.0
        qm[1, 2] = True
    want_dq, want_dp = _hit_grads(Q, P, qm, pm, g, tdtype)
    args = [jnp.asarray(a) for a in (Q, P, qm, pm)]
    _, M = maxsim_pallas_fwd_train(*args, jdtype, True)
    jdq, jdp = maxsim_pallas_bwd(*args, M, jnp.asarray(g), jdtype, True)
    np.testing.assert_allclose(np.asarray(jdq), want_dq, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jdp), want_dp, rtol=1e-5, atol=1e-5)
    Qt, Pt, qmt, pmt, gt = _t(Q, P, qm, pm, g)
    _, Mt = maxsim_fwd_train_plain(Qt, Pt, qmt, pmt, tdtype)
    dq, dp = maxsim_bwd_plain(Qt, Pt, qmt, pmt, Mt, gt, tdtype)
    np.testing.assert_allclose(dq.numpy(), want_dq, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dp.numpy(), want_dp, rtol=1e-5, atol=1e-5)
    if name == "planted_tie":  # both tied tokens got the full gradient
        np.testing.assert_allclose(want_dp[0, 2], want_dp[0, 5], atol=0)
        assert np.abs(want_dp[0, 2]).max() > 0
    if name == "zero_row":  # every valid token of every doc that has one
        assert np.abs(want_dq[1, 2]).max() > 0
    if name == "empty_doc":
        assert np.abs(want_dp[1]).max() == 0


def test_dispatcher_routes_like_the_jax_package():
    # 'xla' -> maxsim_torch; 'auto' on CPU tensors -> maxsim_torch (JAX:
    # XLA off the accelerator); 'pallas' -> the kernel op (plain versions on
    # the CPU), differentiable through MaxSimFn
    Q, P, qm, pm, g = _case(5)
    Qt, Pt, qmt, pmt, gt = _t(Q, P, qm, pm, g)
    want_xla = np.asarray(maxsim_xla(*(jnp.asarray(a) for a in (Q, P, qm, pm))))
    for impl in ("xla", "auto"):
        np.testing.assert_allclose(maxsim(Qt, Pt, qmt, pmt, impl=impl).numpy(),
                                   want_xla, rtol=1e-5, atol=1e-5)
    got = maxsim(Qt, Pt, qmt, pmt, impl="pallas", compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want_xla, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        maxsim(Qt, Pt, qmt, pmt, impl="pallas"),
        cuda_maxsim.maxsim_plain(Qt, Pt, qmt, pmt), rtol=0, atol=0)
    Pg = Pt.clone().requires_grad_(True)
    maxsim(Qt, Pg, qmt, pmt, impl="pallas",
           compute_dtype=torch.float32).backward(gt)
    _, _, want_dp = _jax_vjp(Q, P, qm, pm, g, jnp.float32)
    np.testing.assert_allclose(Pg.grad.numpy(), want_dp, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="impl"):
        maxsim(Qt, Pt, qmt, pmt, impl="cuda")


@pytest.mark.parametrize("impl", ["xla", "auto", "pallas"])
def test_score_multi_vector_takes_impl(impl):
    # ragged lists through the dispatcher. 'pallas' scores with K1 (bf16
    # inputs): against the JAX list scorer on the bf16-rounded lists only
    # the summation order differs -> 1e-5
    rng = np.random.default_rng(11)
    qs = [rng.normal(size=(int(rng.integers(3, 8)), 16)).astype(np.float32)
          for _ in range(5)]
    ps = [rng.normal(size=(int(rng.integers(4, 12)), 16)).astype(np.float32)
          for _ in range(7)]
    if impl == "pallas":
        qs, ps = ([torch.from_numpy(x).bfloat16().float().numpy() for x in xs]
                  for xs in (qs, ps))
    got = score_multi_vector(qs, ps, batch_size=3, impl=impl, device="cpu")
    want = jax_score_multi(qs, ps, batch_size=3, impl="xla")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
