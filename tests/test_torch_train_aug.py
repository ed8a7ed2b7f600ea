"""The port's mixup and hardtoken augmentations and its QAT train step
against the JAX package's, on the CPU, one step at a time.

Both packages take the same seeded numpy batch, teacher and student. The
random draws differ between the two (a JAX key against the port's seeded
generators), so the JAX step's draws are handed to the port: the mixup
lambda and permutation through ``harness.mixup_draws``, the hard-token
noise through ``harness.virtual_query_noise``. Only float32 summation order
then differs: the loss parts within 1e-5 relative, the updated parameter
and Adam moments as in ``test_torch_train.py``; the hard-token rank-gap
diagnostics are integers and equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from evdr_tpu.ops.pq import expand_books as jax_expand_books
from evdr_tpu.ops.pq import train_opq as jax_train_opq
from evdr_tpu.ops.pq import train_pq as jax_train_pq
from evdr_tpu.train.config import TrainConfig as JaxConfig
from evdr_tpu.train.harness import DatasetBundle as JaxBundle
from evdr_tpu.train.harness import _fit_qat_books as jax_fit_qat_books
from evdr_tpu.train.harness import build_train_step as jax_build_train_step
from evdr_tpu_torch.train import harness
from evdr_tpu_torch.train.config import TrainConfig
from evdr_tpu_torch.train.harness import (DatasetBundle, build_train_step,
                                          make_optimizer)

DIAG = ("_gap_top_val", "_gap_top_idx")


def _step_inputs(seed=0, n_train=16, b=6, n=9, lq=5, lp_t=40, ls=8, d=16):
    rng = np.random.default_rng(seed)

    def unit(x):
        return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)

    Q = unit(rng.normal(size=(n_train, lq, d))).astype(np.float32)
    qm = rng.random((n_train, lq)) > 0.15
    qm[:, 0] = True
    pm_t = rng.random((n, lp_t)) > 0.15
    P_t = unit(rng.normal(size=(n, lp_t, d)) * pm_t[..., None]
               + 1e-12).astype(np.float32)
    pm_s = rng.random((n, ls)) > 0.1
    Pbar = (rng.normal(size=(n, ls, d)) * pm_s[..., None]).astype(np.float32)
    idx = rng.permutation(n_train)[:2 * b].reshape(2, b).astype(np.int32)
    return Q, qm, P_t, pm_t, Pbar, pm_s, idx


def _bundles(Q, qm, P_t, pm_t, sct):
    common = dict(dataset="x", pos_idx=None,
                  docid_teacher=np.array(["d"] * P_t.shape[0], dtype=object),
                  relevant_docs_test={}, docidx_2_docid_test={},
                  qsidx_2_query_test=None)
    jb = JaxBundle(Q_train=jnp.asarray(Q), qmask_train=jnp.asarray(qm),
                   Q_test=jnp.asarray(Q), qmask_test=jnp.asarray(qm),
                   P_teacher_norm=jnp.asarray(P_t),
                   pmask_teacher=jnp.asarray(pm_t),
                   sc_t_train=jnp.asarray(sct), **common)
    tb = DatasetBundle(Q_train=torch.from_numpy(Q),
                       qmask_train=torch.from_numpy(qm),
                       Q_test=torch.from_numpy(Q),
                       qmask_test=torch.from_numpy(qm),
                       P_teacher_norm=torch.from_numpy(P_t),
                       pmask_teacher=torch.from_numpy(pm_t),
                       sc_t_train=torch.from_numpy(sct), **common)
    return jb, tb


def _teacher_scores(Q, qm, P_t, pm_t):
    sim = np.einsum("qld,nmd->qlnm", Q.astype(np.float64),
                    P_t.astype(np.float64))
    sim = np.where(pm_t[None, None], sim, -1e4).max(-1)
    return (sim * qm[..., None]).sum(1).astype(np.float32)


def _run_both(kw, monkeypatch, k_steps=1, books=None, seed=0):
    """One dispatch (K = k_steps steps) in both packages from the same
    inputs; the port gets the JAX step's random draws. Returns (JAX parts,
    JAX param, JAX Adam state, port parts, port param, port optimizer)."""
    Q, qm, P_t, pm_t, Pbar, pm_s, idx = _step_inputs(seed)
    sct = _teacher_scores(Q, qm, P_t, pm_t)
    jb, tb = _bundles(Q, qm, P_t, pm_t, sct)
    kw = dict(dict(loss="liscore", lr=1e-3, weight_decay=1e-2, k=6, temp=0.1,
                   lambda_list=1.0, lambda_score=0.7, chunk_p=4,
                   steps_per_dispatch=k_steps, debug_invariants=True), **kw)
    idx_in = idx if k_steps > 1 else idx[0]
    key = jax.random.PRNGKey(3)
    keys = list(jax.random.split(key, k_steps)) if k_steps > 1 else [key]

    jcfg = JaxConfig(**kw)
    opt = optax.adamw(jcfg.lr, weight_decay=jcfg.weight_decay)
    jparam = jnp.asarray(Pbar)
    jstep = jax_build_train_step(
        jcfg, jb, jnp.asarray(pm_s), opt,
        qat_books=None if books is None else jnp.asarray(books))
    jparam2, jstate, jparts = jstep(jparam, opt.init(jparam),
                                    jnp.asarray(idx_in), key)

    # the JAX step's draws, in the order the port's step asks for them
    mix = iter([(jax.random.beta(jax.random.split(k)[0], jcfg.mixup_alpha,
                                 jcfg.mixup_alpha),
                 jax.random.permutation(jax.random.split(k)[1], P_t.shape[0]))
                for k in keys])
    noise = iter(keys)

    def fake_mixup(alpha, n_docs, host_rng, gen):
        lam, perm = next(mix)
        return (torch.tensor(np.asarray(lam), dtype=torch.float32),
                torch.from_numpy(np.array(perm)).long())

    def fake_noise(shape, gen):
        return torch.from_numpy(np.array(
            jax.random.normal(next(noise), tuple(shape), jnp.float32)))

    monkeypatch.setattr(harness, "mixup_draws", fake_mixup)
    monkeypatch.setattr(harness, "virtual_query_noise", fake_noise)
    cfg = TrainConfig(**kw)
    param = torch.from_numpy(Pbar.copy()).requires_grad_(True)
    optimizer = make_optimizer(cfg, param)
    parts = build_train_step(cfg, tb, torch.from_numpy(pm_s), optimizer,
                             qat_books=books)(idx_in, 0)
    return jparts, jparam2, jstate, parts, param, optimizer


def _assert_step_matches(jparts, jparam2, jstate, parts, param, optimizer,
                         k_steps=1):
    assert set(parts) == set(jparts)
    for k in jparts:
        if k in DIAG:
            np.testing.assert_array_equal(parts[k].numpy(),
                                          np.asarray(jparts[k]), err_msg=k)
        else:
            np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(parts["_grad_invalid_absmax"]) == 0.0
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(jparam2),
                               rtol=1e-4, atol=2e-5)
    st = optimizer.state[param]
    adam = jstate[0]
    assert int(st["step"]) == int(adam.count) == k_steps
    np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(adam.mu),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(adam.nu),
                               rtol=1e-4, atol=1e-10)


@pytest.mark.parametrize("k_steps,extra", [
    (1, dict()), (2, dict()), (1, dict(mixup_alpha=0.6, lambda_mix=0.5)),
    (1, dict(qat="int8"))])
def test_one_mixup_step_matches_jax(monkeypatch, k_steps, extra):
    """Document mixup with the JAX lambda and permutation injected: the
    mixed pages under the intersected mask, the mixed teacher scores and
    the score-MSE term."""
    out = _run_both(dict(aug="mixup", **extra), monkeypatch, k_steps)
    _assert_step_matches(*out, k_steps=k_steps)
    assert {"mix", "score_mix"} <= set(out[3])


@pytest.mark.parametrize("k_steps,extra", [
    (1, dict(virt_noise_std=0.0)), (1, dict(virt_noise_std=0.1)),
    (2, dict(virt_noise_std=0.1, aux_docs=2, gap_topk=5)),
    (1, dict(virt_noise_std=0.1, qat="int4"))])
def test_one_hardtoken_step_matches_jax(monkeypatch, k_steps, extra):
    """The hard-token auxiliary loss at no noise and with the JAX noise
    injected: rank gaps by double stable argsort, the teacher's top-k by a
    stable descending sort, the aux docs, the hard tokens, the aux loss;
    the gap diagnostics (top docs and their summed |gap|) equal exactly."""
    out = _run_both(dict(aug="hardtoken", **extra), monkeypatch, k_steps)
    _assert_step_matches(*out, k_steps=k_steps)
    parts = out[3]
    assert parts["_gap_top_idx"].dtype == torch.int64
    assert "aux" in parts and {"aux_listwise", "aux_score"} <= set(parts)


def test_hardtoken_ties_keep_index_order():
    # equal teacher scores: the stable descending sort keeps lower indices
    # first, as lax.top_k does; torch.topk promises no order
    x = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.1]])
    assert harness._stable_argsort_desc(x).tolist() == [[1, 3, 0, 2, 4]]
    np.testing.assert_array_equal(
        np.asarray(jax.lax.top_k(jnp.asarray(x.numpy()), 4)[1]),
        harness._stable_argsort_desc(x)[:, :4].numpy())


@pytest.mark.parametrize("tier", ["int8", "int4", "pq", "opq"])
def test_one_qat_step_matches_jax(monkeypatch, tier):
    """The QAT step on the same codebooks: the STE reconstruction scores
    the student, the gradient passes straight through."""
    books = None
    if tier in ("pq", "opq"):
        _, _, _, _, Pbar, pm_s, _ = _step_inputs(0)
        Ps = Pbar / (np.linalg.norm(Pbar, axis=-1, keepdims=True) + 1e-12)
        if tier == "pq":
            books = jax_train_pq(Ps, pm_s, m=4, k=8, iters=4, seed=0)
        else:
            b, rot = jax_train_opq(Ps, pm_s, m=4, k=8, iters=4, opq_iters=2,
                                   seed=0)
            books = jax_expand_books(b, rot)
    out = _run_both(dict(qat=tier, qat_pq_m=4), monkeypatch, books=books)
    _assert_step_matches(*out)


@pytest.mark.parametrize("tier", ["pq", "opq"])
def test_fit_qat_books_equals_the_jax_fit(tier):
    # the same normalized student and seed -> the same codebooks, bit for
    # bit (numpy in both; the port's train_pq also takes the tensor)
    _, _, _, _, Pbar, pm_s, _ = _step_inputs(1, n=40, ls=12)
    Ps = Pbar / (np.linalg.norm(Pbar, axis=-1, keepdims=True) + 1e-12)
    kw = dict(qat=tier, qat_pq_m=4, seed=5)
    want = np.asarray(jax_fit_qat_books(JaxConfig(**kw), Ps, pm_s))
    got = harness._fit_qat_books(TrainConfig(**kw), torch.from_numpy(Ps),
                                 torch.from_numpy(pm_s))
    np.testing.assert_array_equal(got, want)
    assert got.shape[-1] == (16 if tier == "opq" else 4)
