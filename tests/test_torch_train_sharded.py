"""Doc-sharded training in the torch port (``parallel/train_sharded.py``)
against the JAX package's ``build_sharded_train_step`` and against the
port's one-device step, on the CPU.

The port's mesh is ``mesh_of(["cpu"] * 4)`` (four shards of the host), the
JAX package's ``make_mesh(4)`` over four of the eight virtual CPU devices
(``tests/conftest.py``): 19 docs padded to 20, the padding at the end of
the last shard. Every case takes one step from the same seeded numpy
inputs. Random draws differ between the packages, so the JAX step's are
handed to the port where it draws (``harness.mixup_draws``,
``harness.virtual_query_noise``); qnoise's query noise comes from the
port's own generator and is held against the port's one-device step,
which draws the same. Only float32 summation order differs: the loss
within 1e-5 relative, the updated rows within 2e-5 (AdamW's first step
moves each element by about +-lr whatever the gradient's size).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from evdr_tpu.parallel import build_sharded_index as jax_build_index
from evdr_tpu.parallel import build_sharded_train_step as jax_sharded_step
from evdr_tpu.parallel import make_mesh as jax_make_mesh
from evdr_tpu.parallel import replicate, shard_docs
from evdr_tpu.parallel.train_sharded import (
    build_sharded_eval_loss as jax_sharded_eval_loss)
from evdr_tpu.parallel.train_sharded import (
    precompute_teacher_scores_sharded as jax_precompute_sharded)
from evdr_tpu.train.config import TrainConfig as JaxConfig
from evdr_tpu.train.harness import DatasetBundle as JaxBundle
from evdr_tpu.train.harness import build_train_step as jax_build_train_step
from evdr_tpu_torch.parallel import (build_sharded_eval_loss,
                                     build_sharded_train_step,
                                     has_collective_form, mesh_of,
                                     precompute_teacher_scores_sharded)
from evdr_tpu_torch.parallel.multihost import shard_docs_global
from evdr_tpu_torch.train import harness
from evdr_tpu_torch.train.config import TrainConfig
from evdr_tpu_torch.train.harness import (DatasetBundle, build_train_step,
                                          evaluation_loss, make_optimizer)

N, LQ, LP, LS, D, NT, B = 19, 5, 12, 6, 32, 16, 8
BASE = dict(k=6, temp=0.3, lambda_list=1.0, lambda_score=0.5, lr=1e-3,
            chunk_p=8)


def _unit(x):
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)


def _data(seed=0, empty_doc=False):
    """Queries, teacher, student, labels and a batch. ``empty_doc``: a real
    doc (index 6) with no valid token in the teacher nor the student."""
    rng = np.random.default_rng(seed)
    Q = _unit(rng.normal(size=(NT, LQ, D))).astype(np.float32)
    qm = rng.random((NT, LQ)) > 0.15
    qm[:, 0] = True
    pm_t = rng.random((N, LP)) > 0.15
    pm_s = rng.random((N, LS)) > 0.1
    if empty_doc:
        pm_t[6] = pm_s[6] = False
    P_t = _unit(rng.normal(size=(N, LP, D)) * pm_t[..., None]
                + 1e-12).astype(np.float32)
    Pbar = (rng.normal(size=(N, LS, D)) * pm_s[..., None]).astype(np.float32)
    pos = rng.integers(0, N, NT)
    idx = np.stack([rng.permutation(NT)[:B] for _ in range(3)]).astype(np.int32)
    return dict(Q=Q, qm=qm, P_t=P_t, pm_t=pm_t, Pbar=Pbar, pm_s=pm_s,
                pos=pos, idx=idx)


def _pad(x, n_pad):
    return np.pad(x, ((0, n_pad - x.shape[0]),) + ((0, 0),) * (x.ndim - 1))


def _shards(x, mesh, n_pad):
    return [t.clone() for t in
            shard_docs_global(torch.from_numpy(np.ascontiguousarray(x)),
                              mesh, n_pad=n_pad)]


def _jax_draws(keys, n_perm, alpha):
    """The JAX step's mixup draws (lambda, permutation) and hard-token noise
    keys, in the order the port asks for them."""
    mix = iter([(jax.random.beta(jax.random.split(k)[0], alpha, alpha),
                 jax.random.permutation(jax.random.split(k)[1], n_perm))
                for k in keys])
    noise = iter(keys)

    def fake_mixup(a, n, host_rng, gen):
        lam, perm = next(mix)
        assert n == n_perm
        return (torch.tensor(np.asarray(lam), dtype=torch.float32),
                torch.from_numpy(np.array(perm)).long())

    def fake_noise(shape, gen):
        return torch.from_numpy(np.array(
            jax.random.normal(next(noise), tuple(shape), jnp.float32)))

    return fake_mixup, fake_noise


def _bundles(d, labels=False):
    common = dict(dataset="x", docid_teacher=np.array(["d"] * N, dtype=object),
                  relevant_docs_test={}, docidx_2_docid_test={},
                  qsidx_2_query_test=None,
                  pos_idx=d["pos"] if labels else None)
    jb = JaxBundle(Q_train=jnp.asarray(d["Q"]), qmask_train=jnp.asarray(d["qm"]),
                   Q_test=jnp.asarray(d["Q"]), qmask_test=jnp.asarray(d["qm"]),
                   P_teacher_norm=jnp.asarray(d["P_t"]),
                   pmask_teacher=jnp.asarray(d["pm_t"]), **common)
    tb = DatasetBundle(Q_train=torch.from_numpy(d["Q"]),
                       qmask_train=torch.from_numpy(d["qm"]),
                       Q_test=torch.from_numpy(d["Q"]),
                       qmask_test=torch.from_numpy(d["qm"]),
                       P_teacher_norm=torch.from_numpy(d["P_t"]),
                       pmask_teacher=torch.from_numpy(d["pm_t"]), **common)
    return jb, tb


def _jax_step(kw, d, world, key, k_steps=1, sct=False):
    """One dispatch of JAX's sharded step; world 0: its one-device step.
    Returns (parts, the updated parameter's first N rows)."""
    cfg = JaxConfig(**kw)
    idx = jnp.asarray(d["idx"][:k_steps] if k_steps > 1 else d["idx"][0])
    labels = cfg.loss == "infonce_sup"
    if world == 0:
        jb, _ = _bundles(d, labels)
        opt = optax.adamw(cfg.lr, weight_decay=cfg.weight_decay)
        p = jnp.asarray(d["Pbar"])
        step = jax_build_train_step(cfg, jb, jnp.asarray(d["pm_s"]), opt)
        p2, _, parts = step(p, opt.init(p), idx, key)
        return parts, np.asarray(p2)
    mesh = jax_make_mesh(world)
    n_pad = -(-N // world) * world
    teacher = jax_build_index(d["P_t"], d["pm_t"], mesh)
    Qr, qmr = replicate(jnp.asarray(d["Q"]), mesh), replicate(
        jnp.asarray(d["qm"]), mesh)
    sct_all = (jax_precompute_sharded(Qr, qmr, teacher.P, teacher.pmask,
                                      mesh, chunk_q=7, chunk_p=8)
               if sct else None)
    step, opt = jax_sharded_step(
        cfg, mesh, pmask_student=shard_docs(jnp.asarray(_pad(d["pm_s"], n_pad)),
                                            mesh),
        P_teacher=teacher.P, pmask_teacher=teacher.pmask, n_docs=N,
        Q_all=Qr, qm_all=qmr, sct_all=sct_all,
        pos_all=jnp.asarray(d["pos"], jnp.int32) if labels else None)
    p = shard_docs(jnp.asarray(_pad(d["Pbar"], n_pad)), mesh)
    p2, _, parts = step(p, opt.init(p), idx, key)
    return parts, np.asarray(p2)[:N]


def _port_sharded(kw, d, world, seed=0, k_steps=1, sct=False):
    """One dispatch of the port's sharded step on ``mesh_of(["cpu"] *
    world)``: (parts, the updated first N rows, the optimizer, the
    shards' parameters)."""
    cfg = TrainConfig(**kw)
    mesh = mesh_of(["cpu"] * world)
    n_pad = -(-N // world) * world
    params = [p.requires_grad_(True) for p in _shards(d["Pbar"], mesh, n_pad)]
    Pt = _shards(d["P_t"], mesh, n_pad)
    pmt = _shards(d["pm_t"], mesh, n_pad)
    Q, qm = torch.from_numpy(d["Q"]), torch.from_numpy(d["qm"])
    sct_all = (precompute_teacher_scores_sharded(Q, qm, Pt, pmt, mesh,
                                                 chunk_q=7, chunk_p=8)
               if sct else None)
    step, opt = build_sharded_train_step(
        cfg, mesh, params=params, pmask_student=_shards(d["pm_s"], mesh, n_pad),
        P_teacher=Pt, pmask_teacher=pmt, n_docs=N, Q_all=Q, qm_all=qm,
        sct_all=sct_all,
        pos_all=d["pos"] if cfg.loss == "infonce_sup" else None)
    parts = step(d["idx"][:k_steps] if k_steps > 1 else d["idx"][0], seed)
    full = torch.cat([p.detach() for p in params])[:N].numpy()
    return parts, full, opt, params


def _port_one(kw, d, seed=0, k_steps=1):
    cfg = TrainConfig(**kw)
    _, tb = _bundles(d, cfg.loss == "infonce_sup")
    param = torch.from_numpy(d["Pbar"].copy()).requires_grad_(True)
    opt = make_optimizer(cfg, param)
    step = build_train_step(cfg, tb, torch.from_numpy(d["pm_s"]), opt)
    parts = step(d["idx"][:k_steps] if k_steps > 1 else d["idx"][0], seed)
    return parts, param.detach().numpy()


def _assert_same(parts, param, want_parts, want_param, keys=None):
    keys = keys or [k for k in want_parts if not k.startswith("_")]
    for k in keys:
        np.testing.assert_allclose(float(parts[k]), float(want_parts[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(param, want_param, rtol=0, atol=2e-5)


@pytest.mark.parametrize("loss", ["liscore", "listwise", "liscore_std",
                                  "infonce_distill", "infonce_sup", "score",
                                  "spl", "ranknet"])
def test_sharded_step_matches_jax_and_one_device(loss):
    """Every collective loss form and the (B, N) row-gather fallback
    (ranknet): one step on 4 shards against JAX's 4-shard step and against
    the port's one-device step."""
    assert has_collective_form(loss) == (loss != "ranknet")
    d = _data(1)
    kw = dict(BASE, loss=loss)
    parts, param, _, _ = _port_sharded(kw, d, 4)
    jparts, jparam = _jax_step(kw, d, 4, jax.random.PRNGKey(0))
    assert set(parts) == set(jparts)
    _assert_same(parts, param, jparts, jparam)
    oparts, oparam = _port_one(kw, d)
    _assert_same(parts, param, oparts, oparam)


@pytest.mark.parametrize("case", ["empty_doc", "k3", "qat_int8",
                                  "precomputed_teacher"])
def test_sharded_step_variants_match(case):
    """An all-masked real doc (it scores 0 and stays in every softmax
    denominator and MSE count), K = 3 steps a dispatch, a QAT int8 step
    (per-token STE, shard-local) and a step on the sharded precomputed
    teacher table: against JAX's 4-shard step and the port's one-device
    step (which scores its teacher inline: the table holds the same
    scores)."""
    d = _data(2, empty_doc=case == "empty_doc")
    kw = dict(BASE, loss="liscore")
    k_steps = 3 if case == "k3" else 1
    if case == "k3":
        kw["steps_per_dispatch"] = 3
    if case == "qat_int8":
        kw["qat"] = "int8"
    sct = case == "precomputed_teacher"
    parts, param, opt, _ = _port_sharded(kw, d, 4, k_steps=k_steps, sct=sct)
    keys = jax.random.PRNGKey(0)
    jparts, jparam = _jax_step(kw, d, 4, keys, k_steps=k_steps, sct=sct)
    _assert_same(parts, param, jparts, jparam,
                 keys=["total_loss", "listwise", "score"]
                 + (["total_loss_sum"] if k_steps > 1 else []))
    oparts, oparam = _port_one(kw, d, k_steps=k_steps)
    _assert_same(parts, param, oparts, oparam,
                 keys=["total_loss", "listwise", "score"])
    assert int(opt.state[opt.param_groups[0]["params"][0]]["step"]) == k_steps


@pytest.mark.parametrize("noise", [0.0, 0.1])
def test_sharded_hardtoken_step_matches(monkeypatch, noise):
    """Hard-token virtual queries on 4 shards: global candidate ranks by
    count of greater, the hard token from the owning shard, the JAX step's
    noise injected; against JAX's 4-shard step and the port's one-device
    step (the one-device ranks, by double argsort, are the same on
    untied scores)."""
    d = _data(3)
    kw = dict(BASE, loss="liscore", aug="hardtoken", virt_noise_std=noise,
              aux_docs=3)
    key = jax.random.PRNGKey(5)
    _, fake_noise = _jax_draws([key], N, 0.4)
    monkeypatch.setattr(harness, "virtual_query_noise", fake_noise)
    parts, param, _, _ = _port_sharded(kw, d, 4)
    jparts, jparam = _jax_step(kw, d, 4, key)
    assert {"aux", "aux_listwise", "aux_score"} <= set(parts)
    _assert_same(parts, param, jparts, jparam)
    _, fake_noise = _jax_draws([key], N, 0.4)
    monkeypatch.setattr(harness, "virtual_query_noise", fake_noise)
    oparts, oparam = _port_one(kw, d)
    _assert_same(parts, param, oparts, oparam,
                 keys=[k for k in jparts if not k.startswith("_")])


@pytest.mark.parametrize("world", [1, 4])
def test_sharded_mixup_step_matches(monkeypatch, world):
    """Mixup draws ONE permutation of a shard's rows and applies it on
    every shard. At one shard that is the one-device mixup: the port's
    mesh step equals its one-device step on the same (real) draws, and
    JAX's one-device step on JAX's draws. At 4 shards: JAX's 4-shard step
    on its draws (a permutation of the 5 rows of a shard; pairs whose
    partner is padding leave the mix MSE)."""
    d = _data(4)
    kw = dict(BASE, loss="liscore", aug="mixup", mixup_alpha=0.4,
              lambda_mix=0.5)
    if world == 1:
        parts, param, _, _ = _port_sharded(kw, d, 1, seed=11)
        oparts, oparam = _port_one(kw, d, seed=11)
        _assert_same(parts, param, oparts, oparam)
    key = jax.random.PRNGKey(7)
    fake_mixup, _ = _jax_draws([key], -(-N // world), 0.4)
    monkeypatch.setattr(harness, "mixup_draws", fake_mixup)
    parts, param, _, _ = _port_sharded(kw, d, world)
    jparts, jparam = _jax_step(kw, d, world if world > 1 else 0, key)
    assert {"mix", "score_mix"} <= set(parts)
    _assert_same(parts, param, jparts, jparam,
                 keys=[k for k in jparts if not k.startswith("_")])


def test_sharded_qnoise_step_matches_one_device():
    """qnoise draws its query noise once on the first device, so every
    shard scores the same noisy batch and the teacher is rescored with
    it: equal to the port's one-device step at the same seed."""
    d = _data(5)
    kw = dict(BASE, loss="liscore", aug="qnoise", q_noise_std=0.2)
    parts, param, _, _ = _port_sharded(kw, d, 4, seed=3)
    oparts, oparam = _port_one(kw, d, seed=3)
    _assert_same(parts, param, oparts, oparam)


def test_sharded_teacher_precompute_and_eval_loss():
    """The sharded teacher table equals the one-device precompute's
    columns and JAX's sharded table; the sharded eval loss (with the table
    and rescoring inline) equals JAX's and the one-device
    ``evaluation_loss``."""
    d = _data(6, empty_doc=True)
    mesh = mesh_of(["cpu"] * 4)
    Q, qm = torch.from_numpy(d["Q"]), torch.from_numpy(d["qm"])
    Pt, pmt = _shards(d["P_t"], mesh, 20), _shards(d["pm_t"], mesh, 20)
    sct = precompute_teacher_scores_sharded(Q, qm, Pt, pmt, mesh, chunk_q=5,
                                            chunk_p=8, impl="xla")
    assert [tuple(s.shape) for s in sct] == [(NT, 5)] * 4
    one = harness._precompute_teacher_scores(
        Q, qm, torch.from_numpy(d["P_t"]), torch.from_numpy(d["pm_t"]),
        chunk_q=256, chunk_p=8, impl="xla")
    full = torch.cat(sct, dim=1)
    np.testing.assert_allclose(full[:, :N].numpy(), one.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert not full[:, N:].any()
    jmesh = jax_make_mesh(4)
    jt = jax_build_index(d["P_t"], d["pm_t"], jmesh)
    jsct = jax_precompute_sharded(replicate(jnp.asarray(d["Q"]), jmesh),
                                  replicate(jnp.asarray(d["qm"]), jmesh),
                                  jt.P, jt.pmask, jmesh, chunk_q=5, chunk_p=8)
    np.testing.assert_allclose(full.numpy(), np.asarray(jsct), rtol=1e-5,
                               atol=1e-6)

    kw = dict(BASE, loss="liscore")
    cfg = TrainConfig(**kw)
    params = _shards(d["Pbar"], mesh, 20)
    pms = _shards(d["pm_s"], mesh, 20)
    ev = build_sharded_eval_loss(cfg, mesh, N)
    got_sct = ev(params, pms, Pt, pmt, Q, qm, sct_rows=sct)
    got_inline = ev(params, pms, Pt, pmt, Q, qm)
    jev = jax_sharded_eval_loss(JaxConfig(**kw), jmesh, N)
    jtotal, jparts = jev(shard_docs(jnp.asarray(_pad(d["Pbar"], 20)), jmesh),
                         shard_docs(jnp.asarray(_pad(d["pm_s"], 20)), jmesh),
                         jt.P, jt.pmask, replicate(jnp.asarray(d["Q"]), jmesh),
                         replicate(jnp.asarray(d["qm"]), jmesh), sct_rows=jsct)
    _, tb = _bundles(d)
    tb.sc_t_test = one
    want = evaluation_loss(cfg, tb, torch.from_numpy(d["Pbar"]),
                           torch.from_numpy(d["pm_s"]))
    for total, parts in (got_sct, got_inline):
        np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
        np.testing.assert_allclose(float(total), want["total_loss"],
                                   rtol=1e-5)
        for k in jparts:
            np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(float(parts[k]), want[f"loss_{k}"],
                                       rtol=1e-5, atol=1e-7, err_msg=k)


def test_collectives_on_one_process_mesh():
    """psum, all_gather_cat and global_max over a one-process mesh: the
    shards' sum, concatenation in shard order and max, with autograd
    through the moves."""
    from evdr_tpu_torch.parallel.train_sharded import (all_gather_cat,
                                                       global_max, psum)

    mesh = mesh_of(["cpu"] * 3)
    xs = [torch.arange(4.0).reshape(2, 2).add(i * 10).requires_grad_(True)
          for i in range(3)]
    s = psum(xs, mesh)
    assert torch.equal(s.detach(), sum(x.detach() for x in xs))
    g = all_gather_cat(xs, mesh, dim=1)
    assert torch.equal(g.detach(), torch.cat([x.detach() for x in xs], 1))
    m = global_max(xs, mesh)
    assert not m.requires_grad and torch.equal(m, xs[2].detach())
    (s.sum() + 2 * g.sum()).backward()
    for x in xs:
        assert torch.equal(x.grad, torch.full((2, 2), 3.0))


def test_one_device_config_refuses_a_mesh(tmp_path):
    cfg = TrainConfig(datasets=["x"], mesh_docs=0)
    with pytest.raises(ValueError, match="mesh_docs"):
        harness.run_training(cfg, device="cpu", mesh=mesh_of(["cpu"] * 2))
    with pytest.raises(ValueError, match="need 4 devices"):
        harness.run_training(dataclasses.replace(cfg, mesh_docs=4),
                             device="cpu")
