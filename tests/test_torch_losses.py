"""The torch port's distillation losses against the JAX package's, on the
CPU: value and gradient with respect to the student scores of every
``LOSS_REGISTRY`` entry and every ``COMBINED_RECIPES`` recipe.

Score matrices are made with numpy from a seed (distinct values, so top-k
and argsort orders are tie-free) and handed to both packages in float32.
Only the order of float32 reductions differs -> rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evdr_tpu.losses import distill as jd
from evdr_tpu_torch.losses import distill as td

HP = {"temperature": 0.1, "k": 4, "lambda_list": 1.0, "lambda_score": 0.7,
      "lambda_pair": 0.5, "lambda_info": 0.3, "list_temp": 0.5,
      "info_temp": 0.2, "alpha": 1.3, "eps": 1e-6, "lambda_weight": 0.8}


def _scores(seed, b=6, n=9):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(b, n)).astype(np.float32) * 2.0
    t = rng.normal(size=(b, n)).astype(np.float32) * 2.0
    labels = rng.integers(0, n, size=b).astype(np.int32)
    return s, t, labels


def _jax_value_and_grad(fn, s):
    val, grad = jax.value_and_grad(lambda x: fn(x))(jnp.asarray(s))
    return float(val), np.asarray(grad)


def _torch_value_and_grad(fn, s):
    x = torch.tensor(s, requires_grad=True)
    val = fn(x)
    val.backward()
    return float(val.detach()), x.grad.numpy()


def _check(jfn, tfn, s):
    jv, jg = _jax_value_and_grad(jfn, s)
    tv, tg = _torch_value_and_grad(tfn, s)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tg, jg, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jg).max()) + 1e-9)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(jd.LOSS_REGISTRY))
def test_registry_loss_value_and_grad_match_jax(name, seed):
    s, t, labels = _scores(seed)
    jfn_base, needs_labels = jd.LOSS_REGISTRY[name]
    tfn_base, t_needs = td.LOSS_REGISTRY[name]
    assert t_needs == needs_labels
    kw = jd._component_kwargs(name, name, HP)
    assert td._component_kwargs(name, name, HP) == kw
    if needs_labels:
        _check(lambda x: jfn_base(x, jnp.asarray(labels), **kw),
               lambda x: tfn_base(x, torch.from_numpy(labels), **kw), s)
    else:
        _check(lambda x: jfn_base(x, jnp.asarray(t), **kw),
               lambda x: tfn_base(x, torch.from_numpy(t), **kw), s)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(jd.COMBINED_RECIPES))
def test_combined_recipe_value_grad_and_parts_match_jax(name, seed):
    s, t, _ = _scores(seed + 10)
    assert td.COMBINED_RECIPES[name] == jd.COMBINED_RECIPES[name]
    _check(lambda x: jd.combined_loss(name, x, jnp.asarray(t), HP)[0],
           lambda x: td.combined_loss(name, x, torch.from_numpy(t), HP)[0], s)
    _, jparts = jd.combined_loss(name, jnp.asarray(s), jnp.asarray(t), HP)
    _, tparts = td.combined_loss(name, torch.from_numpy(s),
                                 torch.from_numpy(t), HP)
    assert set(tparts) == set(jparts)
    for k in jparts:
        np.testing.assert_allclose(float(tparts[k]), float(jparts[k]),
                                   rtol=1e-5, atol=1e-7)


def test_teacher_scores_get_no_gradient():
    # jax stop_gradient <-> torch .detach(): the teacher side of every
    # distillation loss receives no gradient
    s, t, _ = _scores(3)
    for name in sorted(td.LOSS_REGISTRY):
        fn, needs_labels = td.LOSS_REGISTRY[name]
        if needs_labels:
            continue
        xs = torch.tensor(s, requires_grad=True)
        xt = torch.tensor(t, requires_grad=True)
        fn(xs, xt, **td._component_kwargs(name, name, HP)).backward()
        assert xt.grad is None or float(xt.grad.abs().max()) == 0.0, name
        assert xs.grad is not None


def test_listwise_top_k_ties_pick_the_lower_index_like_lax_top_k():
    # teacher rows with tied probabilities: lax.top_k and the port's stable
    # sort both keep the lower doc index
    s = np.arange(12, dtype=np.float32).reshape(2, 6) / 7.0
    t = np.array([[1, 1, 1, 0, 0, 0], [0, 2, 2, 2, 2, 0]], np.float32)
    kw = {"k": 2, "temperature": 0.5}
    _check(lambda x: jd.listwise_distillation_loss(x, jnp.asarray(t), **kw),
           lambda x: td.listwise_distillation_loss(
               x, torch.from_numpy(t), **kw), s)
