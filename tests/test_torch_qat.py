"""The port's quantization-aware distillation (``evdr_tpu_torch/ops/qat.py``)
against the JAX package's ``evdr_tpu.ops.qat`` and against the port's own
serving quantizers, on the CPU.

The same seeded numpy inputs go to both packages. Each ``qdq_*`` and
``qat_apply`` must equal the JAX function bit for bit (the same f32
divide / round-half-even / clip / multiply chain, and for PQ the same
centroid picked and gathered), and equal the serving round trip of the
port's quantizers bit for bit; the STE gradient is the identity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evdr_tpu.ops import qat as jqat
from evdr_tpu.ops.pq import train_pq as jax_train_pq
from evdr_tpu_torch.data.packing import l2_normalize
from evdr_tpu_torch.ops import qat
from evdr_tpu_torch.ops.int4 import dequantize_int4, quantize_tokens_int4
from evdr_tpu_torch.ops.pq import (decode_pq, encode_with_books,
                                   expand_books, train_opq, train_pq)
from evdr_tpu_torch.ops.quantize import dequantize_int8, quantize_tokens_int8


def _student(seed=0, n=6, lp=7, d=16, live_zero=True):
    """Normalized masked student tokens (the form qat_apply sees), with a
    fully masked doc and, optionally, a LIVE token that is all zero."""
    rng = np.random.default_rng(seed)
    P = rng.normal(size=(n, lp, d)).astype(np.float32)
    pmask = rng.random((n, lp)) > 0.25
    pmask[0, :] = True
    pmask[1, :] = False
    if live_zero:
        P[0, 1] = 0.0
    Ps = l2_normalize(P * pmask[..., None].astype(np.float32)).astype(
        np.float32)
    return Ps, pmask


def _pq_books(Ps, pmask, m, expanded, seed=0):
    if not expanded:
        return train_pq(Ps, pmask, m=m, k=8, iters=6, seed=seed)
    books, rot = train_opq(Ps, pmask, m=m, k=8, iters=6, opq_iters=2,
                           seed=seed)
    return expand_books(books, rot)


@pytest.mark.parametrize("seed,lp", [(1, 7), (2, 6), (3, 33)])
@pytest.mark.parametrize("tier", ["int8", "int4"])
def test_qdq_symmetric_matches_jax_and_the_serving_grid(seed, lp, tier):
    Ps, pmask = _student(seed=seed, lp=lp)
    fn, jfn = ((qat.qdq_int8, jqat.qdq_int8) if tier == "int8"
               else (qat.qdq_int4, jqat.qdq_int4))
    got = fn(torch.from_numpy(Ps)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfn(jnp.asarray(Ps))))
    if tier == "int8":
        ref = dequantize_int8(*quantize_tokens_int8(Ps, pmask))
    else:
        ref = dequantize_int4(*quantize_tokens_int4(Ps, pmask))
    np.testing.assert_array_equal(got, ref)
    assert np.all(got[~pmask] == 0.0) and np.all(got[0, 1] == 0.0)


@pytest.mark.parametrize("expanded", [False, True])
@pytest.mark.parametrize("seed", [3, 4])
def test_qdq_pq_matches_jax_and_the_serving_reconstruction(seed, expanded):
    """Compact books concatenate, expanded OPQ books sum; pmask zeroes the
    masked tokens and leaves a live all-zero token its nearest centroid to
    0, as the serving encoder does."""
    Ps, pmask = _student(seed=seed, n=24, lp=8, d=16)
    books = _pq_books(Ps, pmask, 4, expanded)
    got = qat.qdq_pq(torch.from_numpy(Ps), torch.from_numpy(books),
                     pmask=torch.from_numpy(pmask)).numpy()
    want = np.asarray(jqat.qdq_pq(jnp.asarray(Ps), jnp.asarray(books),
                                  pmask=jnp.asarray(pmask)))
    np.testing.assert_array_equal(got, want)
    ref = decode_pq(encode_with_books(Ps, books, pmask), books,
                    expanded=expanded)
    ref[~pmask] = 0.0
    np.testing.assert_array_equal(got, ref)
    assert np.any(got[0, 1] != 0.0)  # the live all-zero token
    # without pmask an all-zero token counts as masked (the JAX fallback)
    got_nm = qat.qdq_pq(torch.from_numpy(Ps), torch.from_numpy(books)).numpy()
    np.testing.assert_array_equal(
        got_nm, np.asarray(jqat.qdq_pq(jnp.asarray(Ps), jnp.asarray(books))))
    assert np.all(got_nm[0, 1] == 0.0)


def test_qdq_pq_first_index_wins_a_tie():
    # two equal centroids: both packages pick the first (argmin's rule)
    books = np.zeros((2, 3, 2), np.float32)
    books[:, 1] = books[:, 2] = [0.6, 0.8]
    x = np.array([[[0.6, 0.8, 0.6, 0.8]]], np.float32)
    got = qat.qdq_pq(torch.from_numpy(x), torch.from_numpy(books))
    want = jqat.qdq_pq(jnp.asarray(x), jnp.asarray(books))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert qat._pq_assign(torch.from_numpy(x[0]), torch.from_numpy(books),
                          False).tolist() == [[1, 1]]


@pytest.mark.parametrize("tier", ["int8", "int4", "pq", "opq"])
def test_qat_apply_matches_jax_and_passes_an_identity_gradient(tier):
    Ps, pmask = _student(seed=6, n=16, lp=8, d=16)
    books = (_pq_books(Ps, pmask, 4, tier == "opq")
             if tier in ("pq", "opq") else None)
    jb = None if books is None else jnp.asarray(books)
    tb = None if books is None else torch.from_numpy(books)
    w = np.random.default_rng(5).normal(size=Ps.shape).astype(np.float32)
    x = torch.from_numpy(Ps).requires_grad_(True)
    out = qat.qat_apply(x, tier, tb, pmask=torch.from_numpy(pmask))
    want = jqat.qat_apply(jnp.asarray(Ps), tier, jb, pmask=jnp.asarray(pmask))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    assert np.all(out.detach().numpy()[~pmask] == 0.0)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), w)
    jg = jax.grad(lambda y: jnp.sum(jqat.qat_apply(
        y, tier, jb, pmask=jnp.asarray(pmask)) * w))(jnp.asarray(Ps))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg))


def test_qat_apply_none_is_identity_and_bad_settings_raise():
    Ps, _ = _student(seed=7)
    x = torch.from_numpy(Ps)
    assert qat.qat_apply(x, "none") is x
    with pytest.raises(ValueError, match="unknown"):
        qat.qat_apply(x, "int3")
    with pytest.raises(ValueError, match="codebooks"):
        qat.qat_apply(x, "pq")


def test_ste_forward_is_the_jax_form():
    # x + (q - x) is not always q in f32; both packages keep that form
    x = np.array([1e-8, 0.3, -2.5e-3, 7.0], np.float32)
    q = np.array([1.0, 0.3000001, 0.0, 7.5], np.float32)
    got = qat.ste(torch.from_numpy(x), torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jqat.ste(jnp.asarray(x), jnp.asarray(q))))


def test_train_pq_is_the_jax_package_s():
    # the QAT refit's codebooks come from the port's copy of train_pq
    Ps, pmask = _student(seed=8, n=30, lp=9, d=16)
    np.testing.assert_array_equal(
        train_pq(Ps, pmask, m=4, k=8, iters=5, seed=2),
        jax_train_pq(Ps, pmask, m=4, k=8, iters=5, seed=2))
