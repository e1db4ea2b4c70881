"""repro_torch.core.distance against the JAX package's core/distance.py, on
inputs made with numpy from a seed (distances within 2e-4 on real-valued
data, bit for bit on integer-valued data; ids exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distance as jdist
from repro_torch.core import distance as tdist

TOL = 2e-4


def _data(seed, n, m, d, integer):
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(0, 256, size=(n, d)).astype(np.float32)
        c = rng.integers(0, 256, size=(m, d)).astype(np.float32)
    else:
        x = rng.standard_normal((n, d)).astype(np.float32)
        c = rng.standard_normal((m, d)).astype(np.float32)
    return x, c


def _close(a, b, exact):
    a, b = np.asarray(a), np.asarray(b)
    if exact:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n,d", [(1, 4), (37, 16), (200, 128)])
def test_sq_norms(n, d, integer):
    x, _ = _data(n, n, 1, d, integer)
    _close(jdist.sq_norms(jnp.asarray(x)), tdist.sq_norms(torch.as_tensor(x)),
           integer)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n,m,d", [(50, 30, 8), (128, 256, 128)])
def test_sq_dists(n, m, d, integer):
    x, c = _data(m, n, m, d, integer)
    jd = jdist.sq_dists(jnp.asarray(x), jnp.asarray(c))
    td = tdist.sq_dists(torch.as_tensor(x), torch.as_tensor(c))
    if integer:
        _close(jd, td, True)
    else:
        np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=TOL,
                                   atol=TOL * 10)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n,m,d", [(64, 16, 8), (100, 256, 128), (9, 1, 3)])
def test_nearest(n, m, d, integer):
    x, c = _data(n + m, n, m, d, integer)
    if integer and m > 1:
        c[m // 2:] = c[: m - m // 2]  # duplicate centroids: first index wins
    ji, jd = jdist.nearest(jnp.asarray(x), jnp.asarray(c))
    ti, td = tdist.nearest(torch.as_tensor(x), torch.as_tensor(c))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    assert ti.dtype == torch.int32
    _close(jd, td, integer)


@pytest.mark.parametrize("k", [1, 3, 8, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_lex_matches_lax_top_k_with_ties(seed, k):
    rng = np.random.default_rng(seed)
    # few distinct values, so most rows hold many exact ties; inf too
    v = rng.integers(0, 4, size=(20, 16)).astype(np.float32)
    v[rng.random(v.shape) < 0.2] = np.inf
    neg, jidx = jax.lax.top_k(-jnp.asarray(v), k)
    tval, tidx = tdist.topk_lex(torch.as_tensor(v), k)
    np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy())
    np.testing.assert_array_equal(-np.asarray(neg), tval.numpy())


def test_topk_lex_breaks_ties_to_lower_index():
    v = torch.tensor([[2.0, 1.0, 1.0, 0.0, 1.0]])
    vals, idx = tdist.topk_lex(v, 4)
    assert idx.tolist() == [[3, 1, 2, 4]]
    assert vals.tolist() == [[0.0, 1.0, 1.0, 1.0]]


@pytest.mark.parametrize("integer", [True, False])
def test_topk_neighbors(integer):
    x, c = _data(5, 30, 60, 16, integer)
    if integer:
        c[30:] = c[:30]
    ji, jd = jdist.topk_neighbors(jnp.asarray(x), jnp.asarray(c), 7)
    ti, td = tdist.topk_neighbors(torch.as_tensor(x), torch.as_tensor(c), 7)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    _close(jd, td, integer)
