"""repro_torch's capacity-padded dispatch (``core/dispatch.py``) against the
JAX package's, on the CPU.

The structural outputs (``gather_idx``, ``slot_valid``, ``slot_of_row``,
``fits``, ``overflow``) are held exactly, with and without overflow and
with rows assigned outside the buckets (the routed MoE marks its empty
slots so); ``dispatch_rows`` and ``combine_rows`` move values without
arithmetic, so they are held bit for bit too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as jd
from repro_torch.core import dispatch as td

CASES = [  # (n, n_buckets, capacity, out-of-range share)
    (64, 4, 32, 0.0),  # fits
    (200, 8, 16, 0.2),  # overflows, with rows outside the buckets
    (37, 5, 40, 0.3),  # fits, with rows outside the buckets
]


def _assign(n, n_buckets, outside, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n_buckets, n).astype(np.int32)
    a[rng.random(n) < outside] = n_buckets  # the routed variant's "invalid"
    return a


@pytest.mark.parametrize("n,n_buckets,capacity,outside", CASES)
def test_dispatch_matches_the_reference(n, n_buckets, capacity, outside):
    seed = n  # one draw a case
    a = _assign(n, n_buckets, outside, seed)
    want = jd.make_dispatch(jnp.asarray(a), n_buckets, capacity)
    got = td.make_dispatch(torch.as_tensor(a), n_buckets, capacity)
    for field in jd.Dispatch._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    assert got.gather_idx.dtype == got.slot_of_row.dtype == torch.int32
    assert got.overflow.dtype == torch.int32
    in_range = a < n_buckets
    counts = np.bincount(a[in_range], minlength=n_buckets)
    assert int(got.overflow) == int(np.maximum(counts - capacity, 0).sum())

    rng = np.random.default_rng(seed + 10)
    x = rng.standard_normal((n, 3, 2)).astype(np.float32)
    d_want = jd.dispatch_rows(want, jnp.asarray(x))
    d_got = td.dispatch_rows(got, torch.as_tensor(x))
    np.testing.assert_array_equal(d_got.numpy(), np.asarray(d_want))
    y = rng.standard_normal((n_buckets, capacity, 5)).astype(np.float32)
    for fill in (0, -7.5):
        c_want = jd.combine_rows(want, jnp.asarray(y), fill=fill)
        c_got = td.combine_rows(got, torch.as_tensor(y), fill=fill)
        np.testing.assert_array_equal(c_got.numpy(), np.asarray(c_want))


def test_dispatch_then_combine_is_the_identity_on_kept_rows():
    a = _assign(300, 6, 0.1, 3)
    d = td.make_dispatch(torch.as_tensor(a), 6, 40)
    x = torch.randn(300, 4, generator=torch.Generator().manual_seed(0))
    back = td.combine_rows(d, td.dispatch_rows(d, x))
    assert torch.equal(back[d.fits], x[d.fits])
    assert bool((back[~d.fits] == 0).all())
    # a bucket keeps its first rows in row order (the counting sort is stable)
    for b in range(6):
        rows = np.flatnonzero(a == b)[:40]
        got = d.gather_idx[b][d.slot_valid[b]].numpy()
        np.testing.assert_array_equal(got, rows)
