"""repro_torch kernels: plain versions against the JAX package's ref.py and
its Pallas kernels (interpret mode), and on the card the CUDA kernels
against their plain versions.

Inputs are made with numpy from a seed. Tolerances: on real-valued data
ids exact and distances within 2e-4 (the reference's contract: sums are
taken in another order); on integer-valued data (quantized SIFT-like rows,
every partial sum an integer below 2^24) bit for bit. Integers in [0, 255]
are exact in TF32 and bf16 too, so reduced precision is caught on
real-valued data instead: within the fp32 error bound of a float64 oracle
(``kernels/fp32_bound.py``), which TF32 rounding must break.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fusedscan.ops import fused_topk as j_fused_topk
from repro.kernels.fusedscan.ref import fused_topk_ref as j_fused_ref
from repro.kernels.l2nn.ops import l2_nearest as j_l2_nearest
from repro.kernels.l2nn.ref import l2_nearest_ref as j_l2nn_ref
from repro.kernels.l2topk.ops import l2_topk as j_l2_topk
from repro.kernels.l2topk.ref import l2_topk_ref as j_l2topk_ref
from repro_torch import interop
from repro_torch.core.sentinels import LEAF_SENTINEL, PAD_QUERY_LEAF
from repro_torch.kernels import fp32_bound
from repro_torch.kernels.adcscan.ops import MAX_K as adc_max_k
from repro_torch.kernels.fusedscan.ops import fused_topk
from repro_torch.kernels.fusedscan.ref import fused_topk_ref
from repro_torch.kernels.l2nn.ops import l2_nearest
from repro_torch.kernels.l2nn.ref import l2_nearest_ref
from repro_torch.kernels.l2topk import ops as l2topk_ops
from repro_torch.kernels.l2topk.ops import l2_topk, resident_clusters
from repro_torch.kernels.l2topk.ref import l2_topk_ref

TOL = 2e-4


def _vecs(rng, n, d, integer):
    if integer:
        return rng.integers(0, 256, size=(n, d)).astype(np.float32)
    return rng.standard_normal((n, d)).astype(np.float32)


def _tile_case(seed, P, Q, d, n_leaves, integer=True, dup=True, sort=False,
               sort_points=False):
    """Points/queries with leaves from a small set; duplicated point rows
    make exact distance ties, so the tie order is exercised. ``sort``
    sorts both sides by leaf, ``sort_points`` the points only (the K1
    kernel's contract: a wave's points ascend, lookup rows in any order)."""
    rng = np.random.default_rng(seed)
    pts = _vecs(rng, P, d, integer)
    if dup and P >= 4:
        pts[P // 2: P // 2 + P // 4] = pts[: P // 4]
    qrs = _vecs(rng, Q, d, integer)
    plf = rng.integers(0, n_leaves, size=P).astype(np.int32)
    qlf = rng.integers(0, n_leaves, size=Q).astype(np.int32)
    if dup and P >= 4:
        plf[P // 2: P // 2 + P // 4] = plf[: P // 4]
    if sort or sort_points:
        order = np.argsort(plf, kind="stable")
        pts, plf = pts[order], plf[order]
    if sort:
        qo = np.argsort(qlf, kind="stable")
        qrs, qlf = qrs[qo], qlf[qo]
    return pts, plf, qrs, qlf


def _wave_case(kind, seed=0, P=4096, Q=1024, d=128):
    """A wave shaped like the main path's (``P`` leaf-sorted index rows,
    a ``Q``-row lookup slab in random order, quantized SIFT-range rows):

    * ``sentinel_tail``: about 16 leaf runs, the last quarter of the rows
      ``LEAF_SENTINEL`` routing padding;
    * ``padded_lookup``: the same runs, a third of the lookup rows
      ``PAD_QUERY_LEAF``;
    * ``long_run``: one leaf's run of 1,500 rows among short ones;
    * ``one_run``: a single leaf fills the wave;
    * ``sentinel_wave``: every row ``LEAF_SENTINEL`` (no row matches).

    Lookup leaves fall on the wave's leaves, next to them and far from
    them, so rows of every kind occur; duplicated rows make exact ties.
    Returns (points, point leaves, queries, query leaves) as numpy arrays.
    """
    rng = np.random.default_rng(seed)
    base = 1000 + 37 * seed
    if kind == "long_run":
        runs = [300, 1500] + [200] * 11 + [P - 300 - 1500 - 2200]
    elif kind == "one_run":
        runs = [P]
    else:
        runs = list(rng.multinomial(P - 16, np.full(16, 1 / 16)) + 1)
    plf = np.repeat(base + 2 * np.arange(len(runs)), runs).astype(np.int32)
    if kind == "sentinel_tail":
        plf[-P // 4:] = LEAF_SENTINEL
    elif kind == "sentinel_wave":
        plf[:] = LEAF_SENTINEL
    pts = rng.integers(0, 256, size=(P, d)).astype(np.float32)
    pts[P // 2: P // 2 + 64] = pts[P // 2 - 64: P // 2]  # exact ties
    qlf = rng.choice(base + np.arange(-5, 2 * len(runs) + 5), size=Q).astype(np.int32)
    if kind == "padded_lookup":
        qlf[rng.random(Q) < 1 / 3] = PAD_QUERY_LEAF
    qrs = rng.integers(0, 256, size=(Q, d)).astype(np.float32)
    return pts, plf, qrs, qlf


def _t(*arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


def _assert_table(d_a, i_a, d_b, i_b, *, exact, id_frac=1.0):
    """Equal tables; ``id_frac < 1`` lets that share of ids differ, for
    real-valued data summed in another order on the card (two candidates
    within rounding of each other may swap places)."""
    d_a, d_b = np.asarray(d_a), np.asarray(d_b)
    if id_frac == 1.0:
        np.testing.assert_array_equal(np.asarray(i_a), np.asarray(i_b))
    else:
        assert (np.asarray(i_a) == np.asarray(i_b)).mean() >= id_frac
    np.testing.assert_array_equal(np.isfinite(d_a), np.isfinite(d_b))
    fin = np.isfinite(d_a)
    if exact:
        np.testing.assert_array_equal(d_a, d_b)
    else:
        np.testing.assert_allclose(d_a[fin], d_b[fin], rtol=TOL, atol=TOL)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# plain versions against the JAX package (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize(
    "P,Q,d,k,n_leaves",
    [(96, 40, 16, 5, 3), (130, 70, 8, 8, 5), (64, 64, 32, 20, 2),
     (33, 17, 4, 3, 1)],
)
def test_l2topk_plain_matches_jax_ref(P, Q, d, k, n_leaves, integer):
    pts, plf, qrs, qlf = _tile_case(P + Q, P, Q, d, n_leaves, integer)
    jd, ji = j_l2topk_ref(jnp.asarray(pts), jnp.asarray(plf), jnp.asarray(qrs),
                          jnp.asarray(qlf), k)
    td, ti = l2_topk(*_t(pts, plf, qrs, qlf), k=k)
    _assert_table(jd, ji, td, ti, exact=integer)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("k", [65, 100, 128, 256])
def test_l2topk_plain_matches_jax_ref_at_wide_k(k, integer):
    # past the K1 kernel's list capacity (64), up to the wave's rows: the
    # reference serves any k <= block_rows (ROADMAP P7)
    pts, plf, qrs, qlf = _tile_case(k, 600, 50, 16, 2, integer, sort_points=True)
    jd, ji = j_l2topk_ref(jnp.asarray(pts), jnp.asarray(plf), jnp.asarray(qrs),
                          jnp.asarray(qlf), k)
    td, ti = l2_topk(*_t(pts, plf, qrs, qlf), k=k)
    _assert_table(jd, ji, td, ti, exact=integer)
    assert np.isfinite(td.numpy()[:, k - 1]).any()


@pytest.mark.parametrize("P,Q,d,k", [(200, 100, 16, 6), (128, 256, 8, 4)])
def test_l2topk_plain_matches_pallas_interpret(P, Q, d, k):
    # the Pallas kernel contracts [-2q|1].[p|‖p‖²] and keeps an unordered
    # table, so it is held by distance only (within 2e-4)
    pts, plf, qrs, qlf = _tile_case(7, P, Q, d, 4, integer=False, dup=False)
    jd, _ = j_l2_topk(jnp.asarray(pts), jnp.asarray(plf), jnp.asarray(qrs),
                      jnp.asarray(qlf), k=k, impl="pallas", tile_p=128,
                      tile_q=128)
    td, ti = l2_topk(*_t(pts, plf, qrs, qlf), k=k)
    jd = np.asarray(jd)
    np.testing.assert_array_equal(np.isfinite(jd), np.isfinite(td.numpy()))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(jd[fin], td.numpy()[fin], rtol=TOL, atol=TOL)
    assert (ti.numpy()[~fin] == -1).all()


_CSRC = Path(l2topk_ops.__file__).resolve().parents[2] / "csrc"


def _constant(source: str, name: str) -> int:
    """``constexpr int <name> = <value>;`` of a CUDA source."""
    text = (_CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_route_constants_are_the_kernels():
    # the wrappers' capacities are the ones the CUDA sources compile with
    assert l2topk_ops.MAX_K == _constant("common.cuh", "DENSE_KCAP")
    assert adc_max_k == _constant("common.cuh", "ADC_KCAP")
    assert l2topk_ops.WIDE_KCAP == _constant("common.cuh", "WIDE_KCAP")
    assert l2topk_ops.WIDE_SMEM_K == _constant("widetopk.cu", "W_SMEM_K")


@pytest.mark.parametrize("kcap,wide", [(64, 256), (128, 256), (128, 128)],
                         ids=["64", "128", "k4"])
def test_every_k_maps_to_exactly_one_route(kcap, wide):
    # each k from 1 to past the shared-memory lists goes to one kernel, and
    # the ranges meet without a gap at the list capacities (K4 has no wide
    # range: past 128 it goes to the block list kernel)
    seen = {}
    for k in range(1, 3 * l2topk_ops.WIDE_SMEM_K):
        r = l2topk_ops.route(k, kcap, wide)
        assert r in l2topk_ops.ROUTES
        seen.setdefault(r, [k, k])[1] = k
    want = {"lists": [1, kcap],
            "wide_lists": [kcap + 1, wide],
            "block_list": [wide + 1, l2topk_ops.WIDE_SMEM_K],
            "block_list_scratch": [l2topk_ops.WIDE_SMEM_K + 1,
                                   3 * l2topk_ops.WIDE_SMEM_K - 1]}
    if wide == kcap:
        del want["wide_lists"]
    assert seen == want
    # the main path's wide calls: K1/K2 at k = 100, K5 at rerank 256 on
    # their lists of 256, K4 at rerank 256 and every call at 512 on the
    # block list kernel
    assert l2topk_ops.route(100) == "wide_lists"
    assert l2topk_ops.route(256, adc_max_k) == "wide_lists"
    assert l2topk_ops.route(256, adc_max_k, adc_max_k) == "block_list"
    assert l2topk_ops.route(512) == l2topk_ops.route(512, adc_max_k) == "block_list"


def test_adc_shared_memory_check_follows_the_routes():
    # K4's lists and K5's list of 256 take the LUT and one list; past them
    # the block list kernel's arrays, its lists in shared memory up to 4,096
    from repro_torch.kernels.adcscan.ops import (
        MAX_SMEM,
        WIDE_STATIC_SMEM,
        _smem_bytes,
    )
    from repro_torch.kernels.l2topk.ops import WIDE_KCAP, WIDE_SMEM_K
    m, C = 8, 256
    assert _smem_bytes(m, C, 128) == 4 * (m * C + 256)
    assert _smem_bytes(m, C, 256, WIDE_KCAP) == 4 * (m * C + 512)
    assert _smem_bytes(m, C, 256) == 4 * m * C + WIDE_STATIC_SMEM + 16 * 256
    assert _smem_bytes(m, C, 257, WIDE_KCAP) == _smem_bytes(m, C, 257)
    assert _smem_bytes(m, C, WIDE_SMEM_K + 1) < _smem_bytes(m, C, WIDE_SMEM_K)
    assert all(_smem_bytes(m, C, k, w) <= MAX_SMEM for k in (1, 128, 256, 4096)
               for w in (adc_max_k, WIDE_KCAP))


def _fused_case(seed, P, Q, d, n_leaves, integer, tombstone_frac=0.2):
    pts, plf, qrs, qlf = _tile_case(seed, P, Q, d, n_leaves, integer, sort=True)
    rng = np.random.default_rng(seed + 1)
    pid = rng.permutation(10 * P)[:P].astype(np.int32)
    pid[rng.random(P) < tombstone_frac] = -1  # tombstoned rows
    return pts, plf, pid, qrs, qlf


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize(
    "P,Q,d,k,n_leaves",
    [(256, 96, 16, 5, 6), (150, 40, 8, 10, 3), (40, 30, 8, 20, 4)],
)
def test_fused_plain_matches_jax_ref(P, Q, d, k, n_leaves, integer):
    # the last case has k larger than the live rows of most leaves
    pts, plf, pid, qrs, qlf = _fused_case(P, P, Q, d, n_leaves, integer)
    jd, ji = j_fused_ref(jnp.asarray(pts), jnp.asarray(plf), jnp.asarray(pid),
                         jnp.asarray(qrs), jnp.asarray(qlf), k)
    td, ti = fused_topk(*_t(pts, plf, pid, qrs, qlf), k=k)
    _assert_table(jd, ji, td, ti, exact=integer)
    assert (ti.numpy() == -1).any()


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("k", [65, 100, 128, 256])
def test_fused_plain_matches_jax_ref_at_wide_k(k, integer):
    pts, plf, pid, qrs, qlf = _fused_case(k + 1, 700, 60, 16, 2, integer)
    jd, ji = j_fused_ref(jnp.asarray(pts), jnp.asarray(plf), jnp.asarray(pid),
                         jnp.asarray(qrs), jnp.asarray(qlf), k)
    td, ti = fused_topk(*_t(pts, plf, pid, qrs, qlf), k=k)
    _assert_table(jd, ji, td, ti, exact=integer)
    assert (ti.numpy() == -1).any()  # tombstones kept in the lists


@pytest.mark.parametrize("P,Q,d,k", [(256, 128, 16, 5), (300, 90, 8, 12)])
def test_fused_plain_matches_pallas_interpret(P, Q, d, k):
    pts, plf, pid, qrs, qlf = _fused_case(3, P, Q, d, 5, integer=True)
    jd, ji = j_fused_topk(jnp.asarray(pts), jnp.asarray(plf), jnp.asarray(pid),
                          jnp.asarray(qrs), jnp.asarray(qlf), k=k,
                          impl="pallas", tile_p=128, tile_q=128)
    td, ti = fused_topk(*_t(pts, plf, pid, qrs, qlf), k=k)
    _assert_table(jd, ji, td, ti, exact=True)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n,c,d", [(128, 64, 16), (200, 70, 8), (64, 256, 128),
                                   (33, 5, 4)])
def test_l2nn_plain_matches_jax_ref(n, c, d, integer):
    rng = np.random.default_rng(n * c)
    x = _vecs(rng, n, d, integer)
    cen = _vecs(rng, c, d, integer)
    if integer:
        cen[c // 2:] = cen[: c - c // 2]  # duplicate centroids: tie order
    ji, jd = j_l2nn_ref(jnp.asarray(x), jnp.asarray(cen))
    ti, td = l2_nearest(*_t(x, cen))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    if integer:
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    else:
        np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n,c,d", [(128, 64, 16), (200, 70, 8)])
def test_l2nn_plain_matches_pallas_interpret(n, c, d):
    rng = np.random.default_rng(c)
    x = _vecs(rng, n, d, True)
    cen = _vecs(rng, c, d, True)
    ji, jd = j_l2_nearest(jnp.asarray(x), jnp.asarray(cen), impl="pallas",
                          tile_n=64, tile_c=32)
    ti, td = l2_nearest(*_t(x, cen))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=TOL, atol=TOL)


def test_refs_are_the_wrappers_cpu_path():
    pts, plf, qrs, qlf = _tile_case(1, 50, 20, 8, 2)
    a = l2_topk(*_t(pts, plf, qrs, qlf), k=4)
    b = l2_topk_ref(*_t(pts, plf, qrs, qlf), k=4)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    pid = np.arange(50, dtype=np.int32)
    a = fused_topk(*_t(pts, plf, pid, qrs, qlf), k=4)
    b = fused_topk_ref(*_t(pts, plf, pid, qrs, qlf), k=4)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    a = l2_nearest(*_t(qrs, pts))
    b = l2_nearest_ref(*_t(qrs, pts))
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_cpu_path_launches_no_kernel():
    before = (l2_topk.launches, fused_topk.launches, l2_nearest.launches)
    pts, plf, qrs, qlf = _tile_case(2, 40, 10, 8, 2)
    l2_topk(*_t(pts, plf, qrs, qlf), k=3)
    fused_topk(*_t(pts, plf, np.arange(40, dtype=np.int32), qrs, qlf), k=3)
    l2_nearest(*_t(qrs, pts))
    assert (l2_topk.launches, fused_topk.launches, l2_nearest.launches) == before


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10 stored significand bits (to nearest)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _real_case(kernel, device="cpu", big=False):
    """SIFT-range real-valued inputs (integers in [0, 255] moved by uniform
    noise in [-0.5, 0.5)) for one kernel, as tensors on ``device``."""
    rng = np.random.default_rng(11)
    if kernel == "l2nn":
        n, c = (70000, 256) if big else (512, 64)
        x, cen = (_vecs(rng, m, 128, True) + rng.random((m, 128), np.float32) - 0.5
                  for m in (n, c))
        return _t(x, cen, device=device)
    P, Q = (20000, 3000) if big else (512, 128)
    pts, plf, qrs, qlf = _tile_case(5, P, Q, 128, 8, sort=True)
    pts = pts + rng.random(pts.shape, np.float32) - 0.5
    qrs = qrs + rng.random(qrs.shape, np.float32) - 0.5
    return _t(pts, plf, qrs, qlf, device=device)


def _bound_ratio(kernel, args, run, run_args=None):
    """Largest error / fp32 bound of ``run`` (the kernel's function) on
    ``run_args`` (default ``args``) against the float64 oracle on ``args``."""
    ra = args if run_args is None else run_args
    if kernel == "l2nn":
        idx, dist = run(*ra)
        return fp32_bound.nearest_error_ratio(idx, dist, *args)
    pts, plf, qrs, qlf = args
    exact, _, tol = fp32_bound.topk_f64(pts, plf, qrs, qlf, 20,
                                        chunk_rows=pts.shape[0] // 3 + 1)
    if kernel == "l2topk":
        dists, rows = run(*ra, 20)
    else:  # shard rows as ids, so the result names rows
        rows_as_ids = torch.arange(pts.shape[0], dtype=torch.int32,
                                   device=pts.device)
        dists, rows = run(ra[0], ra[1], rows_as_ids, ra[2], ra[3], 20)
    return fp32_bound.topk_error_ratio(dists, rows, pts, qrs, exact, tol)


_PLAIN = {"l2topk": l2_topk_ref, "fusedscan": fused_topk_ref, "l2nn": l2_nearest_ref}
_KERNEL = {"l2topk": lambda *a: l2_topk(*a[:-1], k=a[-1]),
           "fusedscan": lambda *a: fused_topk(*a[:-1], k=a[-1]),
           "l2nn": l2_nearest}


def test_fp32_oracle_chunks_fold_like_one_pass():
    pts, plf, qrs, qlf = _real_case("l2topk")
    one = fp32_bound.topk_f64(pts, plf, qrs, qlf, 20)
    chunked = fp32_bound.topk_f64(pts, plf, qrs, qlf, 20, chunk_rows=100)
    for a, b in zip(one, chunked):
        assert torch.equal(a, b)
    # and its selection is the plain version's, in (distance, row) order
    _, rows = l2_topk_ref(pts, plf, qrs, qlf, 20)
    assert torch.equal(one[1], rows.long())


@pytest.mark.parametrize("kernel", ["l2topk", "fusedscan", "l2nn"])
def test_plain_versions_hold_the_fp32_bound(kernel):
    ratio = _bound_ratio(kernel, _real_case(kernel), _PLAIN[kernel])
    assert 0.0 < ratio <= 1.0


@pytest.mark.parametrize("kernel", ["l2topk", "fusedscan", "l2nn"])
def test_fp32_bound_catches_tf32_rounding(kernel):
    # the plain version on inputs rounded as TF32 rounds them: the bound
    # must fail, or it would not catch a kernel that computed in TF32
    args = _real_case(kernel)
    rounded = [_tf32(a) if a.is_floating_point() else a for a in args]
    assert _bound_ratio(kernel, args, _PLAIN[kernel], rounded) > 1.0


@pytest.mark.parametrize("kind,k", [("sentinel_tail", 20), ("padded_lookup", 20),
                                    ("long_run", 64), ("sentinel_wave", 20)])
def test_l2topk_plain_matches_jax_ref_on_waves(kind, k):
    # wave-shaped tiles (the K1 kernel's contract: sorted points, lookup
    # rows in any order, sentinels on both sides), bit for bit
    pts, plf, qrs, qlf = _wave_case(kind, seed=3)
    jd, ji = j_l2topk_ref(jnp.asarray(pts), jnp.asarray(plf), jnp.asarray(qrs),
                          jnp.asarray(qlf), k)
    td, ti = l2_topk(*_t(pts, plf, qrs, qlf), k=k)
    _assert_table(jd, ji, td, ti, exact=True)
    found = np.isfinite(td.numpy()[:, 0])
    if kind == "sentinel_wave":
        assert not found.any()
    else:
        assert found.any() and not found.all()


@pytest.mark.parametrize("dup", ["halves", "neighbours"])
def test_l2nn_plain_matches_jax_ref_at_build_wave(dup):
    # build_index's wave shape (4,096 rows x 256 centroids, d = 128) with
    # duplicate centroids, so that ties fall across the kernel's two
    # centroid halves or between neighbouring centroids
    rng = np.random.default_rng(17)
    x = rng.integers(0, 256, size=(4096, 128)).astype(np.float32)
    cen = rng.integers(0, 256, size=(256, 128)).astype(np.float32)
    if dup == "halves":
        cen[128:] = cen[:128]
    else:
        cen[1::2] = cen[::2]
    x[:256] = cen  # rows on a centroid: every one of them is a tie
    ji, jd = j_l2nn_ref(jnp.asarray(x), jnp.asarray(cen))
    ti, td = l2_nearest(*_t(x, cen))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    first = ti.numpy()[:256]  # each row's first equal centroid
    assert (first < 128).all() if dup == "halves" else (first % 2 == 0).all()


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (on the card only)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize(
    "P,Q,d,k,n_leaves",
    [(4096, 1024, 128, 20, 16), (1000, 77, 32, 64, 3), (70, 130, 8, 1, 2),
     (517, 300, 200, 33, 7), (64, 64, 128, 20, 1),
     (300, 50, 13, 10, 3)],  # d % 4 != 0: 4-byte copies
)
def test_cuda_l2topk_matches_plain(cuda, P, Q, d, k, n_leaves, integer):
    # leaf-sorted points (as every wave is), lookup rows in random order
    args = _tile_case(P * 3 + Q, P, Q, d, n_leaves, integer, sort_points=True)
    rd, ri = l2_topk_ref(*_t(*args, device=cuda), k=k)
    n0 = l2_topk.launches
    kd, ki = l2_topk(*_t(*args, device=cuda), k=k)
    torch.cuda.synchronize()
    assert l2_topk.launches == n0 + 1
    _assert_table(rd.cpu(), ri.cpu(), kd.cpu(), ki.cpu(), exact=integer,
                  id_frac=1.0 if integer else 0.999)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,k", [("one_run", 64), ("sentinel_wave", 20),
                                    ("padded_lookup", 20), ("long_run", 64),
                                    ("sentinel_tail", 20)])
def test_cuda_l2topk_wave_shapes(cuda, kind, k):
    # one run filling the wave (every matching lookup row scans all 4,096
    # rows), a wave of routing padding, padded lookup rows
    args = _t(*_wave_case(kind, seed=5), device=cuda)
    rd, ri = l2_topk_ref(*args, k=k)
    kd, ki = l2_topk(*args, k=k)
    torch.cuda.synchronize()
    assert torch.equal(rd, kd) and torch.equal(ri, ki)


@pytest.mark.cuda
def test_cuda_l2topk_grid_is_resident(cuda):
    # K1's grid is as many clusters of 4 blocks (one an SM) as the card
    # holds at once: never more than a quarter of its SMs
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert 1 <= resident_clusters() <= sms // 4


@pytest.mark.cuda
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize(
    "P,Q,d,k,n_leaves",
    [(20000, 3000, 128, 20, 300), (1000, 77, 32, 64, 3), (70, 130, 8, 1, 2),
     (517, 300, 200, 33, 7)],
)
def test_cuda_fused_matches_plain(cuda, P, Q, d, k, n_leaves, integer):
    args = _fused_case(P + Q, P, Q, d, n_leaves, integer)
    rd, ri = fused_topk_ref(*_t(*args, device=cuda), k=k)
    n0 = fused_topk.launches
    kd, ki = fused_topk(*_t(*args, device=cuda), k=k)
    torch.cuda.synchronize()
    assert fused_topk.launches == n0 + 1
    _assert_table(rd.cpu(), ri.cpu(), kd.cpu(), ki.cpu(), exact=integer,
                  id_frac=1.0 if integer else 0.999)


@pytest.mark.cuda
def test_cuda_fused_rejects_unsorted_points(cuda):
    # the kernel binary-searches leaf runs; an index whose leaves do not
    # ascend is refused where it enters the port, before any search
    pts, plf, pid, _, _ = _fused_case(5, 100, 20, 8, 4, True)
    with pytest.raises(ValueError, match="sorted"):
        interop.index_from_numpy(
            vecs=pts, ids=pid, leaves=plf[::-1].copy(),
            offsets=np.zeros((1, 5), np.int32), n_valid=np.array([100]),
            overflow=np.int32(0), n_leaves=4, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n,c,d", [(70000, 256, 128), (200, 70, 8),
                                   (64, 1000, 200), (1, 1, 3),
                                   (70000, 256, 16)])  # PQ encode's shape
def test_cuda_l2nn_matches_plain(cuda, n, c, d, integer):
    rng = np.random.default_rng(n + c)
    x = _vecs(rng, n, d, integer)
    cen = _vecs(rng, c, d, integer)
    cen[c // 2:] = cen[: c - c // 2]
    ri, rdist = l2_nearest_ref(*_t(x, cen, device=cuda))
    n0 = l2_nearest.launches
    ki, kdist = l2_nearest(*_t(x, cen, device=cuda))
    torch.cuda.synchronize()
    assert l2_nearest.launches == n0 + 1
    if integer:
        assert torch.equal(ri, ki) and torch.equal(rdist, kdist)
    else:
        # ids may differ only where two centroids are within rounding
        same = (ri == ki).float().mean().item()
        assert same > 0.999
        torch.testing.assert_close(rdist, kdist, rtol=TOL, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dup", ["halves", "neighbours"])
def test_cuda_l2nn_build_wave_ties(cuda, dup):
    # build_index's wave shape; duplicate centroids put exact ties across
    # the kernel's two centroid halves (128 each) or between neighbours
    rng = np.random.default_rng(19)
    x = rng.integers(0, 256, size=(4096, 128)).astype(np.float32)
    cen = rng.integers(0, 256, size=(256, 128)).astype(np.float32)
    if dup == "halves":
        cen[128:] = cen[:128]
    else:
        cen[1::2] = cen[::2]
    x[:256] = cen
    ri, rdist = l2_nearest_ref(*_t(x, cen, device=cuda))
    ki, kdist = l2_nearest(*_t(x, cen, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(ri, ki) and torch.equal(rdist, kdist)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["l2topk", "fusedscan", "l2nn"])
def test_cuda_kernels_hold_the_fp32_bound(cuda, kernel):
    # real-valued data: the kernel stays within the fp32 bound of the
    # float64 oracle, and the plain version computed in TF32 does not
    args = _real_case(kernel, device=cuda, big=True)
    assert _bound_ratio(kernel, args, _KERNEL[kernel]) <= 1.0
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        assert _bound_ratio(kernel, args, _PLAIN[kernel]) > 1.0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


# ---------------------------------------------------------------------------
# every k the plan accepts (ROADMAP P7): past 64 the wide kernel, on the card
# ---------------------------------------------------------------------------

_WIDE_DENSE = [(4096, 128, 65, 3), (4096, 128, 128, 3), (4096, 128, 256, 3),
               (4096, 128, 1000, 3), (300, 13, 100, 2),  # d % 4 != 0
               (9000, 16, 5000, 1)]  # past 4096: the lists in device memory


@pytest.mark.cuda
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("P,d,k,n_leaves", _WIDE_DENSE)
def test_cuda_wide_l2topk_matches_plain(cuda, P, d, k, n_leaves, integer):
    args = _t(*_tile_case(P + k, P, 300, d, n_leaves, integer, sort_points=True),
              device=cuda)
    rd, ri = l2_topk_ref(*args, k=k)
    r = l2topk_ops.route(k)
    n0, w0 = l2_topk.launches, l2_topk.route_launches[r]
    kd, ki = l2_topk(*args, k=k)
    torch.cuda.synchronize()
    assert r != "lists"
    assert (l2_topk.launches, l2_topk.route_launches[r]) == (n0 + 1, w0 + 1)
    _assert_table(rd.cpu(), ri.cpu(), kd.cpu(), ki.cpu(), exact=integer,
                  id_frac=1.0 if integer else 0.999)


@pytest.mark.cuda
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("P,d,k,n_leaves", _WIDE_DENSE)
def test_cuda_wide_fused_matches_plain(cuda, P, d, k, n_leaves, integer):
    # real-valued rows sum in another order than the plain version's
    # matmul, so near-tied rows may swap places; without tombstones a swap
    # moves no -1 (test_cuda_l2topk_and_fused_agree_at_every_k holds the
    # real-valued tombstoned call bit for bit against the sweep kernel)
    args = _t(*_fused_case(P + k, P, 300, d, n_leaves, integer,
                           tombstone_frac=0.2 if integer else 0.0), device=cuda)
    rd, ri = fused_topk_ref(*args, k=k)
    r = l2topk_ops.route(k)
    n0, w0 = fused_topk.launches, fused_topk.route_launches[r]
    kd, ki = fused_topk(*args, k=k)
    torch.cuda.synchronize()
    assert r != "lists"
    assert (fused_topk.launches, fused_topk.route_launches[r]) == (n0 + 1, w0 + 1)
    _assert_table(rd.cpu(), ri.cpu(), kd.cpu(), ki.cpu(), exact=integer,
                  id_frac=1.0 if integer else 0.999)


@pytest.mark.cuda
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("k", [20, 64, 65, 100, 128, 256, 257, 1000])
def test_cuda_l2topk_and_fused_agree_at_every_k(cuda, k, integer):
    # the fused scan's ids are the sweep kernel's rows through the ids, bit
    # for bit (one order of fp32 operations), on the KCAP kernels and the
    # wide ones alike, with tombstones
    pts, plf, pid, qrs, qlf = _fused_case(k, 4096, 500, 128, 3, integer)
    args = _t(pts, plf, qrs, qlf, device=cuda)
    ids = torch.as_tensor(pid, device=cuda)
    kd, ki = l2_topk(*args, k=k)
    fd, fi = fused_topk(args[0], args[1], ids, args[2], args[3], k=k)
    torch.cuda.synchronize()
    mapped = torch.where(ki >= 0, ids[ki.clamp(min=0).long()], -1)
    assert torch.equal(fi, mapped)
    assert torch.equal(fd, torch.where(mapped >= 0, kd, torch.inf))


def _k2_case(seed, d=128, shuffle=False):
    """A shard and lookup that take every branch of the K2 kernel: a group
    of 40 lookup rows (more than a 16-row group tile), runs longer than the
    cluster split's threshold (4,096 rows; one of 4,097), a lookup leaf the
    shard does not hold (inside its leaf range) and one past it, padded
    lookup rows, tombstones in every run, duplicated rows (exact ties).
    ``shuffle``: the lookup rows in random order (groups fall apart)."""
    rng = np.random.default_rng(seed)
    runs = {0: 6000, 2: 500, 4: 37, 5: 1, 7: 3000, 9: 4097}
    plf = np.repeat(list(runs), list(runs.values())).astype(np.int32)
    P = plf.size
    pts = rng.integers(0, 256, size=(P, d)).astype(np.float32)
    pts[6100:6150] = pts[6000:6050]
    pid = rng.permutation(10 * P)[:P].astype(np.int32)
    pid[(rng.random(P) < 0.1) & (plf != 5)] = -1  # leaf 5's one row lives
    per_leaf = {0: 20, 2: 40, 3: 5, 4: 3, 5: 2, 7: 1, 9: 17, 11: 4}
    qlf = np.repeat(list(per_leaf), list(per_leaf.values())).astype(np.int32)
    qlf = np.concatenate([qlf, np.full(6, PAD_QUERY_LEAF, np.int32)])
    if shuffle:
        qlf = rng.permutation(qlf)
    qrs = rng.integers(0, 256, size=(qlf.size, d)).astype(np.float32)
    return pts, plf, pid, qrs, qlf


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 20, 64, 100])
@pytest.mark.parametrize("d,shuffle", [(128, False), (128, True), (13, False)])
def test_cuda_fused_group_tiles(cuda, d, shuffle, k):
    args = _t(*_k2_case(k + d, d, shuffle), device=cuda)
    rd, ri = fused_topk_ref(*args, k=k)
    kd, ki = fused_topk(*args, k=k)
    torch.cuda.synchronize()
    assert torch.equal(kd, rd) and torch.equal(ki, ri)
    qlf = args[4]
    none = (qlf == 3) | (qlf == 11) | (qlf == PAD_QUERY_LEAF)
    assert torch.isinf(kd[none]).all() and (ki[none] == -1).all()
    # a kept tombstone is emitted as -1 / inf, wherever it ranks
    assert (ki[~none] >= 0).any(1).float().mean() > 0.9


@pytest.mark.cuda
def test_cuda_fused_refuses_k_past_the_shard(cuda):
    args = _t(*_fused_case(4, 100, 20, 8, 4, True), device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        fused_topk(*args, k=101)
    with pytest.raises(ValueError, match="unsupported"):
        l2_topk(args[0], args[1], args[3], args[4], k=101)


# the list-capacity edges of the routes and the main path's k = 100, on a
# wave with a 1,500-row run (longer than a K1 cluster's 1,024 rows a round)
# and a 4,192-row one, lookup leaves on, next to and outside the wave's;
# 8,192 rows, so that k reaches past the shared-memory lists and to P
_EDGE_K = [64, 65, 100, 128, 129, 256, 257, 4096, 4097, 8192]


def _edge_wave(seed):
    return _wave_case("long_run", seed=seed, P=8192, Q=300, d=32)


@pytest.mark.cuda
@pytest.mark.parametrize("k", _EDGE_K)
def test_cuda_wide_routes_match_plain_on_a_wave(cuda, k):
    args = _t(*_edge_wave(k), device=cuda)
    rd, ri = l2_topk_ref(*args, k=k)
    r = l2topk_ops.route(k)
    n0, w0 = l2_topk.launches, l2_topk.route_launches[r]
    kd, ki = l2_topk(*args, k=k)
    torch.cuda.synchronize()
    assert (l2_topk.launches, l2_topk.route_launches[r]) == (n0 + 1, w0 + 1)
    assert torch.equal(kd, rd) and torch.equal(ki, ri)
    assert torch.isfinite(kd[:, min(k, 1500) - 1]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 65, 100, 256, 257, 4097])
def test_cuda_wide_routes_on_a_query_tile(cuda, k):
    # a query tile's slab read in place from a nonzero start: the rows
    # 1,000 .. 1,000 + 6,000 of the wave, reported from the slab's start
    pts, plf, qrs, qlf = _t(*_edge_wave(3), device=cuda)
    start, rows = 1000, 6000
    rd, ri = l2_topk_ref(pts[start:start + rows], plf[start:start + rows], qrs,
                         qlf, k=k)
    kd, ki = l2_topk(pts, plf, qrs, qlf, k=k,
                     p_start=torch.tensor([start], device=cuda), p_rows=rows)
    torch.cuda.synchronize()
    assert torch.equal(kd, rd) and torch.equal(ki, ri)


@pytest.mark.cuda
@pytest.mark.parametrize("k", _EDGE_K)
def test_cuda_wide_routes_match_plain_fused(cuda, k):
    # the whole-shard call with tombstones (kept rows with id < 0 leave as
    # -1 / inf), a 40-row leaf group (five group tiles) and runs past the
    # cluster split (4,096 rows)
    args = _t(*_k2_case(k, 32), device=cuda)
    k = min(k, args[0].shape[0])
    rd, ri = fused_topk_ref(*args, k=k)
    r = l2topk_ops.route(k)
    n0, w0 = fused_topk.launches, fused_topk.route_launches[r]
    kd, ki = fused_topk(*args, k=k)
    torch.cuda.synchronize()
    assert (fused_topk.launches, fused_topk.route_launches[r]) == (n0 + 1, w0 + 1)
    assert torch.equal(kd, rd) and torch.equal(ki, ri)
