"""repro_torch ADC kernels: the plain versions of adcscan and the fused ADC
scan against the JAX package's ref.py and its Pallas kernels (interpret
mode), and on the card the CUDA kernels K4 and K5 against their plain
versions.

Inputs are made with numpy from a seed. ADC is gathers and fp32 adds in
the order j = 0..m-1, with no product, so every comparison with the plain
versions is bit for bit, on real-valued LUTs too (a real-valued LUT is
what would show a kernel that stored it in fewer bits). Integer-valued
LUTs make many rows tie on distance, so the (distance, row) tie order is
exercised. The Pallas adcscan kernel orders ties by table slot (ROADMAP
P2), so it is held by distance only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sentinels import PAD_TILE_POINT_LEAF
from repro.kernels.adcscan.ops import adc_topk as j_adc_topk
from repro.kernels.adcscan.ref import adc_topk_ref as j_adc_ref
from repro.kernels.fusedscan.ops import fused_adc_topk as j_fused_adc
from repro.kernels.fusedscan.ref import fused_adc_topk_ref as j_fused_adc_ref
from repro_torch.kernels.adcscan.ops import adc_topk
from repro_torch.kernels.adcscan.ref import adc_topk_ref
from repro_torch.kernels.fusedscan.ops import fused_adc_topk
from repro_torch.kernels.fusedscan.ref import fused_adc_topk_ref
from repro_torch.kernels.l2topk.ops import route


def _adc_case(seed, P, Q, m, C, n_leaves, *, integer, sort=False,
              tombstone_frac=0.0, disjoint=False):
    """(codes, point leaves, point ids, lut, query leaves) as numpy.

    ``integer``: LUT entries in [0, 8), so many rows tie on distance;
    otherwise SIFT-range real values. Duplicated code rows tie too.
    ``disjoint``: query leaves share no leaf with the points.
    """
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, C, size=(P, m)).astype(np.uint8)
    if P >= 4:
        codes[P // 2: P // 2 + P // 4] = codes[: P // 4]
    if integer:
        lut = rng.integers(0, 8, size=(Q, m, C)).astype(np.float32)
    else:
        lut = (rng.random((Q, m, C)) * 2000.0).astype(np.float32)
    plf = rng.integers(0, n_leaves, size=P).astype(np.int32)
    qlf = rng.integers(0, n_leaves, size=Q).astype(np.int32)
    if disjoint:
        qlf = qlf + n_leaves
    if sort:
        order = np.argsort(plf, kind="stable")
        codes, plf = codes[order], plf[order]
    pid = rng.permutation(10 * P)[:P].astype(np.int32)
    pid[rng.random(P) < tombstone_frac] = -1
    return codes, plf, pid, lut, qlf


def _t(*arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


def _assert_equal(jd, ji, td, ti):
    np.testing.assert_array_equal(np.asarray(ji), np.asarray(ti))
    np.testing.assert_array_equal(np.asarray(jd), np.asarray(td))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# plain versions against the JAX package (CPU)
# ---------------------------------------------------------------------------

_SHAPES = [(96, 40, 8, 16, 3, 5), (130, 70, 4, 256, 5, 20),
           (200, 33, 8, 256, 2, 128), (33, 17, 2, 4, 1, 1)]


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("P,Q,m,C,n_leaves,k", _SHAPES)
def test_adcscan_plain_matches_jax_ref(P, Q, m, C, n_leaves, k, integer):
    codes, plf, _, lut, qlf = _adc_case(P + Q, P, Q, m, C, n_leaves,
                                        integer=integer)
    jd, ji = j_adc_ref(jnp.asarray(codes), jnp.asarray(plf), jnp.asarray(lut),
                       jnp.asarray(qlf), k)
    td, ti = adc_topk(*_t(codes, plf, lut, qlf), k=k)
    _assert_equal(jd, ji, td, ti)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("P,Q,m,C,n_leaves,k", _SHAPES)
def test_fused_adc_plain_matches_jax_ref(P, Q, m, C, n_leaves, k, integer):
    # the reference's executor masks tombstones' leaves before its call;
    # the port's fused scan takes the sorted leaves and the ids
    codes, plf, pid, lut, qlf = _adc_case(P * 3, P, Q, m, C, n_leaves,
                                          integer=integer, sort=True,
                                          tombstone_frac=0.2)
    masked = np.where(pid >= 0, plf, PAD_TILE_POINT_LEAF).astype(np.int32)
    jd, ji = j_fused_adc_ref(jnp.asarray(codes), jnp.asarray(masked),
                             jnp.asarray(pid), jnp.asarray(lut),
                             jnp.asarray(qlf), k)
    td, ti = fused_adc_topk(*_t(codes, plf, pid, lut, qlf), k=k)
    _assert_equal(jd, ji, td, ti)
    assert (ti.numpy()[np.isfinite(td.numpy())] >= 0).all()


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("k", [129, 256, 512])
def test_adc_plain_versions_match_jax_refs_at_wide_k(k, integer):
    # rerank depths past the K4/K5 lists' capacity (128), as default_rerank
    # gives for k > 128 (ROADMAP P7)
    codes, plf, pid, lut, qlf = _adc_case(k, 1500, 40, 8, 16, 2,
                                          integer=integer, sort=True,
                                          tombstone_frac=0.2)
    jd, ji = j_adc_ref(jnp.asarray(codes), jnp.asarray(plf), jnp.asarray(lut),
                       jnp.asarray(qlf), k)
    _assert_equal(jd, ji, *adc_topk(*_t(codes, plf, lut, qlf), k=k))
    masked = np.where(pid >= 0, plf, PAD_TILE_POINT_LEAF).astype(np.int32)
    jd, ji = j_fused_adc_ref(jnp.asarray(codes), jnp.asarray(masked),
                             jnp.asarray(pid), jnp.asarray(lut),
                             jnp.asarray(qlf), k)
    td, ti = fused_adc_topk(*_t(codes, plf, pid, lut, qlf), k=k)
    _assert_equal(jd, ji, td, ti)
    assert np.isfinite(td.numpy()[:, k - 1]).any()


def test_adc_plain_versions_on_a_tile_with_no_same_leaf_pair():
    codes, plf, pid, lut, qlf = _adc_case(4, 64, 20, 8, 16, 3, integer=True,
                                          sort=True, disjoint=True)
    d, i = adc_topk(*_t(codes, plf, lut, qlf), k=10)
    assert torch.isinf(d).all() and (i == -1).all()
    d, i = fused_adc_topk(*_t(codes, plf, pid, lut, qlf), k=10)
    assert torch.isinf(d).all() and (i == -1).all()


@pytest.mark.parametrize("P,Q,m,C,k", [(256, 128, 8, 16, 6),
                                       (300, 90, 4, 256, 20)])
def test_adcscan_plain_matches_pallas_interpret(P, Q, m, C, k):
    # the Pallas kernel's unordered table orders ties by slot (ROADMAP P2):
    # held by distance (bit for bit) and by which slots are empty
    codes, plf, _, lut, qlf = _adc_case(9, P, Q, m, C, 4, integer=False)
    jd, _ = j_adc_topk(jnp.asarray(codes), jnp.asarray(plf), jnp.asarray(lut),
                       jnp.asarray(qlf), k=k, impl="pallas", tile_p=128,
                       tile_q=128)
    td, ti = adc_topk(*_t(codes, plf, lut, qlf), k=k)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    assert (ti.numpy()[~np.isfinite(np.asarray(jd))] == -1).all()


@pytest.mark.parametrize("integer", [True, False])
def test_fused_adc_plain_matches_pallas_interpret(integer):
    # the fused Pallas kernel keeps a sorted (distance, row) table: exact
    codes, plf, pid, lut, qlf = _adc_case(5, 256, 128, 8, 16, 5,
                                          integer=integer, sort=True,
                                          tombstone_frac=0.2)
    masked = np.where(pid >= 0, plf, PAD_TILE_POINT_LEAF).astype(np.int32)
    jd, ji = j_fused_adc(jnp.asarray(codes), jnp.asarray(masked),
                         jnp.asarray(pid), jnp.asarray(lut), jnp.asarray(qlf),
                         k=12, impl="pallas", tile_p=128, tile_q=128)
    td, ti = fused_adc_topk(*_t(codes, plf, pid, lut, qlf), k=12)
    _assert_equal(jd, ji, td, ti)


def test_adc_wrappers_cpu_path_is_the_plain_version_and_launches_nothing():
    codes, plf, pid, lut, qlf = _adc_case(2, 50, 20, 4, 8, 2, integer=True,
                                          sort=True, tombstone_frac=0.1)
    before = (adc_topk.launches, fused_adc_topk.launches)
    a = adc_topk(*_t(codes, plf, lut, qlf), k=4)
    b = adc_topk_ref(*_t(codes, plf, lut, qlf), k=4)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    a = fused_adc_topk(*_t(codes, plf, pid, lut, qlf), k=4)
    b = fused_adc_topk_ref(*_t(codes, plf, pid, lut, qlf), k=4)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert (adc_topk.launches, fused_adc_topk.launches) == before


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("P,Q,m,C,n_leaves,k", _SHAPES)
def test_adcscan_point_ids_mask_tombstones(P, Q, m, C, n_leaves, k, integer):
    # the wave sweep hands the sorted leaves with the ids; on the CPU the
    # wrapper masks the tombstones' leaves, as the reference's executor
    # does before its call
    codes, plf, pid, lut, qlf = _adc_case(P * 5 + Q, P, Q, m, C, n_leaves,
                                          integer=integer, sort=True,
                                          tombstone_frac=0.25)
    masked = np.where(pid >= 0, plf, PAD_TILE_POINT_LEAF).astype(np.int32)
    td, ti = adc_topk(*_t(codes, plf, lut, qlf), k=k,
                      point_ids=torch.as_tensor(pid))
    rd, ri = adc_topk_ref(*_t(codes, masked, lut, qlf), k=k)
    assert torch.equal(td, rd) and torch.equal(ti, ri)
    jd, ji = j_adc_ref(jnp.asarray(codes), jnp.asarray(masked),
                       jnp.asarray(lut), jnp.asarray(qlf), k)
    _assert_equal(jd, ji, td, ti)
    assert not (pid[ti.numpy()[ti.numpy() >= 0]] < 0).any()


@pytest.mark.parametrize("start", [0, 37, 100])
def test_adcscan_slab_reads_the_lookup_rows_it_is_given(start):
    # the wave sweep hands the whole LUT table and the slab start on the
    # device: the same as the call on the slab's rows
    codes, plf, _, lut, qlf = _adc_case(11, 120, 140, 8, 16, 4, integer=True)
    args = _t(codes, plf, lut, qlf)
    got = adc_topk(*args, k=9, q_start=torch.tensor([start]), q_rows=40)
    want = adc_topk(*_t(codes, plf, lut[start:start + 40],
                        qlf[start:start + 40]), k=9)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    with pytest.raises(ValueError, match="q_start"):
        adc_topk(*args, k=9, q_start=torch.tensor([start], dtype=torch.int32),
                 q_rows=40)
    with pytest.raises(ValueError, match="q_start"):
        adc_topk(*args, k=9, q_start=torch.tensor([start]))


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (on the card only)
# ---------------------------------------------------------------------------

_CUDA_SHAPES = [(4096, 1024, 8, 256, 40), (1000, 77, 8, 256, 3),
                (70, 130, 4, 16, 2), (517, 300, 16, 64, 7),
                (4096, 64, 8, 256, 1)]  # one leaf fills the wave


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 20, 128, 129, 512])
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("P,Q,m,C,n_leaves", _CUDA_SHAPES)
def test_cuda_adcscan_matches_plain(cuda, P, Q, m, C, n_leaves, integer, k):
    # the kernel binary-searches leaf runs: a wave's leaves are sorted
    k = min(k, P)
    codes, plf, _, lut, qlf = _adc_case(P + Q + k, P, Q, m, C, n_leaves,
                                        integer=integer, sort=True)
    args = _t(codes, plf, lut, qlf, device=cuda)
    rd, ri = adc_topk_ref(*args, k=k)
    n0 = adc_topk.launches
    kd, ki = adc_topk(*args, k=k)
    torch.cuda.synchronize()
    assert adc_topk.launches == n0 + 1
    assert torch.equal(kd, rd) and torch.equal(ki, ri)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 20, 128, 129, 512])
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("P,Q,m,C,n_leaves", _CUDA_SHAPES)
def test_cuda_fused_adc_matches_plain(cuda, P, Q, m, C, n_leaves, integer, k):
    # tombstones mid-shard keep their leaf, so the leaves stay sorted
    k = min(k, P)
    codes, plf, pid, lut, qlf = _adc_case(P * 7 + k, P, Q, m, C, n_leaves,
                                          integer=integer, sort=True,
                                          tombstone_frac=0.25)
    args = _t(codes, plf, pid, lut, qlf, device=cuda)
    rd, ri = fused_adc_topk_ref(*args, k=k)
    n0 = fused_adc_topk.launches
    kd, ki = fused_adc_topk(*args, k=k)
    torch.cuda.synchronize()
    assert fused_adc_topk.launches == n0 + 1
    assert torch.equal(kd, rd) and torch.equal(ki, ri)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 20, 128, 129, 512])
@pytest.mark.parametrize("start", [0, 1500, 1976])
def test_cuda_adcscan_slab_matches_plain(cuda, start, k):
    # the wave sweep's call: the whole LUT table, the slab start on the card
    codes, plf, _, lut, qlf = _adc_case(start + k, 4096, 3000, 8, 256, 40,
                                        integer=False, sort=True)
    args = _t(codes, plf, lut, qlf, device=cuda)
    q0 = torch.tensor([start], device=cuda)
    rd, ri = adc_topk_ref(*_t(codes, plf, lut[start:start + 1024],
                              qlf[start:start + 1024], device=cuda), k=k)
    n0 = adc_topk.launches
    kd, ki = adc_topk(*args, k=k, q_start=q0, q_rows=1024)
    torch.cuda.synchronize()
    assert adc_topk.launches == n0 + 1
    assert torch.equal(kd, rd) and torch.equal(ki, ri)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 20, 128, 129, 512])
@pytest.mark.parametrize("integer", [True, False])
def test_cuda_adcscan_wave_with_tombstones(cuda, integer, k):
    # a sorted wave with tombstones (which keep their leaf): K4 against the
    # plain version on the masked leaves, and against K5 on the same rows
    codes, plf, pid, lut, qlf = _adc_case(k + integer, 4096, 1024, 8, 256, 16,
                                          integer=integer, sort=True,
                                          tombstone_frac=0.1)
    masked = np.where(pid >= 0, plf, PAD_TILE_POINT_LEAF).astype(np.int32)
    args = _t(codes, plf, lut, qlf, device=cuda)
    ids = torch.as_tensor(pid, device=cuda)
    n0 = adc_topk.launches
    kd, ki = adc_topk(*args, k=k, point_ids=ids)
    torch.cuda.synchronize()
    assert adc_topk.launches == n0 + 1
    rd, ri = adc_topk_ref(*_t(codes, masked, lut, qlf, device=cuda), k=k)
    assert torch.equal(kd, rd) and torch.equal(ki, ri)
    fd, fi = fused_adc_topk(args[0], args[1], ids, args[2], args[3], k=k)
    assert torch.equal(fd, kd)
    assert torch.equal(fi, torch.where(ki >= 0, ids[ki.clamp(min=0).long()], -1))


@pytest.mark.cuda
def test_cuda_adc_kernels_on_a_tile_with_no_same_leaf_pair(cuda):
    codes, plf, pid, lut, qlf = _adc_case(8, 512, 64, 8, 256, 5, integer=True,
                                          sort=True, disjoint=True)
    d, i = adc_topk(*_t(codes, plf, lut, qlf, device=cuda), k=128)
    assert torch.isinf(d).all() and (i == -1).all()
    d, i = fused_adc_topk(*_t(codes, plf, pid, lut, qlf, device=cuda), k=128)
    assert torch.isinf(d).all() and (i == -1).all()


@pytest.mark.cuda
def test_cuda_adc_kernels_refuse_what_they_do_not_take(cuda):
    codes, plf, pid, lut, qlf = _adc_case(3, 256, 16, 8, 256, 4, integer=True,
                                          sort=True)
    args = _t(codes, plf, lut, qlf, device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        adc_topk(*args, k=257)  # past the wave's 256 rows
    with pytest.raises(ValueError, match="unsupported"):
        fused_adc_topk(args[0], args[1], torch.as_tensor(pid, device=cuda),
                       args[2], args[3], k=257)
    with pytest.raises(TypeError):
        adc_topk(args[0].int(), *args[1:], k=4)  # codes are read as uint8
    big = torch.zeros((16, 64, 1024), device=cuda)  # a 256 KiB LUT
    with pytest.raises(ValueError, match="shared memory"):
        fused_adc_topk(torch.zeros((256, 64), dtype=torch.uint8, device=cuda),
                       args[1], torch.as_tensor(pid, device=cuda), big,
                       args[3], k=4)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [20, 128, 129, 256, 257, 512])
def test_cuda_fused_adc_is_k4_over_the_whole_shard(cuda, k):
    # K5 is K4's kernel over the whole shard with the ids mapped at emit:
    # bit for bit K4's rows through the ids, with tombstones, at every k
    # (runs of about 3,300 rows, longer than a wave)
    codes, plf, pid, lut, qlf = _adc_case(k, 2**16, 1000, 8, 256, 20,
                                          integer=False, sort=True,
                                          tombstone_frac=0.1)
    args = _t(codes, plf, lut, qlf, device=cuda)
    ids = torch.as_tensor(pid, device=cuda)
    kd, ki = adc_topk(*args, k=k, point_ids=ids)
    fd, fi = fused_adc_topk(args[0], args[1], ids, args[2], args[3], k=k)
    torch.cuda.synchronize()
    assert torch.equal(fd, kd)
    assert torch.equal(fi, torch.where(ki >= 0, ids[ki.clamp(min=0).long()], -1))
    rd, ri = fused_adc_topk_ref(*_t(codes, plf, pid, lut, qlf, device=cuda), k=k)
    assert torch.equal(fd, rd) and torch.equal(fi, ri)
    assert torch.isfinite(fd[:, -1]).any() and (fi >= 0).all() == bool(
        torch.isfinite(fd).all())


# the list-capacity edges of the routes and the main path's rerank 256
_EDGE_K = [128, 129, 200, 256, 257, 4096, 4097, 8192]


def _edge_codes(seed):
    """8,192 leaf-sorted code rows (m 8, C 256) in runs of 5 to 3,000 rows
    (longer than a wave's), a fifth of them tombstoned, and 1,500 LUT rows
    whose leaves fall on the runs, between them and outside them."""
    rng = np.random.default_rng(seed)
    runs = [5, 3000, 40, 1800, 300, 2000, 1047]
    plf = np.repeat(10 + 2 * np.arange(len(runs)), runs).astype(np.int32)
    P, m, C, n_lut = plf.size, 8, 256, 1500
    codes = rng.integers(0, C, size=(P, m)).astype(np.uint8)
    codes[4000:4100] = codes[100:200]  # exact ties
    pid = rng.permutation(10 * P)[:P].astype(np.int32)
    pid[rng.random(P) < 0.2] = -1
    lut = rng.standard_normal((n_lut, m, C)).astype(np.float32)
    qlf = rng.choice(np.arange(5, 30), size=n_lut).astype(np.int32)
    return codes, plf, pid, lut, qlf


@pytest.mark.cuda
@pytest.mark.parametrize("k", _EDGE_K)
def test_cuda_adc_wide_routes_on_a_wave_slab(cuda, k):
    # K4 as the sweep calls it: a slab of lookup rows from a nonzero start,
    # the wave's ids skipping tombstones (they keep their leaf)
    codes, plf, pid, lut, qlf = _t(*_edge_codes(k), device=cuda)
    start, rows = 300, 1024
    masked = torch.where(pid >= 0, plf, PAD_TILE_POINT_LEAF)
    rd, ri = adc_topk_ref(codes, masked, lut[start:start + rows],
                          qlf[start:start + rows], k=k)
    r = route(k, 128, 128)  # K4: no wide range, past 128 the block list
    n0, w0 = adc_topk.launches, adc_topk.route_launches[r]
    kd, ki = adc_topk(codes, plf, lut, qlf, k=k, point_ids=pid,
                      q_start=torch.tensor([start], device=cuda), q_rows=rows)
    torch.cuda.synchronize()
    assert (adc_topk.launches, adc_topk.route_launches[r]) == (n0 + 1, w0 + 1)
    assert torch.equal(kd, rd) and torch.equal(ki, ri)


@pytest.mark.cuda
@pytest.mark.parametrize("k", _EDGE_K)
def test_cuda_fused_adc_wide_routes(cuda, k):
    args = _t(*_edge_codes(k + 1), device=cuda)
    rd, ri = fused_adc_topk_ref(*args, k=k)
    r = route(k, 128)
    n0, w0 = fused_adc_topk.launches, fused_adc_topk.route_launches[r]
    kd, ki = fused_adc_topk(*args, k=k)
    torch.cuda.synchronize()
    assert (fused_adc_topk.launches, fused_adc_topk.route_launches[r]) == (
        n0 + 1, w0 + 1)
    assert torch.equal(kd, rd) and torch.equal(ki, ri)
    assert torch.isfinite(kd[:, min(k, 2000) - 1]).any()
