"""repro_torch batch search against the JAX package's ``impl="xla"``
point-major and query-routed executors (its Pallas and fused executors do
not run inside ``shard_map`` on jax 0.9, so the xla sweep is the
reference).

Ids exact, distances bit for bit on integer-valued queries and within
1e-6 * ||q||^2 on real-valued ones (the reference's 2e-4 contract, held
far tighter), ``pairs`` and ``q_cap_overflow`` equal, at probes 1-3,
including a starved ``q_cap``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.core import index_build as jib
from repro.core import search as jsearch
from repro.core.engine import tilescan as jts
from repro.core.tree import build_tree as j_build_tree
from repro_torch import batch_search, build_index, interop
from repro_torch.core import lookup as tlookup
from repro_torch.core.engine import tilescan as tts
from repro_torch.core.engine.executors import _leaf_pair_count, pad_lookup
from repro_torch.data import synth
from repro_torch.distributed.meshutil import DeviceMesh

# the engine packages export a function named plan, so fetch the modules
jplan = importlib.import_module("repro.core.engine.plan")
tplan = importlib.import_module("repro_torch.core.engine.plan")
K = 5


def _mesh():
    return Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def world():
    x, _ = synth.sample_descriptors(2048, 32, seed=0, n_centers=40)
    jt = j_build_tree(jnp.asarray(x), (8, 8), key=jax.random.PRNGKey(1))
    ji = jib.build_index(jnp.asarray(x), jt, _mesh(), wire_dtype=jnp.float32)
    tt = interop.tree_from_numpy([np.asarray(lvl) for lvl in jt.levels],
                                 device="cpu")
    ti = interop.index_from_numpy(
        **{f: np.asarray(getattr(ji, f)) for f in
           ("vecs", "ids", "leaves", "offsets", "n_valid", "overflow")},
        n_leaves=ji.n_leaves, device="cpu")
    # integer-valued queries near corpus rows: every distance is exact in
    # fp32, so the two packages must agree bit for bit
    q = x[::9][:150] + np.random.default_rng(1).integers(
        -3, 4, size=(150, 32)).astype(np.float32)
    return x, q, jt, ji, tt, ti


_REF = {}


def _reference(world, probes, q_cap, block_rows=None, k=K):
    key = (probes, q_cap, block_rows, k)
    if key not in _REF:
        _, q, jt, ji, _, _ = world
        _REF[key] = jsearch.batch_search(
            ji, jt, jnp.asarray(q), k=k, mesh=_mesh(), probes=probes,
            q_cap=q_cap, block_rows=block_rows, impl="xla")
    return _REF[key]


def _assert_same(jr, tr, row_atol=None):
    """Equal results; ``row_atol`` (one bound per query row) for
    real-valued queries, whose distance sums run in another order in the
    two packages."""
    np.testing.assert_array_equal(np.asarray(jr.ids), tr.ids.numpy())
    jd, td = np.asarray(jr.dists), tr.dists.numpy()
    np.testing.assert_array_equal(np.isfinite(jd), np.isfinite(td))
    fin = np.isfinite(jd)
    if row_atol is not None:
        err = np.abs(jd - td)[fin]
        bound = np.broadcast_to(np.asarray(row_atol)[:, None], jd.shape)[fin]
        assert (err <= bound).all(), f"max error / bound {(err / bound).max()}"
    else:
        np.testing.assert_array_equal(jd, td)
    assert float(jr.pairs) == float(tr.pairs)
    assert int(jr.q_cap_overflow) == int(tr.q_cap_overflow)
    assert tr.pairs.dtype == torch.float32
    assert tr.q_cap_overflow.dtype == torch.int32


@pytest.mark.parametrize("impl", ["xla", "pallas", "fused"])
@pytest.mark.parametrize("probes", [1, 2, 3])
def test_batch_search_matches_reference(world, probes, impl):
    _, q, _, _, tt, ti = world
    jr = _reference(world, probes, 256)
    tr = batch_search(ti, tt, q, K, probes=probes, q_cap=256, impl=impl,
                      device="cpu")
    assert int(tr.q_cap_overflow) == 0
    _assert_same(jr, tr)


@pytest.mark.parametrize("impl", ["xla", "pallas", "fused"])
@pytest.mark.parametrize("probes", [1, 2])
def test_batch_search_matches_reference_at_wide_k(world, probes, impl):
    # k = 100, past the dense kernels' list capacity (64): the reference
    # serves any k <= block_rows (ROADMAP P7)
    _, q, _, _, tt, ti = world
    jr = _reference(world, probes, 256, k=100)
    tr = batch_search(ti, tt, q, 100, probes=probes, q_cap=256, impl=impl,
                      device="cpu")
    assert tr.ids.shape == (q.shape[0], 100)
    _assert_same(jr, tr)


@pytest.mark.parametrize("probes", [1, 2, 3])
@pytest.mark.parametrize("block_rows", [256, 1024])
def test_starved_q_cap_counts_the_same_overflow(world, probes, block_rows):
    _, q, _, _, tt, ti = world
    jr = _reference(world, probes, 8, block_rows)
    tr = batch_search(ti, tt, q, K, probes=probes, q_cap=8,
                      block_rows=block_rows, device="cpu")
    assert int(tr.q_cap_overflow) > 0
    _assert_same(jr, tr)


@pytest.mark.parametrize("probes", [1, 2])
def test_fused_equals_wave_sweep(world, probes):
    _, q, _, _, tt, ti = world
    a = batch_search(ti, tt, q, K, probes=probes, q_cap=256, impl="xla",
                     device="cpu")
    b = batch_search(ti, tt, q, K, probes=probes, q_cap=256, impl="fused",
                     device="cpu")
    assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
    assert torch.equal(a.pairs, b.pairs)


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_real_valued_queries_within_tolerance(world, impl):
    # the returned distance is ||q||^2 + (||p||^2 - 2 p.q): a difference of
    # terms of size ||q||^2, so fp32 rounding is a few ulp of that scale;
    # the bound is about 8 ulp, far below the distances themselves
    x, _, jt, ji, tt, ti = world
    q = x[::9][:150] + np.random.default_rng(1).standard_normal(
        (150, 32)).astype(np.float32)
    jr = jsearch.batch_search(ji, jt, jnp.asarray(q), k=K, mesh=_mesh(),
                              probes=2, q_cap=256, impl="xla")
    tr = batch_search(ti, tt, q, K, probes=2, q_cap=256, impl=impl, device="cpu")
    _assert_same(jr, tr, row_atol=1e-6 * (q.astype(np.float64) ** 2).sum(1))


def test_port_built_index_searches_like_reference(world):
    x, q, jt, _, tt, _ = world
    ti = build_index(x, tt, wire_dtype=torch.float32, device="cpu")
    jr = _reference(world, 2, 256)
    tr = batch_search(ti, tt, q, K, probes=2, q_cap=256, device="cpu")
    _assert_same(jr, tr)


def test_index_from_numpy_rejects_unsorted_leaves(world):
    # the search kernels binary-search each leaf's run of the shard
    ji = world[3]
    arrays = {f: np.asarray(getattr(ji, f)) for f in
              ("vecs", "ids", "leaves", "offsets", "n_valid", "overflow")}
    arrays["leaves"] = arrays["leaves"][::-1].copy()
    with pytest.raises(ValueError, match="sorted"):
        interop.index_from_numpy(**arrays, n_leaves=ji.n_leaves, device="cpu")


def test_self_query_finds_itself(world):
    x, _, _, _, tt, ti = world
    tr = batch_search(ti, tt, x[:64], 3, q_cap=256, impl="fused", device="cpu")
    np.testing.assert_array_equal(tr.ids[:, 0].numpy(), np.arange(64))
    assert (tr.dists[:, 0] == 0).all()


@pytest.mark.parametrize(
    "kw",
    [dict(rows=4096, n_leaves=64, n_queries=150, n_shards=1, k=5),
     dict(rows=4096, n_leaves=64, n_queries=150, n_shards=1, k=5, probes=3),
     dict(rows=2**25, n_leaves=65536, n_queries=2**15, n_shards=1, k=20,
          block_rows=4096, q_cap=1024),
     dict(rows=1000, n_leaves=10, n_queries=7, n_shards=1, k=2, block_rows=300)],
)
def test_plan_budgets_match_reference(kw):
    jp = jplan.plan(layout="point_major", **kw)
    tp = tplan.plan(**kw)
    assert (tp.block_rows, tp.q_cap, tp.k, tp.probes) == (
        jp.block_rows, jp.q_cap, jp.k, jp.probes)


@pytest.mark.parametrize("n,cap", [(1, 1), (12, 5), (4096, 1024), (97, 50),
                                   (2**25, 4096)])
def test_largest_divisor_leq(n, cap):
    assert tplan.largest_divisor_leq(n, cap) == jplan.largest_divisor_leq(n, cap)


@pytest.mark.parametrize("layout,impl", [("auto", "xla"), ("query_routed", "xla"),
                                         ("scan_codes", "auto"),
                                         ("point_major", "auto")])
def test_unported_plans_raise(layout, impl):
    # these plans raised NotImplementedError until the query-routed layout
    # and the cost model were ported; now each resolves to the reference's
    # plan, and the one combination the reference refuses still raises
    kw = dict(rows=64, n_leaves=4, n_queries=4, n_shards=1, k=1,
              layout=layout, impl=impl, code_m=2, code_bits=2)
    jp, tp = jplan.plan(**kw), tplan.plan(**kw)
    fields = ("layout", "impl", "block_rows", "q_cap", "q_tile", "p_cap",
              "rerank")
    assert [getattr(tp, f) for f in fields] == [getattr(jp, f) for f in fields]
    with pytest.raises(ValueError, match="fused"):
        tplan.plan(**dict(kw, layout="query_routed", impl="fused"))


_QR_REF = {}


def _qr_reference(world, probes, k):
    if (probes, k) not in _QR_REF:
        _, q, jt, ji, _, _ = world
        _QR_REF[probes, k] = jsearch.batch_search(
            ji, jt, jnp.asarray(q), k=k, mesh=_mesh(), layout="query_routed",
            probes=probes, impl="xla")
    return _QR_REF[probes, k]


@pytest.mark.parametrize("k", [K, 100])
@pytest.mark.parametrize("probes", [1, 2])
def test_query_routed_matches_reference_and_point_major(world, probes, k):
    # k = 100 runs K1's wide kernel on the card; every lookup row is
    # answered by one query tile's point slab
    _, q, _, _, tt, ti = world
    jr = _qr_reference(world, probes, k)
    tr = batch_search(ti, tt, q, k, layout="query_routed", probes=probes,
                      device="cpu")
    assert int(tr.q_cap_overflow) == 0
    _assert_same(jr, tr)
    pm = batch_search(ti, tt, q, k, probes=probes, q_cap=256, device="cpu")
    assert torch.equal(pm.ids, tr.ids) and torch.equal(pm.dists, tr.dists)
    assert torch.equal(pm.pairs, tr.pairs)


@pytest.mark.parametrize("p_cap", [64, 256])
def test_query_routed_starved_slab_counts_the_same_overflow(world, p_cap):
    _, q, jt, ji, tt, ti = world
    jr = jsearch.batch_search(ji, jt, jnp.asarray(q), k=K, mesh=_mesh(),
                              layout="query_routed", probes=2, p_cap=p_cap,
                              impl="xla")
    tr = batch_search(ti, tt, q, K, layout="query_routed", probes=2,
                      p_cap=p_cap, device="cpu")
    assert int(tr.q_cap_overflow) > 0
    _assert_same(jr, tr)


def test_query_routed_accounting_equals_per_tile_sums(world):
    _, q, _, _, tt, ti = world
    from repro_torch.core import route as troute
    from repro_torch.core.engine.executors import routed_accounting

    lk = tlookup.build_lookup(tt, torch.as_tensor(q), probes=2)
    (routed,) = troute.route_by_leaf(
        [lk.vecs], [lk.qids], [lk.leaves], n_shards=1,
        leaves_per_shard=tt.n_leaves, capacity=512,
        mesh=DeviceMesh((torch.device("cpu"),)))
    _, _, qlf, _, _ = troute.cluster_sort(routed, leaf_base=0,
                                          leaves_per_shard=tt.n_leaves)
    q_tile, p_cap, offsets = 32, 96, ti.offsets[0]
    starts = tts.leaf_slab(offsets, qlf[::q_tile], n_entries=tt.n_leaves,
                           total_rows=ti.rows, cap=p_cap).start
    pairs, overflow = routed_accounting(offsets, qlf, starts, q_tile=q_tile,
                                        p_cap=p_cap, n_entries=tt.n_leaves)
    want_p = want_o = 0
    for w, s in enumerate(starts.tolist()):
        t = qlf[w * q_tile:(w + 1) * q_tile]
        want_p += int(tts.count_pairs(ti.leaves[s:s + p_cap], t))
        want_o += int(tts.slab_overflow(offsets, tts.last_valid_leaf(t),
                                        tts.Slab(torch.tensor(s), p_cap),
                                        n_entries=tt.n_leaves))
    assert (int(pairs), int(overflow)) == (want_p, want_o)
    assert want_o > 0 and want_p > 0


@pytest.mark.parametrize("k", [3, 100])
def test_l2topk_slab_start_equals_the_copying_form(world, k):
    # a point slab read in place from its device-side start gives what the
    # wrapper gives on the slab's copy, rows counted from the slab's start
    from repro_torch.kernels.l2topk.ops import l2_topk

    _, q, _, _, _, ti = world
    qv = torch.as_tensor(q[:40])
    ql = ti.leaves[torch.arange(0, 40 * 37, 37)]
    for s in (0, 700, ti.rows - 300):
        start = torch.tensor([s], dtype=torch.int64)
        a = l2_topk(ti.vecs, ti.leaves, qv, ql, k=k, p_start=start, p_rows=300)
        b = l2_topk(ti.vecs[s:s + 300].clone(), ti.leaves[s:s + 300].clone(),
                    qv, ql, k=k)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="p_start"):
        l2_topk(ti.vecs, ti.leaves, qv, ql, k=k, p_start=torch.tensor(0),
                p_rows=300)


def test_plan_rejects_unknown_values():
    with pytest.raises(ValueError):
        tplan.plan(rows=64, n_leaves=4, n_queries=4, n_shards=1, k=1, impl="x")
    with pytest.raises(ValueError):
        tplan.plan(rows=64, n_leaves=4, n_queries=4, n_shards=1, k=1, probes=5)


def test_sweep_accounting_equals_per_wave_sums(world):
    _, q, _, _, tt, ti = world
    lk = pad_lookup(tlookup.build_lookup(tt, torch.as_tensor(q), probes=2), 320)
    block_rows, q_cap, n_leaves = 256, 32, tt.n_leaves
    starts = tts.leaf_slab(lk.offsets, ti.leaves[::block_rows],
                           n_entries=n_leaves, total_rows=320, cap=q_cap).start
    pairs, overflow = tts.sweep_accounting(
        ti.leaves, starts, lk.offsets, block_rows=block_rows, q_cap=q_cap,
        n_leaves=n_leaves)
    want_p = want_o = 0
    for i, s in enumerate(starts.tolist()):
        plf = ti.leaves[i * block_rows:(i + 1) * block_rows]
        qlf = lk.leaves[s:s + q_cap]
        want_p += int(tts.count_pairs(plf, qlf))
        want_o += int(tts.slab_overflow(
            lk.offsets, tts.last_valid_leaf(plf), tts.Slab(torch.tensor(s), q_cap),
            n_entries=n_leaves))
        # and each wave's count equals the reference's
        jp = jts.count_pairs(jnp.asarray(plf.numpy()), jnp.asarray(qlf.numpy()))
        assert float(jp) == float(tts.count_pairs(plf, qlf))
    assert (int(pairs), int(overflow)) == (want_p, want_o)
    assert want_o > 0
    # the whole-shard histogram count bounds the slab-limited sweep
    assert int(_leaf_pair_count(ti.leaves, lk.leaves, n_leaves)) >= want_p


@pytest.mark.parametrize("first,total,cap", [(0, 100, 10), (63, 100, 10),
                                             (2**31 - 1, 100, 10), (5, 8, 10)])
def test_leaf_slab_clamps_like_dynamic_slice(first, total, cap):
    offsets = np.linspace(0, 100, 65).astype(np.int32)
    js = jts.leaf_slab(jnp.asarray(offsets), jnp.int32(first), n_entries=64,
                       total_rows=total, cap=cap)
    ts = tts.leaf_slab(torch.as_tensor(offsets), torch.tensor(first),
                       n_entries=64, total_rows=total, cap=cap)
    assert int(js.start) == int(ts.start)


def test_fold_and_probe_merge_match_reference():
    rng = np.random.default_rng(3)
    cur = np.sort(rng.integers(0, 5, (6, 4)).astype(np.float32), axis=1)
    cand = np.sort(rng.integers(0, 5, (6, 4)).astype(np.float32), axis=1)
    ci, ni = rng.permutation(48).reshape(2, 6, 4).astype(np.int32)
    jd, ji = jts.fold_topk(*map(jnp.asarray, (cur, ci, cand, ni)))
    td, ti = tts.fold_topk(*map(torch.as_tensor, (cur, ci, cand, ni)))
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    jd, ji = jts.merge_probe_groups(jnp.asarray(cur), jnp.asarray(ci), 3)
    td, ti = tts.merge_probe_groups(torch.as_tensor(cur), torch.as_tensor(ci), 3)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["pallas", "fused"])
@pytest.mark.parametrize("probes", [1, 2, 3])
def test_cuda_search_matches_cpu(world, cuda, probes, impl):
    # integer-valued data: the kernels' sums are exact, so the card's
    # results equal the plain versions' bit for bit
    x, q, _, _, tt, _ = world
    ref = batch_search(build_index(x, tt, device="cpu"), tt, q, K, probes=probes,
                       q_cap=256, impl=impl, device="cpu")
    tree_c = interop.tree_from_numpy([lvl.numpy() for lvl in tt.levels],
                                     device=cuda)
    from repro_torch.kernels.fusedscan.ops import fused_topk
    from repro_torch.kernels.l2topk.ops import l2_topk

    before = (l2_topk.launches, fused_topk.launches)
    got = batch_search(build_index(x, tree_c, device=cuda), tree_c, q, K,
                       probes=probes, q_cap=256, impl=impl, device=cuda)
    torch.cuda.synchronize()
    for f in ("ids", "dists", "pairs", "q_cap_overflow"):
        assert torch.equal(getattr(ref, f), getattr(got, f).cpu()), f
    launched = (l2_topk.launches - before[0], fused_topk.launches - before[1])
    assert launched[0 if impl == "pallas" else 1] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 20, 100])
@pytest.mark.parametrize("probes", [1, 2])
def test_cuda_query_routed_matches_cpu(world, cuda, probes, k):
    # the query tiles on K1 (k <= 64) and the wide kernel, each slab read
    # in place, bit-identical to the CPU and to the card's point-major
    x, q, _, _, tt, _ = world
    ref = batch_search(build_index(x, tt, device="cpu"), tt, q, k,
                       layout="query_routed", probes=probes, device="cpu")
    tree_c = interop.tree_from_numpy([lvl.numpy() for lvl in tt.levels],
                                     device=cuda)
    index_c = build_index(x, tree_c, device=cuda)
    from repro_torch.kernels.l2topk.ops import l2_topk

    before = l2_topk.launches
    got = batch_search(index_c, tree_c, q, k, layout="query_routed",
                       probes=probes, device=cuda)
    torch.cuda.synchronize()
    assert l2_topk.launches > before
    pm = batch_search(index_c, tree_c, q, k, probes=probes, q_cap=256,
                      impl="pallas", device=cuda)
    for f in ("ids", "dists", "pairs", "q_cap_overflow"):
        assert torch.equal(getattr(ref, f), getattr(got, f).cpu()), f
    assert torch.equal(pm.ids, got.ids) and torch.equal(pm.dists, got.dists)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 20, 100])
def test_cuda_l2topk_slab_start_equals_the_copying_form(world, cuda, k):
    from repro_torch.kernels.l2topk.ops import l2_topk
    from repro_torch.kernels.l2topk.ref import l2_topk_ref

    x, q, _, _, tt, _ = world
    ti = build_index(x, interop.tree_from_numpy(
        [lvl.numpy() for lvl in tt.levels], device=cuda), device=cuda)
    qv = torch.as_tensor(q[:40], device=cuda)
    ql = ti.leaves[torch.arange(0, 40 * 37, 37, device=cuda)].contiguous()
    for s in (0, 700, 2048):
        start = torch.tensor([s], dtype=torch.int64, device=cuda)
        a = l2_topk(ti.vecs, ti.leaves, qv, ql, k=k, p_start=start, p_rows=512)
        pv, pl = ti.vecs[s:s + 512].contiguous(), ti.leaves[s:s + 512].contiguous()
        b = l2_topk(pv, pl, qv, ql, k=k)
        c = l2_topk_ref(pv, pl, qv, ql, k)
        for x1, x2 in ((a, b), (a, c)):
            assert torch.equal(x1[0], x2[0]) and torch.equal(x1[1], x2[1])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [65, 128, 256, 1000])
@pytest.mark.parametrize("probes", [1, 2])
def test_cuda_sweep_and_fused_agree_at_wide_k(world, cuda, probes, k):
    # every k the plan accepts runs on the card (the wide kernels past 64),
    # the wave sweep and the fused scan bit-identical and equal to the CPU
    x, q, _, _, tt, _ = world
    ref = batch_search(build_index(x, tt, device="cpu"), tt, q, k,
                       probes=probes, q_cap=256, impl="fused", device="cpu")
    tree_c = interop.tree_from_numpy([lvl.numpy() for lvl in tt.levels],
                                     device=cuda)
    index_c = build_index(x, tree_c, device=cuda)
    a, b = (batch_search(index_c, tree_c, q, k, probes=probes, q_cap=256,
                         impl=impl, device=cuda) for impl in ("pallas", "fused"))
    torch.cuda.synchronize()
    for f in ("ids", "dists", "pairs"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert torch.equal(getattr(ref, f), getattr(a, f).cpu()), f


def test_make_executor_rejects_several_shards():
    from repro_torch.core.engine import make_executor

    # an executor of two shards runs a MeshIndex of two, and refuses a
    # one-shard index (tests/test_torch_sharded_build.py runs S > 1)
    p = tplan.plan(rows=64, n_leaves=4, n_queries=4, n_shards=2, k=1)
    fn = make_executor(p, n_leaves=4, shard_rows=32, q_total=p.q_cap, n_shards=2)
    one = interop.index_from_numpy(
        vecs=np.zeros((64, 2), np.float32), ids=np.arange(64),
        leaves=np.zeros(64), offsets=np.zeros((1, 5)), n_valid=[64],
        overflow=0, n_leaves=4, device="cpu")
    with pytest.raises(ValueError, match="executor for 2 x 32 rows"):
        fn(one, None)
