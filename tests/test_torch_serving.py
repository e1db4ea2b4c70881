"""repro_torch's serving layer against the JAX package's.

Both sides serve one index directory that the JAX package grew (three
appended segments, the third repeating rows of the first, so distance ties
cross segments; PQ codes for the compressed tier) on the CPU: the port
opens it with ``Index.open(..., device="cpu")``, the reference on an Auto
mesh (ROADMAP R1) at ``impl="xla"``. The data and the session queries are
integer-valued, so every fp32 distance is exact: ids and distances agree
bit for bit, at point_major, query_routed and scan_codes, probes 1 and 2.
The trace generator draws the reference's requests array for array, and
the calibration records land on the reference's signatures and shapes.

Then the port's own serving invariants: micro-batched equals direct and
``Index.search``, ``serve_many`` splits per request, no builds after
warmup (and the counter is not vacuous), the batcher's coalescing,
backpressure, deadline partials and oversize requests, the hot-leaf cache,
and load-or-build.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.core.engine import bucket_ladder as j_bucket_ladder
from repro.core.engine import snap_to_bucket as j_snap_to_bucket
from repro.core.tree import build_tree as j_build_tree
from repro.index import Index as JIndex
from repro.serving import SearchSession as JSession
from repro.serving import TraceLoadGenerator as JTraceGen
from repro.serving import default_tenant_mix as j_default_tenant_mix
from repro_torch import build_lookup
from repro_torch.core.engine import (
    bucket_ladder,
    observations,
    plan as make_plan,
    record_observation,
    reset_observations,
    snap_to_bucket,
)
from repro_torch.core.lookup import build_lookup_bucketed
from repro_torch.data import synth
from repro_torch.index import Index
from repro_torch.kernels.fusedscan.ops import fused_topk
from repro_torch.kernels.l2nn.ops import l2_nearest
from repro_torch.kernels.l2topk.ops import l2_topk
from repro_torch.serving import (
    HotLeafCache,
    MicroBatcher,
    SearchSession,
    TraceLoadGenerator,
    default_tenant_mix,
    persist,
)
from repro_torch.serving.session import load_or_build_index

DIM = 24
N = 3000
BOUNDS = (0, 1300, N)
DUP = 200  # the third segment repeats rows [0, DUP) under new ids
DPI = 8
K = 5
BUCKET = 64


def _mesh():
    return Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(rows, reference index, its directory, integer queries)."""
    x, _ = synth.sample_descriptors(N, DIM, seed=0, n_centers=50)
    jt = j_build_tree(jnp.asarray(x), (8, 8), key=jax.random.PRNGKey(1))
    d = str(tmp_path_factory.mktemp("serving") / "ref")
    ji = JIndex.create(jt, d, mesh=_mesh())
    for lo, hi in zip(BOUNDS, BOUNDS[1:]):
        ji.append(x[lo:hi])
    ji.append(x[:DUP])
    ji.commit()
    ji.enable_codes(m=4, bits=4)
    ji.commit()
    q = x[:BUCKET] + np.random.default_rng(2).integers(
        -3, 4, size=(BUCKET, DIM)).astype(np.float32)
    return x, ji, d, q


@pytest.fixture(scope="module")
def index(corpus):
    return Index.open(corpus[2], device="cpu")


@pytest.fixture(scope="module")
def dense_index(corpus):
    """The same directory's dense segments only (no codes): auto layouts
    stay dense."""
    x, _, _, _ = corpus
    tt = Index.open(corpus[2], device="cpu").tree
    idx = Index.create(tt, None, device="cpu")
    for lo, hi in zip(BOUNDS, BOUNDS[1:]):
        idx.append(x[lo:hi])
    idx.commit()
    return idx


# ---------------------------------------------------------------------------
# bucket ladder, snapping, the observation registry
# ---------------------------------------------------------------------------


def test_bucket_ladder_and_snap_equal_the_reference():
    for top in (1, 7, 32, 96, 100, 4096, 4097, 32768):
        for n_buckets in (1, 2, 3, 4, 6):
            for floor in (1, 8, 32):
                b = bucket_ladder(top, n_buckets=n_buckets, min_queries=floor)
                assert b == j_bucket_ladder(top, n_buckets=n_buckets,
                                            min_queries=floor)
                assert all(top % r == 0 for r in b) and b[-1] == top
                for n in (1, 2, b[0], b[0] + 1, top - 1, top, top + 5):
                    if n >= 1:
                        assert snap_to_bucket(n, b) == j_snap_to_bucket(n, b)
    with pytest.raises(ValueError):
        snap_to_bucket(0, (4,))
    with pytest.raises(ValueError):
        bucket_ladder(0)


def test_observation_registry():
    reset_observations()
    p = make_plan(rows=8192, n_leaves=64, n_queries=128, n_shards=1, k=5,
                  layout="point_major")
    p.observe(12.5)
    p.observe(7.5)
    record_observation(p, 10.0)
    (key, o), = observations().items()
    assert key.startswith("point_major/k=5/")
    assert o["count"] == 3 and o["last_ms"] == 10.0
    assert (o["min_ms"], o["max_ms"]) == (7.5, 12.5)
    assert o["mean_ms"] == pytest.approx(10.0)
    reset_observations()
    assert observations() == {}


# ---------------------------------------------------------------------------
# the bucketed lookup
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("probes", [1, 3])
def test_bucketed_lookup_equals_build_lookup(index, corpus, probes):
    q = torch.as_tensor(corpus[3][:32])
    lk = build_lookup(index.tree, q, probes=probes)
    blk, leaves = build_lookup_bucketed(index.tree, q, 32, probes=probes,
                                        q_total=32 * probes)
    assert leaves.shape == (32, probes)
    for f in ("vecs", "qids", "leaves", "offsets"):
        assert torch.equal(getattr(lk, f), getattr(blk, f)), f


def test_bucketed_lookup_masks_padding(index, corpus):
    """Rows past n_valid never reach a leaf; real rows keep build_lookup's
    order and CSR spans."""
    n_valid, bucket, probes = 20, 32, 2
    buf = torch.zeros((bucket, DIM))
    buf[:n_valid] = torch.as_tensor(corpus[3][:n_valid])
    blk, _ = build_lookup_bucketed(index.tree, buf, n_valid, probes=probes,
                                   q_total=bucket * probes + probes)
    lv, qids = blk.leaves.numpy(), blk.qids.numpy()
    real = lv >= 0
    assert real.sum() == n_valid * probes
    assert (qids[real] < n_valid * probes).all()
    off = blk.offsets.numpy()
    assert off[-1] - off[0] == n_valid * probes
    lk = build_lookup(index.tree, buf[:n_valid], probes=probes)
    np.testing.assert_array_equal(lk.qids.numpy(), qids[real])
    np.testing.assert_array_equal(lk.leaves.numpy(), lv[real])


# ---------------------------------------------------------------------------
# the session against the reference's
# ---------------------------------------------------------------------------

CROSS = [("point_major", 1), ("point_major", 2), ("query_routed", 1),
         ("query_routed", 2), ("scan_codes", 1), ("scan_codes", 2)]


@pytest.mark.parametrize("layout,probes", CROSS)
def test_session_equals_the_reference_session(corpus, index, layout, probes):
    _, ji, _, q = corpus
    kw = dict(k=K, layout=layout, probes=probes, buckets=(BUCKET,),
              cost_model="heuristic")
    js = JSession(ji, **kw)
    ts = SearchSession(index, **kw)
    js.warmup()
    ts.warmup()
    assert ts.serving_layout == js.serving_layout == layout
    for n in (BUCKET, 23):
        j_ids, j_d = js.search(q[:n])
        t_ids, t_d = ts.search(q[:n])
        np.testing.assert_array_equal(t_ids, j_ids)
        np.testing.assert_array_equal(t_d, j_d)
    assert ts.plan_summary() == [
        {key: v for key, v in row.items()} for row in js.plan_summary()]
    assert ts.steady_state_recompiles() == 0


def test_cross_segment_ties_keep_segment_order(corpus, index):
    """Queries ON duplicated rows: every exact match has a twin at the same
    distance in the third segment; the merge keeps the first segment's
    row first, as the reference's top_k does."""
    x, ji, _, _ = corpus
    q = x[:16].copy()
    kw = dict(k=K, layout="point_major", buckets=(16,),
              cost_model="heuristic")
    js, ts = JSession(ji, **kw), SearchSession(index, **kw)
    j_ids, j_d = js.search(q)
    t_ids, t_d = ts.search(q)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_array_equal(t_d, j_d)
    np.testing.assert_array_equal(t_ids[:, 0], np.arange(16))
    np.testing.assert_array_equal(t_ids[:, 1], N + np.arange(16))
    assert (t_d[:, 0] == 0).all() and (t_d[:, 1] == 0).all()


def test_calibration_records_land_on_the_reference_signatures(corpus):
    _, ji, d, q = corpus
    kw = dict(k=K, layout="point_major", buckets=(32, BUCKET),
              cost_model="heuristic")
    ji_fresh = JIndex.open(d, mesh=_mesh())
    ti = Index.open(d, device="cpu")
    js, ts = JSession(ji_fresh, **kw), SearchSession(ti, **kw)
    for s in (js, ts):
        s.search(q[:8], n_images=1)  # before warmup: not recorded
        s.warmup()
        s.search(q, n_images=8)
        s.search(q[:20], n_images=2)
    j_snap = ji_fresh.calibration.snapshot()
    t_snap = ti.calibration.snapshot()
    # one signature per (rung, segment size): the rung's per-segment plans
    assert sorted(t_snap) == sorted(j_snap) and len(t_snap) == 2 * 3
    for key, o in t_snap.items():
        assert o["count"] == j_snap[key]["count"]
        assert o["shapes"] == j_snap[key]["shapes"]
    assert ti.calibration.dirty


# ---------------------------------------------------------------------------
# the session's own invariants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout,impl", [("point_major", "xla"),
                                         ("point_major", "fused"),
                                         ("query_routed", "xla")])
def test_session_equals_index_search(dense_index, corpus, layout, impl):
    q = corpus[3]
    s = SearchSession(dense_index, k=K, layout=layout, probes=2, impl=impl,
                      buckets=(32, BUCKET))
    s.warmup()
    for n in (BUCKET, 17):
        ids, dists = s.search(q[:n])
        r = dense_index.search(q[:n], k=K, layout=layout, probes=2, impl=impl)
        np.testing.assert_array_equal(ids, r.ids.numpy())
        np.testing.assert_array_equal(dists, r.dists.numpy())
        assert int(r.q_cap_overflow) == 0


@pytest.fixture(scope="module")
def session(dense_index):
    s = SearchSession(dense_index, k=K, layout="point_major", probes=2,
                      buckets=(32, 96))
    s.warmup()
    return s


def test_legacy_pair_is_one_ephemeral_segment(dense_index, corpus):
    seg = dense_index.segments[0]
    s = SearchSession(seg.index, dense_index.tree, k=K, layout="point_major",
                      buckets=(32,))
    assert s.index.n_segments == 1 and s.index.directory is None
    one = Index.create(dense_index.tree, None, device="cpu")
    one.append_built(seg.index)
    one.commit()
    ids, dists = s.search(corpus[3][:20])
    r = one.search(corpus[3][:20], k=K, layout="point_major")
    np.testing.assert_array_equal(ids, r.ids.numpy())
    np.testing.assert_array_equal(dists, r.dists.numpy())
    with pytest.raises(TypeError, match="legacy"):
        SearchSession(seg.index)


def test_no_builds_after_warmup(session, corpus):
    q = corpus[3]
    segs = len(session._segments)
    warmed = session.recompiles()
    # one executor per segment, per rung (the CPU has no device allocator)
    assert warmed == len(session.buckets) * segs
    for n in (1, 32, 33, 64):
        session.search(q[:n])
    session.search(np.concatenate([q, q]))  # 128 rows: split
    assert session.recompiles() == warmed
    assert session.steady_state_recompiles() == 0


def test_build_counter_is_not_vacuous(dense_index, corpus):
    s = SearchSession(dense_index, k=K, layout="point_major",
                      buckets=(32, 64))
    segs = len(s._segments)
    s.warmup()
    s.search(corpus[3][:8])
    assert s.steady_state_recompiles() == 0
    # a refresh rebuilds every rung: until the next warmup those executors
    # are builds after warmup, and requests still answer the same
    before = s.search(corpus[3][:8])
    s.refresh()
    assert s.steady_state_recompiles() == 2 * segs
    after = s.search(corpus[3][:8])
    np.testing.assert_array_equal(before[0], after[0])
    assert s.steady_state_recompiles() == 2 * segs
    s.warmup()
    assert s.steady_state_recompiles() == 0


def test_microbatched_equals_direct(session, dense_index, corpus):
    gen = TraceLoadGenerator(corpus[0], DPI, seed=5)
    reqs = gen.from_trace(20, N // DPI, skew="zipf", rate=2000.0)
    done = MicroBatcher(session, max_wait_ms=2.0, max_queue=4096).run(reqs)
    assert session.metrics.engine_batches > 1
    by_rid = {c.rid: c for c in done}
    q = np.concatenate([r.queries for r in reqs])
    ids, dists = session.search(q)  # two dispatches of 96 + 64 rows
    ref = dense_index.search(q, k=K, layout="point_major", probes=2)
    np.testing.assert_array_equal(ids, ref.ids.numpy())
    np.testing.assert_allclose(dists, ref.dists.numpy(), rtol=0, atol=2e-4)
    for i, r in enumerate(reqs):
        rows = slice(i * DPI, (i + 1) * DPI)
        np.testing.assert_array_equal(by_rid[r.rid].ids, ids[rows])
        np.testing.assert_array_equal(by_rid[r.rid].dists, dists[rows])
    assert session.steady_state_recompiles() == 0


def test_serve_many_splits_per_request(session, corpus):
    q = corpus[3]
    parts = [q[:10], q[10:14], q[14:40]]
    outs = session.serve_many(parts)
    whole_i, whole_d = session.search(q[:40])
    off = 0
    for (ids, dists), part in zip(outs, parts):
        assert ids.shape == (len(part), K)
        np.testing.assert_array_equal(ids, whole_i[off:off + len(part)])
        np.testing.assert_array_equal(dists, whole_d[off:off + len(part)])
        off += len(part)


# ---------------------------------------------------------------------------
# traces: the reference's requests
# ---------------------------------------------------------------------------


def test_trace_generator_draws_the_reference_requests(corpus):
    x = corpus[0]
    tg, jg = TraceLoadGenerator(x, DPI, seed=5), JTraceGen(x, DPI, seed=5)
    for skew, rate in (("zipf", None), ("uniform", 50.0), ("zipf", 200.0)):
        a = tg.from_trace(60, N // DPI, skew=skew, rate=rate, seed=3)
        b = jg.from_trace(60, N // DPI, skew=skew, rate=rate, seed=3)
        assert [(r.rid, r.image_id, r.arrival) for r in a] == \
            [(r.rid, r.image_id, r.arrival) for r in b]
        for ra, rb in zip(a, b):
            np.testing.assert_array_equal(ra.queries, rb.queries)
    ta = tg.multi_tenant(default_tenant_mix(90, rate=100.0), N // DPI, seed=9)
    ja = jg.multi_tenant(j_default_tenant_mix(90, rate=100.0), N // DPI, seed=9)
    assert [(r.rid, r.image_id, r.arrival, r.priority) for r in ta] == \
        [(r.rid, r.image_id, r.arrival, r.priority) for r in ja]
    np.testing.assert_array_equal(tg.query_image(7), jg.query_image(7))
    np.testing.assert_array_equal(tg.query_image(7), tg.query_image(7))


# ---------------------------------------------------------------------------
# the micro-batcher
# ---------------------------------------------------------------------------


def _session(idx, **kw):
    s = SearchSession(idx, k=3, layout="point_major", **kw)
    s.warmup()
    return s


def test_batcher_coalesces_and_respects_backpressure(dense_index, corpus):
    gen = TraceLoadGenerator(corpus[0], DPI, seed=5)
    s = _session(dense_index, buckets=(64,))
    done = MicroBatcher(s, max_wait_ms=5.0, max_queue=4096).run(
        gen.requests(np.arange(12), np.zeros(12)))
    m = s.metrics
    assert m.requests == 12 and m.rejected == 0
    assert m.engine_batches == 2  # 8 + 4 requests of 8 rows, coalesced
    assert len(m.latency) == 12 and all(c.latency_ms >= 0 for c in done)
    s2 = _session(dense_index, buckets=(64,))
    done2 = MicroBatcher(s2, max_wait_ms=5.0, max_queue=5).run(
        gen.requests(np.arange(12), np.zeros(12)))
    rej = [c for c in done2 if c.source == "rejected"]
    assert len(rej) == 7 and s2.metrics.rejected == 7
    assert all(c.ids is None for c in rej) and s2.metrics.requests == 5


def test_batcher_serves_requests_larger_than_top_bucket(dense_index, corpus):
    s = _session(dense_index, buckets=(16,))
    gen = TraceLoadGenerator(corpus[0], 40, seed=5)  # 40 rows > 16
    done = MicroBatcher(s, max_wait_ms=1.0, max_queue=8).run(
        gen.requests(np.arange(2), np.zeros(2)))
    assert s.metrics.requests == 2 and s.metrics.rejected == 0
    assert all(c.source == "engine" and c.ids.shape == (40, 3) for c in done)
    assert s.steady_state_recompiles() == 0


def test_batcher_deadline_dispatches_partial_batches(dense_index, corpus):
    s = _session(dense_index, buckets=(64,))
    gen = TraceLoadGenerator(corpus[0], DPI, seed=5)
    done = MicroBatcher(s, max_wait_ms=1.0, max_queue=64).run(
        gen.requests(np.arange(4), np.arange(4) * 10.0))
    assert s.metrics.engine_batches == 4
    assert all(c.latency_ms < 5000 for c in done)


# ---------------------------------------------------------------------------
# the hot-leaf cache
# ---------------------------------------------------------------------------


def test_cache_hits_repeated_images_exactly(dense_index, corpus):
    s = SearchSession(dense_index, k=3, layout="point_major", probes=2,
                      buckets=(64,), cache_leaves=dense_index.n_leaves,
                      cache_admit_after=1)
    s.warmup()
    gen = TraceLoadGenerator(corpus[0], DPI, seed=5)
    image_ids = np.array([0, 1, 2, 3, 0, 1, 2, 3, 0])
    arrivals = np.array([0, 0, 0, 0, 1, 1, 1, 1, 2], np.float64)
    done = MicroBatcher(s, max_wait_ms=5.0, max_queue=64).run(
        gen.requests(image_ids, arrivals))
    assert s.metrics.requests == 9 and s.metrics.cache_images == 5
    assert s.cache.hit_rate > 0
    by_src = {(c.image_id, c.source): c for c in done}
    for img in range(4):
        hit = by_src.get((img, "cache"))
        if hit is not None:
            eng = by_src[(img, "engine")]
            np.testing.assert_array_equal(hit.ids, eng.ids)
            np.testing.assert_array_equal(hit.dists, eng.dists)


@pytest.mark.parametrize("probes", [1, 2])
def test_cache_hit_equals_the_engine_across_segments(index, corpus, probes):
    """Duplicated rows across segments tie exactly: a hit breaks the ties
    as the engine's merges do (segment, then probe, then row), and a
    tombstoned row never comes back from a slab."""
    x = corpus[0]
    gone = np.array([0, 1, 2, N + 3])  # rows of the first and third segments
    idx = Index.open(corpus[2], device="cpu")
    idx.delete(gone)
    s = SearchSession(idx, k=K, layout="point_major", probes=probes,
                      buckets=(64,), cache_leaves=idx.n_leaves,
                      cache_admit_after=1)
    s.warmup()
    q = np.concatenate([x[:DUP:25], corpus[3][:8]])  # exact duplicates too
    e_ids, e_d = s.search(q)
    hit = s.cache.try_serve(q, K)
    assert hit is not None and s.cache.hits == 1
    np.testing.assert_array_equal(hit[0], e_ids)
    np.testing.assert_array_equal(hit[1], e_d)
    assert not np.isin(hit[0], gone).any()
    r = idx.search(q, k=K, layout="point_major", probes=probes)
    np.testing.assert_array_equal(hit[0], r.ids.numpy())


def test_cache_stats_safe_before_attach_and_when_disabled():
    with pytest.raises(ValueError, match="eviction"):
        HotLeafCache(8, eviction="bogus")
    for cache in (HotLeafCache(0), HotLeafCache(8)):
        assert not cache.enabled and cache.hit_rate == 0.0
        st = cache.stats()
        assert st["resident_bytes"] == 0 and st["memo_entries"] == 0
        assert cache.try_serve(np.zeros((2, 4), np.float32), k=3) is None
        cache.record(np.zeros((2, 4), np.float32), np.zeros((2, 1), np.int64))
        assert cache.hits == cache.misses == 0


def _attached_cache(**kw):
    """A 3-leaf toy index: leaf 0 holds 90 rows, leaves 1 and 2 five each."""
    vecs = np.random.default_rng(0).normal(size=(100, 8)).astype(np.float32)
    view = SimpleNamespace(
        vecs=torch.as_tensor(vecs), ids=torch.arange(100, dtype=torch.int32),
        leaves=torch.tensor([0] * 90 + [1] * 5 + [2] * 5, dtype=torch.int32))
    cache = HotLeafCache(2, admit_after=1, **kw)
    cache.attach_index([view], n_leaves=3)
    return cache


def _route(cache, leaf, times):
    for i in range(times):
        cache.record(np.full((1, 8), float(leaf * 10 + i), np.float32),
                     np.array([[leaf]]))


def test_cache_ties_follow_the_engine_merge_order():
    """Equal distances in two probes' leaves of two segments: the engine
    merges per segment (probes inside), then across segments, so the
    earlier segment wins over the earlier probe; a masked row (id -1)
    degenerates to -1 / inf."""
    def view(vecs, ids, leaves):
        return SimpleNamespace(vecs=torch.tensor(vecs, dtype=torch.float32),
                               ids=torch.tensor(ids, dtype=torch.int32),
                               leaves=torch.tensor(leaves, dtype=torch.int32))

    cache = HotLeafCache(4, admit_after=1)
    cache.attach_index([view([[1, 0], [5, 5]], [10, -1], [1, 1]),
                        view([[0, 1]], [20], [0])], n_leaves=2)
    q = np.zeros((1, 2), np.float32)
    cache.record(q, np.array([[0, 1]]))  # probe 0: leaf 0, probe 1: leaf 1
    ids, dists = cache.try_serve(q, 3)
    np.testing.assert_array_equal(ids, [[10, 20, -1]])
    np.testing.assert_array_equal(dists, [[1.0, 1.0, np.inf]])


def test_cache_cost_eviction_drops_big_lukewarm_slab():
    cache = _attached_cache()
    _route(cache, 1, 3)
    _route(cache, 2, 3)
    _route(cache, 0, 1)
    assert cache.evictions == 1 and set(cache._slabs) == {1, 2}
    lru = _attached_cache(eviction="lru")
    _route(lru, 1, 3)
    _route(lru, 2, 3)
    _route(lru, 0, 1)
    assert 0 in lru._slabs and 1 not in lru._slabs
    ema = HotLeafCache(8)
    for v in (None, -2.0, 4.0, 8.0):
        ema.note_engine_cost(v)
    assert ema.cost_hint_ms == pytest.approx(5.0)


def test_cache_capacity_zero_copies_nothing(dense_index):
    s = SearchSession(dense_index, k=3, layout="point_major", buckets=(32,))
    assert s.cache._views is None and not s.cache.enabled


# ---------------------------------------------------------------------------
# load-or-build and the persist shims
# ---------------------------------------------------------------------------


def test_load_or_build_prefers_the_committed_index(tmp_path, dense_index):
    d = str(tmp_path / "idx")
    seg = dense_index.segments[0]
    calls = []

    def build_fn():
        calls.append(1)
        return seg.index, dense_index.tree, {"images": 375}

    s1, m1 = SearchSession.load_or_build(d, build_fn=build_fn, device="cpu",
                                         k=3, buckets=(32,))
    assert calls == [1] and m1["restored"] is False
    s2, m2 = SearchSession.load_or_build(d, build_fn=build_fn, device="cpu",
                                         k=3, buckets=(32,))
    assert calls == [1] and m2["restored"] is True and m2["images"] == 375
    assert m2["n_leaves"] == dense_index.n_leaves and m2["n_segments"] == 1
    _, m3 = load_or_build_index(d, build_fn=build_fn, device="cpu",
                                rebuild=True)
    assert calls == [1, 1] and m3["restored"] is False


def test_persist_shims_and_corpus_store(tmp_path, dense_index, corpus):
    d = str(tmp_path / "p")
    seg = dense_index.segments[0]
    with pytest.warns(DeprecationWarning):
        persist.save_index(d, seg.index, dense_index.tree, extra={"images": 9})
    assert persist.has_index(d)
    with pytest.warns(DeprecationWarning):
        r_index, r_tree, meta = persist.load_index(d, device="cpu")
    assert meta["images"] == 9 and meta["fanouts"] == [8, 8]
    for f in ("vecs", "ids", "leaves", "offsets"):
        assert torch.equal(getattr(r_index, f), getattr(seg.index, f))
    persist.save_corpus(d, corpus[0], block_rows=1024)
    rows = np.array([0, 1023, 1024, N - 1])
    np.testing.assert_array_equal(persist.load_corpus(d).read_rows(rows),
                                  corpus[0][rows])
    legacy = tmp_path / "legacy"
    (legacy / "index_ckpt").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="pre-segment"):
        Index.open(str(legacy), device="cpu")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layout,impl", [("point_major", "fused"),
                                         ("point_major", "xla"),
                                         ("query_routed", "xla")])
def test_cuda_session_equals_cpu_and_launches_kernels(corpus, cuda, tmp_path,
                                                      layout, impl):
    gpu = Index.open(corpus[2], device=cuda)
    cpu = Index.open(corpus[2], device="cpu")
    kw = dict(k=K, layout=layout, impl=impl, buckets=(32, BUCKET),
              cost_model="heuristic")
    gs, cs = SearchSession(gpu, **kw), SearchSession(cpu, **kw)
    gs.warmup()
    cs.warmup()
    wrappers = (l2_nearest, l2_topk, fused_topk)
    for w in wrappers:
        w.launches = 0
    for n in (BUCKET, 9):
        a, b = gs.search(corpus[3][:n]), cs.search(corpus[3][:n])
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    assert l2_nearest.launches == 2
    scan = fused_topk if impl == "fused" else l2_topk
    assert scan.launches >= (2 * len(gs._segments) if impl == "fused" else 2)
    assert gs.steady_state_recompiles() == 0


@pytest.mark.cuda
def test_cuda_cache_on_the_card(corpus, cuda):
    gpu = Index.open(corpus[2], device=cuda)
    s = SearchSession(gpu, k=3, layout="point_major", impl="fused",
                      buckets=(64,), cache_leaves=gpu.n_leaves,
                      cache_admit_after=1)
    s.warmup()
    q = corpus[3][:8]
    e_ids, e_d = s.search(q)
    l2_topk.launches = 0
    hit = s.cache.try_serve(q, 3)
    assert hit is not None and l2_topk.launches == 1
    assert all(t.is_cuda for slab in s.cache._slabs.values() for t in slab)
    np.testing.assert_array_equal(hit[0], e_ids)
    np.testing.assert_array_equal(hit[1], e_d)


@pytest.mark.cuda
def test_cuda_allocator_growth_counts_as_a_build(corpus, cuda):
    gpu = Index.open(corpus[2], device=cuda)
    # a rung whose buffers pass 1 MiB: they get device segments of their
    # own, which hold nothing once a dispatch ends
    s = SearchSession(gpu, k=K, layout="point_major", impl="fused",
                      buckets=(16384,))
    s.warmup()
    s.search(corpus[3][:9])
    assert s.steady_state_recompiles() == 0
    # the warmed rung's memory released to CUDA (cudaFree): the next
    # dispatch must allocate device segments anew
    torch.cuda.empty_cache()
    s.search(corpus[3][:9])
    assert s.steady_state_recompiles() > 0


def test_load_or_build_index_on_a_mesh(corpus, tmp_path):
    """``load_or_build_index(..., mesh=)``: a ``MeshIndex`` built on four
    CPU shards is committed as one four-shard segment, reopened on that
    mesh, and a session over it answers as one over the one-shard build;
    a directory of four shards does not open on one."""
    from repro_torch import build_index
    from repro_torch.distributed.meshutil import DeviceMesh

    x, _, _, q = corpus
    tree = Index.open(corpus[2], device="cpu").tree
    mesh = DeviceMesh((torch.device("cpu"),) * 4)
    vecs = torch.as_tensor(x)

    def build(m):
        return lambda: (build_index(vecs, tree, wire_dtype=torch.float32,
                                    device="cpu", mesh=m),
                        tree, {"images": N // DPI})

    one, meta = load_or_build_index(None, build_fn=build(None), device="cpu")
    assert meta == {"images": N // DPI, "restored": False}
    d = str(tmp_path / "mesh")
    four, meta = load_or_build_index(d, build_fn=build(mesh), mesh=mesh)
    assert not meta["restored"] and four.segments[0].index.mesh == mesh
    again, meta = load_or_build_index(d, build_fn=None, mesh=mesh)
    assert meta["restored"] and again.mesh == mesh and again.rows == N
    kw = dict(k=K, layout="point_major", buckets=(BUCKET,))
    a, b = SearchSession(one, **kw), SearchSession(again, **kw)
    for got, want in zip(b.search(q), a.search(q)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="shard"):
        load_or_build_index(d, build_fn=None, device="cpu")
