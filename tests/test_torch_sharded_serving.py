"""repro_torch's ShardedSearchSession on the CPU: at 1-3 shards (every
shard on the one device, in turn) it answers bit-identically to the
unsharded session -- dense layouts at probes 1 and 2, and the codes tier
-- and to the reference's sharded session over the same directory; a
refresh after a delete drops the deleted rows and the cache's stale slabs;
a persisted shard plan comes back with ``Index.open``; and a session's pin
keeps serving after compaction and ``gc`` removed its segments' files
(the JAX package's ``tests/test_dynamicity.py`` read-during-write cases)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.core.tree import build_tree as j_build_tree
from repro.index import Index as JIndex
from repro.serving.sharded import ShardedSearchSession as JSharded
from repro_torch import build_tree, interop
from repro_torch.data import synth
from repro_torch.index import Index, ShardPlan
from repro_torch.serving import (
    MicroBatcher,
    SearchSession,
    ShardedSearchSession,
    TraceLoadGenerator,
)

DIM = 16
N = 2000
BOUNDS = (0, 500, 1000, 1700, N)
K = 5


def _mesh():
    return Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    x, _ = synth.sample_descriptors(N, DIM, seed=0, n_centers=40)
    jt = j_build_tree(jnp.asarray(x), (8, 4), key=jax.random.PRNGKey(1))
    d = str(tmp_path_factory.mktemp("sharded") / "ref")
    ji = JIndex.create(jt, d, mesh=_mesh())
    for lo, hi in zip(BOUNDS, BOUNDS[1:]):
        ji.append(x[lo:hi])
    ji.commit()
    ji.delete(np.arange(0, N, 41))
    ji.commit()
    ji.enable_codes(m=4, bits=4)
    ji.commit()
    tt = interop.tree_from_numpy([np.asarray(lvl) for lvl in jt.levels],
                                 device="cpu")
    q = x[:48] + np.random.default_rng(2).integers(
        -3, 4, size=(48, DIM)).astype(np.float32)
    return x, ji, d, tt, q


@pytest.fixture(scope="module")
def index(corpus):
    return Index.open(corpus[2], device="cpu")


def _grow(corpus, bounds=BOUNDS, directory=None):
    x, _, _, tt, _ = corpus
    idx = Index.create(tt, directory, device="cpu")
    for lo, hi in zip(bounds, bounds[1:]):
        idx.append(x[lo:hi])
    idx.commit()
    return idx


@pytest.mark.parametrize("layout,probes", [("point_major", 1),
                                           ("point_major", 2),
                                           ("query_routed", 2),
                                           ("scan_codes", 1)])
def test_sharded_equals_unsharded(corpus, index, layout, probes):
    q = corpus[4]
    kw = dict(k=K, layout=layout, probes=probes, buckets=(16, 48),
              cost_model="heuristic")
    ref = SearchSession(index, **kw)
    ref.warmup()
    for n_shards in (1, 2, 3):
        s = ShardedSearchSession(index, shards=n_shards, **kw)
        s.warmup()
        assert s.n_shards == n_shards
        for n in (15, 48):
            ids, dists = s.search(q[:n])
            r_ids, r_dists = ref.search(q[:n])
            np.testing.assert_array_equal(ids, r_ids)
            np.testing.assert_array_equal(dists, r_dists)
        assert s.steady_state_recompiles() == 0


@pytest.mark.parametrize("layout", ["point_major", "scan_codes"])
def test_sharded_equals_the_reference_sharded_session(corpus, index, layout):
    _, ji, _, _, q = corpus
    kw = dict(shards=2, k=K, layout=layout, probes=2, buckets=(48,),
              cost_model="heuristic")
    js, ts = JSharded(ji, **kw), ShardedSearchSession(index, **kw)
    js.warmup()
    ts.warmup()
    assert ts.per_shard_stats() == js.per_shard_stats()
    j_ids, j_d = js.search(q)
    t_ids, t_d = ts.search(q)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_array_equal(t_d, j_d)


def test_sharded_refresh_after_delete_drops_rows_and_stale_slabs(corpus):
    idx = _grow(corpus, (0, 1000, N))
    s = ShardedSearchSession(idx, shards=2, k=3, buckets=(32,),
                             cache_leaves=idx.n_leaves, cache_admit_after=1)
    s.warmup()
    q = corpus[4][:8]
    first = s.search(q)  # admit + memoise (the pre-scatter cache)
    hit = s.cache.try_serve(q, 3)
    assert hit is not None
    np.testing.assert_array_equal(hit[0], first[0])
    np.testing.assert_array_equal(hit[1], first[1])
    victim = int(hit[0][0, 0])
    idx.delete([victim])
    assert s.maybe_refresh() is True
    assert s.cache.try_serve(q, 3) is None  # stale slabs dropped
    ids, dists = s.search(q)
    assert victim not in ids
    r = idx.search(q, k=3, layout="point_major")
    np.testing.assert_array_equal(ids, r.ids.numpy())
    np.testing.assert_array_equal(dists, r.dists.numpy())
    assert s.steady_state_recompiles() == 0
    assert s.maybe_refresh() is False


def test_sharded_micro_batcher(corpus):
    idx = _grow(corpus, (0, 1000, N))
    s = ShardedSearchSession(idx, shards=2, k=5, buckets=(64, 128))
    s.warmup()
    gen = TraceLoadGenerator(corpus[0], 20, seed=3)
    reqs = gen.from_trace(30, N // 20, skew="zipf", rate=400.0)
    done = MicroBatcher(s, max_wait_ms=4.0, max_queue=1024).run(reqs)
    assert s.metrics.requests == 30 and s.steady_state_recompiles() == 0
    plain = SearchSession(idx, k=5, buckets=(64, 128))
    for c in done[:5]:
        ids, dists = plain.search(gen.query_image(c.image_id))
        np.testing.assert_array_equal(c.ids, ids)
        np.testing.assert_array_equal(c.dists, dists)


def test_session_from_persisted_shard_plan(corpus, tmp_path):
    d = str(tmp_path / "idx")
    idx = _grow(corpus, (0, 1000, N), directory=d)
    idx.set_shard_plan(ShardPlan.for_index(idx, 2, "balanced"))
    idx.commit()
    s = ShardedSearchSession(Index.open(d, device="cpu"), k=3, buckets=(32,))
    assert s.n_shards == 2 and s.shard_plan.strategy == "balanced"
    with pytest.raises(ValueError, match="needs shards"):
        ShardedSearchSession(_grow(corpus, (0, 1000)), k=3, buckets=(32,))


# ---------------------------------------------------------------------------
# read-during-write: the pin
# ---------------------------------------------------------------------------

B = 64
SEARCH_KW = dict(layout="point_major", probes=2, cost_model="heuristic")
_rng = np.random.default_rng(23)
VECS = _rng.standard_normal((1200, DIM)).astype(np.float32)
QUERIES = (VECS[:B] + 0.01 * _rng.standard_normal((B, DIM))).astype(np.float32)


def _make_index(d: str) -> Index:
    tree = build_tree(VECS[:512], (8, 4),
                      generator=torch.Generator().manual_seed(0), device="cpu")
    idx = Index.create(tree, d, device="cpu")
    idx.append(VECS[:300], ids=np.arange(300))
    idx.commit()
    idx.append(VECS[300:600], ids=np.arange(300, 600))
    idx.commit()
    return idx


def _facade(idx: Index):
    r = idx.search(QUERIES, k=K, **SEARCH_KW)
    return r.ids.numpy().copy(), r.dists.numpy().copy()


@pytest.mark.parametrize("shards", [1, 2])
def test_session_pin_survives_compaction_and_gc(tmp_path, shards):
    idx = _make_index(str(tmp_path / "idx"))
    kw = dict(buckets=(B,), k=K, **SEARCH_KW)
    session = (SearchSession(idx, **kw) if shards == 1
               else ShardedSearchSession(idx, shards=shards, **kw))
    session.warmup()
    v0 = session.pinned_version
    expected = _facade(idx)
    old_names = {s.name for s in idx.segments}
    idx.append(VECS[600:700], ids=np.arange(600, 700))
    idx.commit()
    idx.delete(np.arange(0, 120))
    idx.commit()
    while True:
        v = idx.version
        idx.compact(incremental=True)
        if idx.version == v:
            break
    idx.gc()
    assert not old_names & {s.name for s in idx.segments}
    # the pin holds: the pinned version's answer, whatever landed
    ids, dists = session.search(QUERIES)
    assert session.pinned_version == v0
    np.testing.assert_array_equal(ids, expected[0])
    np.testing.assert_array_equal(dists, expected[1])
    assert session.maybe_refresh() is True
    ids, dists = session.search(QUERIES)
    post = _facade(idx)
    np.testing.assert_array_equal(ids, post[0])
    np.testing.assert_array_equal(dists, post[1])
    assert session.steady_state_recompiles() == 0
    assert session.maybe_refresh() is False
