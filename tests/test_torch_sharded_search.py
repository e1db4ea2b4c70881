"""repro_torch's ShardPlan and ShardedIndex: the plan's JSON is the JAX
package's, and scatter-gather search at 1-3 shards (every shard on the one
device, scanning in turn) is bit-identical to the unsharded
``Index.search`` -- ids, distances, pairs and overflow -- at both dense
layouts, probes 1 and 2, with tombstones, and on the codes tier; and to
the reference's ``ShardedIndex`` over the same segments."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from repro.core.tree import build_tree as j_build_tree
from repro.distributed.meshutil import shard_submeshes
from repro.index import Index as JIndex
from repro.index import ShardedIndex as JSharded
from repro.index import ShardPlan as JPlan
from repro_torch import interop
from repro_torch.data import synth
from repro_torch.index import Index, ShardedIndex, ShardPlan

DIM = 16
N = 2000
BOUNDS = (0, 500, 1000, 1700, N)
DEAD = np.arange(0, N, 41)


def _mesh():
    return Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def corpus():
    x, _ = synth.sample_descriptors(N, DIM, seed=0, n_centers=40)
    jt = j_build_tree(jnp.asarray(x), (8, 4), key=jax.random.PRNGKey(1))
    tt = interop.tree_from_numpy([np.asarray(lvl) for lvl in jt.levels],
                                 device="cpu")
    q = x[:48] + np.random.default_rng(2).integers(
        -3, 4, size=(48, DIM)).astype(np.float32)
    return x, jt, tt, q


def _grow(idx, x):
    for lo, hi in zip(BOUNDS, BOUNDS[1:]):
        idx.append(x[lo:hi])
    idx.commit()
    idx.delete(DEAD)
    return idx


@pytest.fixture(scope="module")
def index(corpus):
    x, _, tt, _ = corpus
    idx = _grow(Index.create(tt, None, device="cpu"), x)
    idx.enable_codes(m=4, bits=4)
    return idx


def test_shardplan_json_equals_the_reference():
    names = [f"seg_{i:06d}" for i in range(1, 8)]
    sizes = [100, 700, 100, 100, 400, 50, 50]
    for n in (1, 2, 3):
        for tp, jp in ((ShardPlan.round_robin(names, n),
                        JPlan.round_robin(names, n)),
                       (ShardPlan.balanced(names, sizes, n),
                        JPlan.balanced(names, sizes, n))):
            assert tp.to_json() == jp.to_json()
            assert ShardPlan.from_json(jp.to_json()) == tp
    ex = [["seg_000001"], ["seg_000003", "seg_000002"]]
    assert ShardPlan.explicit(ex).to_json() == JPlan.explicit(ex).to_json()
    with pytest.raises(ValueError, match="twice"):
        ShardPlan.explicit([["a", "b"], ["b"]])
    with pytest.raises(ValueError, match="unknown shard strategy"):
        ShardPlan(n_shards=1, strategy="hash", assignment=(("a",),))


@pytest.mark.parametrize("n_shards", [1, 2, 3])
@pytest.mark.parametrize("strategy", ["round_robin", "balanced"])
@pytest.mark.parametrize("layout", ["point_major", "query_routed", "scan_codes"])
def test_sharded_search_bit_identical_to_unsharded(index, corpus, n_shards,
                                                   strategy, layout):
    q = corpus[3]
    sharded = ShardedIndex(index, n_shards=n_shards, strategy=strategy)
    for probes in (1, 2):
        kw = dict(k=5, layout=layout, probes=probes)
        ref = index.search(q, **kw)
        res = sharded.search(q, **kw)
        assert torch_equal(res.ids, ref.ids) and torch_equal(res.dists, ref.dists)
        assert float(res.pairs) == float(ref.pairs)
        assert int(res.q_cap_overflow) == int(ref.q_cap_overflow) == 0


def torch_equal(a, b):
    return np.array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_sharded_search_matches_the_reference(corpus, n_shards):
    x, jt, _, q = corpus
    jidx = _grow(JIndex.create(jt, None, mesh=_mesh()), x)
    tidx = _grow(Index.create(corpus[2], None, device="cpu"), x)
    assert shard_submeshes(_mesh(), n_shards)  # one shared device
    for layout in ("point_major", "query_routed"):
        jr = JSharded(jidx, n_shards=n_shards).search(q, k=5, layout=layout,
                                                      probes=2)
        tr = ShardedIndex(tidx, n_shards=n_shards).search(q, k=5, layout=layout,
                                                          probes=2)
        np.testing.assert_array_equal(np.asarray(jr.ids), tr.ids.numpy())
        np.testing.assert_array_equal(np.asarray(jr.dists), tr.dists.numpy())
        assert float(jr.pairs) == float(tr.pairs)


def test_empty_index_and_empty_shards(corpus, index):
    _, _, tt, q = corpus
    res = ShardedIndex(Index.create(tt, None, device="cpu"),
                       n_shards=2).search(q[:4], k=3)
    assert (res.ids == -1).all()
    ref = index.search(q, k=5, layout="point_major")
    res = ShardedIndex(index, n_shards=7).search(q, k=5, layout="point_major")
    assert torch_equal(res.ids, ref.ids)


def test_plan_persists_and_follows_the_lifecycle(corpus, tmp_path):
    x, _, tt, q = corpus
    d = str(tmp_path / "idx")
    idx = Index.create(tt, d, device="cpu")
    for lo, hi in zip(BOUNDS, BOUNDS[1:]):
        idx.append(x[lo:hi])
    idx.commit()
    plan = ShardPlan.for_index(idx, 2, "balanced")
    with pytest.raises(ValueError, match="cover"):
        idx.set_shard_plan(ShardPlan.round_robin(["seg_000001"], 1))
    idx.set_shard_plan(plan)
    idx.commit()
    reopened = Index.open(d, device="cpu")
    assert reopened.shard_plan == plan
    # the reference reads the same plan
    assert JIndex.open(d, mesh=_mesh()).shard_plan.to_json() == plan.to_json()
    reopened.append(x[:100], ids=np.arange(N, N + 100))
    reopened.commit()  # re-derived over the new segment set
    assert reopened.shard_plan.covers([s.name for s in reopened.segments])
    stale = ShardPlan.round_robin(["seg_000001"], 1)
    with pytest.raises(ValueError, match="does not cover"):
        ShardedIndex(reopened, plan=stale)
    res = ShardedIndex(reopened).search(q, k=5, layout="point_major")
    assert torch_equal(res.ids, reopened.search(q, k=5,
                                                layout="point_major").ids)
