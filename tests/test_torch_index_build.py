"""repro_torch index creation against the JAX package on one shard.

The reference runs on the Auto-axis mesh (its ``local_mesh()`` builds
Explicit axes, which jax 0.9 rejects further down the search path). The
JAX tree is carried across with ``interop.tree_from_numpy`` so leaf ids are
comparable; every index array must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.core import index_build as jib
from repro.core import route as jroute
from repro.core.tree import build_tree as j_build_tree
from repro_torch import interop
from repro_torch.core import index_build as tib
from repro_torch.core import route as troute
from repro_torch.core.sentinels import LEAF_SENTINEL
from repro_torch.data import synth
from repro_torch.distributed.meshutil import DeviceMesh

FIELDS = ("vecs", "ids", "leaves", "offsets", "n_valid", "overflow")


def _mesh():
    return Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def corpus():
    x, _ = synth.sample_descriptors(2048, 32, seed=0, n_centers=40)
    jt = j_build_tree(jnp.asarray(x), (8, 8), key=jax.random.PRNGKey(1))
    tt = interop.tree_from_numpy([np.asarray(lvl) for lvl in jt.levels],
                                 device="cpu")
    return x, jt, tt


def _assert_index_equal(ji, ti):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ji, f)),
                                      getattr(ti, f).numpy(), err_msg=f)
    assert ti.n_leaves == ji.n_leaves
    assert ti.rows == ji.rows and ti.leaves_per_shard == ji.leaves_per_shard


@pytest.mark.parametrize("wire", ["bfloat16", "float32"])
def test_build_index_matches_reference(corpus, wire):
    x, jt, tt = corpus
    ji = jib.build_index(jnp.asarray(x), jt, _mesh(),
                         wire_dtype=getattr(jnp, wire))
    ti = tib.build_index(x, tt, wire_dtype=getattr(torch, wire), device="cpu")
    _assert_index_equal(ji, ti)
    assert ti.rows == 2 * x.shape[0]  # one shard: capacity = 2x the rows
    assert int(ti.overflow) == 0


def test_build_index_real_valued_bf16_wire(corpus):
    # non-integer rows: the bf16 wire rounds; both sides round to nearest even
    x, jt, tt = corpus
    xr = x + np.random.default_rng(0).standard_normal(x.shape).astype(np.float32)
    ji = jib.build_index(jnp.asarray(xr), jt, _mesh())
    ti = tib.build_index(xr, tt, device="cpu")
    _assert_index_equal(ji, ti)


@pytest.mark.parametrize("wave_rows", [None, 100, 512, 2048, 1000, 4096])
def test_wave_size_does_not_change_the_index(corpus, wave_rows):
    x, _, tt = corpus
    ref = tib.build_index(x, tt, device="cpu")
    ti = tib.build_index(x, tt, wave_rows=wave_rows, device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(ref, f), getattr(ti, f)), f


@pytest.mark.parametrize("n", [4099, 8191])
def test_off_grid_rows_build_in_ragged_waves(corpus, n, monkeypatch):
    """A row count off the 4,096-row wave grid (4,099 is prime) runs
    ceil(n / 4096) waves, the last one ragged, and builds bit for bit the
    reference's index (whose waves snap to a divisor of n: one row a wave
    at 4,099) and the port's own build at one row a wave."""
    _, jt, tt = corpus
    x, _ = synth.sample_descriptors(n, 32, seed=n, n_centers=40)
    ji = jib.build_index(jnp.asarray(x), jt, _mesh(), wire_dtype=jnp.float32)
    calls = []
    real = tib.tree_assign

    def counted(tree, rows):
        calls.append(rows.shape[0])
        return real(tree, rows)

    monkeypatch.setattr(tib, "tree_assign", counted)
    ti = tib.build_index(x, tt, wire_dtype=torch.float32, device="cpu")
    assert calls == [4096, n - 4096]
    _assert_index_equal(ji, ti)
    calls.clear()
    one = tib.build_index(x, tt, wave_rows=1, wire_dtype=torch.float32,
                          device="cpu")
    assert len(calls) == n
    for f in FIELDS:
        assert torch.equal(getattr(one, f), getattr(ti, f)), f


def test_build_index_custom_ids_and_capacity(corpus):
    x, jt, tt = corpus
    ids = np.arange(1000, 1000 + x.shape[0], dtype=np.int32)
    ji = jib.build_index(jnp.asarray(x), jt, _mesh(), ids=jnp.asarray(ids),
                         capacity_factor=1.0)
    ti = tib.build_index(x, tt, ids=ids, capacity_factor=1.0, device="cpu")
    _assert_index_equal(ji, ti)


@pytest.mark.parametrize("rows,shards,factor", [(1000, 1, 2.0), (7, 1, 1.0),
                                                (4096, 4, 1.5), (3, 2, 2.0)])
def test_routing_capacity(rows, shards, factor):
    assert (tib.routing_capacity(rows, shards, factor)
            == jib.routing_capacity(rows, shards, factor))


@pytest.mark.parametrize("capacity", [3, 5, 40])
def test_counting_layout_and_scatter_match(capacity):
    rng = np.random.default_rng(capacity)
    dest = rng.integers(-1, 4, size=30).astype(np.int32)  # -1: padding rows
    jl = jroute.counting_layout(jnp.asarray(dest), 3, capacity)
    tl = troute.counting_layout(torch.as_tensor(dest), 3, capacity)
    np.testing.assert_array_equal(np.asarray(jl.slot_of_row), tl.slot_of_row.numpy())
    np.testing.assert_array_equal(np.asarray(jl.fits), tl.fits.numpy())
    assert int(jl.overflow) == int(tl.overflow)
    x = rng.standard_normal((30, 4)).astype(np.float32)
    js = jroute.scatter_to_slots(jl, jnp.asarray(x), 3, capacity, fill=7)
    ts = troute.scatter_to_slots(tl, torch.as_tensor(x), 3, capacity, fill=7)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())


def test_route_drops_and_counts_overflow(corpus):
    x, _, tt = corpus
    ti = tib.build_index(x, tt, capacity_factor=0.5, wire_dtype=torch.float32,
                         device="cpu")
    assert int(ti.overflow) == x.shape[0] // 2
    assert int(ti.n_valid[0]) == x.shape[0] // 2
    assert (ti.leaves[int(ti.n_valid[0]):] == LEAF_SENTINEL).all()


def test_route_rejects_several_shards():
    z = torch.zeros((4, 2))
    # several shards route only over a mesh of as many
    with pytest.raises(ValueError, match="mesh"):
        troute.route_by_leaf([z], [torch.arange(4)],
                             [torch.zeros(4, dtype=torch.int32)], n_shards=2,
                             leaves_per_shard=1, capacity=8,
                             mesh=DeviceMesh((torch.device("cpu"),)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["bfloat16", "float32"])
def test_cuda_build_index_matches_reference(corpus, cuda, wire):
    x, jt, _ = corpus
    ji = jib.build_index(jnp.asarray(x), jt, _mesh(),
                         wire_dtype=getattr(jnp, wire))
    tree_c = interop.tree_from_numpy([np.asarray(lvl) for lvl in jt.levels],
                                     device=cuda)
    ti = tib.build_index(x, tree_c, wire_dtype=getattr(torch, wire), device=cuda)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ji, f)),
                                      getattr(ti, f).cpu().numpy(), err_msg=f)


@pytest.mark.cuda
def test_cuda_off_grid_build_matches_cpu(corpus, cuda):
    """4,099 rows (prime) on the card: two waves, the last ragged, the same
    index as the CPU build and as the card's build at 1,000-row waves."""
    _, jt, tt = corpus
    x, _ = synth.sample_descriptors(4099, 32, seed=4099, n_centers=40)
    tree_c = interop.tree_from_numpy([np.asarray(lvl) for lvl in jt.levels],
                                     device=cuda)
    cpu = tib.build_index(x, tt, wire_dtype=torch.float32, device="cpu")
    from repro_torch.kernels.l2nn.ops import l2_nearest
    before = l2_nearest.launches
    gpu = tib.build_index(x, tree_c, wire_dtype=torch.float32, device=cuda)
    assert l2_nearest.launches - before == 2
    other = tib.build_index(x, tree_c, wave_rows=1000, wire_dtype=torch.float32,
                            device=cuda)
    for f in FIELDS:
        assert torch.equal(getattr(cpu, f), getattr(gpu, f).cpu()), f
        assert torch.equal(getattr(other, f), getattr(gpu, f)), f
