"""repro_torch tree and lookup against the JAX package.

The port's ``build_tree`` draws from a ``torch.Generator``, which cannot
replay ``jax.random``; so leaf ids are compared on the reference's own tree
arrays, carried across with ``interop.tree_from_numpy``, and the port's
``build_tree`` is held by structure. Data are quantized SIFT-like rows
(integers), on which every distance is exact in fp32, so leaves match
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lookup import build_lookup as j_build_lookup
from repro.core.lookup import lookup_from_leaves as j_lookup_from_leaves
from repro.core.lookup import probe_leaves as j_probe_leaves
from repro.core.tree import build_tree as j_build_tree
from repro.core.tree import leaf_centroids as j_leaf_centroids
from repro.core.tree import tree_assign as j_tree_assign
from repro_torch import interop
from repro_torch.core import lookup as tlookup
from repro_torch.core import tree as ttree
from repro_torch.data import synth


def _corpus(n, d, seed=0, n_centers=40):
    x, _ = synth.sample_descriptors(n, d, seed=seed, n_centers=n_centers)
    return x


@pytest.fixture(scope="module", params=[(8, 8), (4, 3, 5)], ids=["8x8", "4x3x5"])
def trees(request):
    x = _corpus(3000, 32, seed=len(request.param))
    jt = j_build_tree(jnp.asarray(x), request.param, key=jax.random.PRNGKey(1),
                      refine_iters=1)
    tt = interop.tree_from_numpy([np.asarray(lvl) for lvl in jt.levels],
                                 device="cpu")
    return x, jt, tt


def test_tree_assign_matches_reference(trees):
    x, jt, tt = trees
    ja = np.asarray(j_tree_assign(jt, jnp.asarray(x)))
    ta = ttree.tree_assign(tt, torch.as_tensor(x))
    assert ta.dtype == torch.int32
    np.testing.assert_array_equal(ja, ta.numpy())


def test_tree_assign_chunking_gives_same_leaves(trees, monkeypatch):
    x, _, tt = trees
    full = ttree.tree_assign(tt, torch.as_tensor(x))
    monkeypatch.setattr(ttree, "CHUNK_ROWS", 257)
    np.testing.assert_array_equal(
        full.numpy(), ttree.tree_assign(tt, torch.as_tensor(x)).numpy())


@pytest.mark.parametrize("rows", [1, 100, 257, 3000])
def test_descend_runs_every_product_at_one_size(trees, monkeypatch, rows):
    """However many rows a call has, each batched product of a deeper
    level runs at ``CHUNK_ROWS`` rows (the last chunk padded), so cuBLAS
    sums every row's dot products in one order; the leaves stay the
    reference's."""
    x, jt, tt = trees
    monkeypatch.setattr(ttree, "CHUNK_ROWS", 256)
    sizes = []
    real = torch.einsum

    def einsum(eq, *ops):
        if eq == "nd,nfd->nf":
            sizes.append(ops[0].shape[0])
        return real(eq, *ops)

    monkeypatch.setattr(torch, "einsum", einsum)
    got = ttree.tree_assign(tt, torch.as_tensor(x[:rows])).numpy()
    assert sizes and set(sizes) == {256}
    assert len(sizes) == -(-rows // 256) * (len(tt.levels) - 1)
    np.testing.assert_array_equal(got, np.asarray(j_tree_assign(jt, jnp.asarray(x[:rows]))))


@pytest.mark.parametrize("rows", [1, 70, 3000])
def test_probe_chunks_run_at_one_size(trees, monkeypatch, rows):
    """``probe_leaves`` runs every beam chunk at ``PROBE_CHUNK`` rows (the
    last one padded); the probes stay the reference's."""
    x, jt, tt = trees
    q = x[:rows] + 1.0
    monkeypatch.setattr(tlookup, "PROBE_CHUNK", 64)
    sizes = []
    real = tlookup._probe_chunk

    def chunk(tree, qf, probes):
        sizes.append(qf.shape[0])
        return real(tree, qf, probes)

    monkeypatch.setattr(tlookup, "_probe_chunk", chunk)
    got = tlookup.probe_leaves(tt, torch.as_tensor(q), 2).numpy()
    assert set(sizes) == {64} and len(sizes) == -(-rows // 64)
    np.testing.assert_array_equal(got, np.asarray(j_probe_leaves(jt, jnp.asarray(q), 2)))


def test_tree_properties_match(trees):
    _, jt, tt = trees
    assert tt.fanouts == jt.fanouts
    assert tt.n_leaves == jt.n_leaves
    assert tt.dim == jt.dim
    assert tt.nbytes == jt.nbytes
    np.testing.assert_array_equal(np.asarray(j_leaf_centroids(jt)),
                                  ttree.leaf_centroids(tt).numpy())


@pytest.mark.parametrize("probes", [1, 2, 3])
def test_probe_leaves_match_reference(trees, probes):
    x, jt, tt = trees
    q = x[::7] + 1.0
    jl = np.asarray(j_probe_leaves(jt, jnp.asarray(q), probes))
    tl = tlookup.probe_leaves(tt, torch.as_tensor(q), probes)
    np.testing.assert_array_equal(jl, tl.numpy())
    # column 0 is the hard assignment
    np.testing.assert_array_equal(
        tl[:, 0].numpy(), ttree.tree_assign(tt, torch.as_tensor(q)).numpy())


@pytest.mark.parametrize("probes", [1, 2, 3])
def test_build_lookup_matches_reference(trees, probes):
    x, jt, tt = trees
    q = x[::11]
    jl = j_build_lookup(jt, jnp.asarray(q), probes=probes)
    tl = tlookup.build_lookup(tt, torch.as_tensor(q), probes=probes)
    for f in ("vecs", "qids", "leaves", "offsets"):
        np.testing.assert_array_equal(np.asarray(getattr(jl, f)),
                                      getattr(tl, f).numpy(), err_msg=f)
    assert tl.n_queries == jl.n_queries and tl.n_leaves == jl.n_leaves


@pytest.mark.parametrize("n_valid,q_total", [(10, None), (7, 40), (3, 33)])
def test_lookup_from_leaves_masks_and_pads(trees, n_valid, q_total):
    x, jt, tt = trees
    q = x[:11]
    probes = 3 if q_total == 33 else 2
    leaves = np.array(j_probe_leaves(jt, jnp.asarray(q), probes))
    jl = j_lookup_from_leaves(jnp.asarray(q), jnp.asarray(leaves),
                              n_leaves=jt.n_leaves, n_valid=n_valid,
                              q_total=q_total)
    tl = tlookup.lookup_from_leaves(torch.as_tensor(q), torch.as_tensor(leaves),
                                    n_leaves=tt.n_leaves, n_valid=n_valid,
                                    q_total=q_total)
    for f in ("vecs", "qids", "leaves", "offsets"):
        np.testing.assert_array_equal(np.asarray(getattr(jl, f)),
                                      getattr(tl, f).numpy(), err_msg=f)


def test_build_lookup_bucketed_returns_probe_leaves(trees):
    x, _, tt = trees
    q = torch.as_tensor(x[:9])
    lk, leaves = tlookup.build_lookup_bucketed(tt, q, 6, probes=2, q_total=20)
    assert leaves.shape == (9, 2)
    assert lk.vecs.shape == (20, x.shape[1])
    assert (lk.leaves[:6] == -2).all()  # 3 masked queries x 2 probes sort first


@pytest.mark.parametrize("bad", [0, 10**6])
def test_build_lookup_rejects_bad_probes(trees, bad):
    _, _, tt = trees
    with pytest.raises(ValueError):
        tlookup.build_lookup(tt, torch.zeros((2, tt.dim)), probes=bad)


@pytest.mark.parametrize("refine_iters", [0, 2])
@pytest.mark.parametrize("fanouts", [(8, 8), (4, 3, 5), (16,)])
def test_build_tree_structure(fanouts, refine_iters):
    x = _corpus(2000, 16, seed=3)
    tt = ttree.build_tree(x, fanouts, generator=torch.Generator().manual_seed(1),
                          refine_iters=refine_iters, device="cpu")
    assert tt.fanouts == fanouts
    assert tt.levels[0].shape == (fanouts[0], 16)
    nodes = fanouts[0]
    for lvl, f in zip(tt.levels[1:], fanouts[1:]):
        assert lvl.shape == (nodes, f, 16)
        nodes *= f
    assert all(lvl.dtype == torch.float32 for lvl in tt.levels)
    leaves = ttree.tree_assign(tt, torch.as_tensor(x))
    assert ((leaves >= 0) & (leaves < tt.n_leaves)).all()
    if refine_iters == 0:
        # paper mode: every representative is a sample row
        rows = {tuple(r) for r in x.tolist()}
        assert all(tuple(r) in rows for r in ttree.leaf_centroids(tt).tolist())


def test_build_tree_reproducible_from_seed():
    x = _corpus(1000, 8, seed=4)
    a = ttree.build_tree(x, (4, 4), generator=torch.Generator().manual_seed(7),
                         device="cpu")
    b = ttree.build_tree(x, (4, 4), generator=torch.Generator().manual_seed(7),
                         device="cpu")
    assert all(torch.equal(u, v) for u, v in zip(a.levels, b.levels))


def test_build_tree_fewer_rows_than_fanout():
    x = _corpus(5, 8, seed=5)
    tt = ttree.build_tree(x, (8, 2), generator=torch.Generator().manual_seed(0),
                          device="cpu")
    assert tt.fanouts == (8, 2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("probes", [1, 2, 3])
def test_cuda_probe_leaves_match_reference(trees, cuda, probes):
    x, jt, _ = trees
    tree_c = interop.tree_from_numpy([np.asarray(lvl) for lvl in jt.levels],
                                     device=cuda)
    q = x[::7] + 1.0
    # the centroids are real-valued means, some 3e-5 apart: where JAX runs
    # on a GPU its default fp32 matmul is TF32, which flips such near-ties,
    # so the reference is asked for fp32
    with jax.default_matmul_precision("float32"):
        jl = np.asarray(j_probe_leaves(jt, jnp.asarray(q), probes))
        jleaf = np.asarray(j_tree_assign(jt, jnp.asarray(x)))
    tl = tlookup.probe_leaves(tree_c, torch.as_tensor(q, device=cuda), probes)
    np.testing.assert_array_equal(jl, tl.cpu().numpy())
    np.testing.assert_array_equal(
        jleaf,
        ttree.tree_assign(tree_c, torch.as_tensor(x, device=cuda)).cpu().numpy())


@pytest.mark.cuda
def test_cuda_build_tree_structure(cuda):
    x = _corpus(5000, 32, seed=6)
    tt = ttree.build_tree(x, (16, 8), generator=torch.Generator().manual_seed(2),
                          refine_iters=1, device=cuda)
    assert tt.fanouts == (16, 8) and tt.device.type == "cuda"
    leaves = ttree.tree_assign(tt, torch.as_tensor(x, device=cuda))
    assert ((leaves >= 0) & (leaves < tt.n_leaves)).all()


@pytest.mark.cuda
def test_cuda_real_valued_leaves_do_not_depend_on_the_call_size(cuda):
    """Real-valued rows and centroids (no exact fp32 sums): assigning in
    waves of 4096, 1000 or 3 rows gives the same leaves on the card,
    ``probe_leaves`` column 0 equals them (P4), and every probe is the
    same whether the queries come in one call or in many."""
    x = torch.as_tensor(_corpus(20000, 128, seed=5, n_centers=256), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    tree = ttree.build_tree(x, (64, 64), generator=torch.Generator().manual_seed(1),
                            device=cuda)
    tree = ttree.VocabTree(levels=tuple(
        lvl + torch.rand(lvl.shape, generator=g, device=cuda) - 0.5
        for lvl in tree.levels))
    xr = x + torch.rand(x.shape, generator=g, device=cuda) - 0.5

    def waves(w):
        return torch.cat([ttree.tree_assign(tree, xr[s:s + w])
                          for s in range(0, xr.shape[0], w)])

    ref = waves(4096)
    for w in (1000, 3, 20000):
        assert torch.equal(waves(w), ref), w
    probes = tlookup.probe_leaves(tree, xr, 2)
    assert torch.equal(probes[:, 0], ref)
    for w in (1000, 3):  # every probe, not only column 0 (P4)
        split = torch.cat([tlookup.probe_leaves(tree, xr[s:s + w], 2)
                           for s in range(0, 6000, w)])
        assert torch.equal(split, probes[:6000]), w
