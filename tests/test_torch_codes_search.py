"""repro_torch compressed-codes search (``scan_codes``: ADC scan, then exact
rerank) against the JAX package's ``search_with_lookup(..., codes,
codebooks)`` with ``impl="xla"``, on an Auto mesh (ROADMAP R1; its fused
executor fails inside ``shard_map``, R2). The JAX ``DistributedIndex``
plays one segment, as ``Index.search`` runs it.

The same codes and codebooks go to both packages. With integer-valued
codebooks and queries every LUT entry and ADC sum is an exact integer, so
ids, ADC distances, ``pairs`` and ``q_cap_overflow`` are equal bit for bit,
at probes 1-2, with a starved ``q_cap``, and with tombstones mid-shard.
With trained (real-valued) codebooks the LUTs' matmuls sum in other
orders: ADC distances are held within 2e-6 of each row's LUT scale (about
16 ulp of the largest entry) and the exactly reranked ids are equal. The
port's wave sweep (``"pallas"``) and fused scan agree bit for bit.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.codes import ProductQuantizer as JPQ
from repro.codes import rerank_exact as j_rerank
from repro.core import index_build as jib
from repro.core import lookup as jlookup
from repro.core import search as jsearch
from repro.core.tree import build_tree as j_build_tree
from repro_torch import interop
from repro_torch.codes import IndexRowReader, rerank_exact
from repro_torch.core import lookup as tlookup
from repro_torch.core.search import search_with_lookup
from repro_torch.data import synth

jplan = importlib.import_module("repro.core.engine.plan")
tplan = importlib.import_module("repro_torch.core.engine.plan")
K = 5
M = 8


def _mesh():
    return Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def world():
    x, _ = synth.sample_descriptors(2048, 32, seed=0, n_centers=40)
    jt = j_build_tree(jnp.asarray(x), (8, 8), key=jax.random.PRNGKey(1))
    ji = jib.build_index(jnp.asarray(x), jt, _mesh(), wire_dtype=jnp.float32)
    tt = interop.tree_from_numpy([np.asarray(lvl) for lvl in jt.levels],
                                 device="cpu")
    q = x[::9][:150] + np.random.default_rng(1).integers(
        -3, 4, size=(150, 32)).astype(np.float32)
    # tombstones: every 7th live row, mid-shard; they keep their leaf
    ids = np.asarray(ji.ids).copy()
    live = np.flatnonzero(ids >= 0)
    ids[live[3::7]] = -1
    ji_dead = dataclasses.replace(ji, ids=jnp.asarray(ids))
    return dict(x=x, q=q, jt=jt, tt=tt, indexes={False: ji, True: ji_dead})


def _port_index(ji):
    return interop.index_from_numpy(
        **{f: np.asarray(getattr(ji, f)) for f in
           ("vecs", "ids", "leaves", "offsets", "n_valid", "overflow")},
        n_leaves=ji.n_leaves, device="cpu")


@pytest.fixture(scope="module")
def integer_codes(world):
    """Integer codebooks (4 values per subspace of 16 centres: the LUT
    holds exact integers) and every index row's codes, padding included."""
    cb = np.random.default_rng(5).integers(0, 256, size=(M, 16, 4)).astype(
        np.float32)
    codes = JPQ(cb).encode(np.asarray(world["indexes"][False].vecs))
    return cb, codes


@pytest.fixture(scope="module")
def trained_codes(world):
    pq = JPQ.train(world["x"], m=M, bits=8, seed=0, sample=2048, iters=6)
    return pq.codebooks, pq.encode(np.asarray(world["indexes"][False].vecs))


_REF = {}


def _reference(world, cb, codes, *, probes, q_cap, dead, tag, rerank=None):
    key = (tag, probes, q_cap, dead, rerank)
    if key not in _REF:
        ji = world["indexes"][dead]
        n_q = world["q"].shape[0]
        lk = jlookup.build_lookup(world["jt"], jnp.asarray(world["q"]),
                                  probes=probes)
        p = jplan.plan(rows=ji.rows, n_leaves=ji.n_leaves, n_queries=n_q,
                       n_shards=1, k=K, probes=probes, layout="scan_codes",
                       impl="xla", q_cap=q_cap, dim=32, code_m=cb.shape[0],
                       code_bits=int(cb.shape[1] - 1).bit_length(),
                       model="heuristic", rerank=rerank)
        res = jsearch.search_with_lookup(ji, lk, p, _mesh(), n_queries=n_q,
                                         codes=codes, codebooks=cb)
        _REF[key] = p, res
    return _REF[key]


def _port(world, cb, codes, *, probes, q_cap, dead, impl, rerank=None):
    ti = _port_index(world["indexes"][dead])
    n_q = world["q"].shape[0]
    lk = tlookup.build_lookup(world["tt"], torch.as_tensor(world["q"]),
                              probes=probes)
    p = tplan.plan(rows=ti.rows, n_leaves=ti.n_leaves, n_queries=n_q,
                   n_shards=1, k=K, probes=probes, layout="scan_codes",
                   impl=impl, q_cap=q_cap, code_m=cb.shape[0],
                   code_bits=int(cb.shape[1] - 1).bit_length(), rerank=rerank)
    res = search_with_lookup(ti, lk, p, n_queries=n_q,
                             codes=interop.codes_from_numpy(codes, "cpu"),
                             codebooks=cb)
    return ti, p, res


def _assert_same_plan(jp, tp):
    for f in ("layout", "k", "probes", "block_rows", "q_cap", "rerank",
              "code_m", "code_bits"):
        assert getattr(jp, f) == getattr(tp, f), f


def _assert_same(jr, tr, row_atol=None):
    jd, td = np.asarray(jr.dists), tr.dists.numpy()
    np.testing.assert_array_equal(np.isfinite(jd), np.isfinite(td))
    if row_atol is None:
        np.testing.assert_array_equal(np.asarray(jr.ids), tr.ids.numpy())
        np.testing.assert_array_equal(jd, td)
    else:
        fin = np.isfinite(jd)
        err = np.abs(jd[fin] - td[fin])
        bound = np.broadcast_to(row_atol[:, None], jd.shape)[fin]
        assert (err <= bound).all(), f"max error / bound {(err / bound).max()}"
    assert float(jr.pairs) == float(tr.pairs)
    assert int(jr.q_cap_overflow) == int(tr.q_cap_overflow)


def _rerank_both(world, jr, tr, ti, dead):
    ji = world["indexes"][dead]
    vecs, ids = np.asarray(ji.vecs), np.asarray(ji.ids)
    live = np.flatnonzero(ids >= 0)
    order = live[np.argsort(ids[live])]

    def read(u):
        return vecs[order[np.searchsorted(ids[order], u)]]

    want = j_rerank(read, world["q"], np.asarray(jr.ids), K)
    got = rerank_exact(IndexRowReader(ti), torch.as_tensor(world["q"]),
                       tr.ids, K)
    return want, got


@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("probes", [1, 2])
@pytest.mark.parametrize("impl", ["xla", "pallas", "fused"])
def test_scan_codes_matches_reference_integer_codebooks(world, integer_codes,
                                                        impl, probes, dead):
    cb, codes = integer_codes
    jp, jr = _reference(world, cb, codes, probes=probes, q_cap=256, dead=dead,
                        tag="int")
    ti, tp, tr = _port(world, cb, codes, probes=probes, q_cap=256, dead=dead,
                       impl=impl)
    _assert_same_plan(jp, tp)
    assert tp.rerank == 64 and int(tr.q_cap_overflow) == 0
    assert tr.ids.shape == (world["q"].shape[0], tp.rerank)
    _assert_same(jr, tr)
    (wi, wd), (gi, gd) = _rerank_both(world, jr, tr, ti, dead)
    np.testing.assert_array_equal(wi, gi.numpy())
    np.testing.assert_array_equal(wd, gd.numpy())
    if dead:  # no tombstoned id survives the scan
        was = np.asarray(world["indexes"][False].ids)
        dead_ids = set(was[(was >= 0)
                           & (np.asarray(world["indexes"][True].ids) < 0)])
        assert not dead_ids & set(tr.ids.numpy().ravel().tolist())


@pytest.mark.parametrize("impl", ["xla", "pallas", "fused"])
def test_scan_codes_matches_reference_at_rerank_256(world, integer_codes, impl):
    # a rerank depth past the K4/K5 lists' capacity (128), as
    # default_rerank gives for k > 128 (ROADMAP P7), with tombstones
    cb, codes = integer_codes
    jp, jr = _reference(world, cb, codes, probes=1, q_cap=256, dead=True,
                        tag="int", rerank=256)
    ti, tp, tr = _port(world, cb, codes, probes=1, q_cap=256, dead=True,
                       impl=impl, rerank=256)
    _assert_same_plan(jp, tp)
    assert tp.rerank == 256 and tr.ids.shape == (world["q"].shape[0], 256)
    _assert_same(jr, tr)
    (wi, wd), (gi, gd) = _rerank_both(world, jr, tr, ti, True)
    np.testing.assert_array_equal(wi, gi.numpy())
    np.testing.assert_array_equal(wd, gd.numpy())


@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("probes", [1, 2])
def test_starved_q_cap_counts_the_same_overflow(world, integer_codes, probes,
                                                dead):
    cb, codes = integer_codes
    _, jr = _reference(world, cb, codes, probes=probes, q_cap=8, dead=dead,
                       tag="int")
    _, _, tr = _port(world, cb, codes, probes=probes, q_cap=8, dead=dead,
                     impl="pallas")
    assert int(tr.q_cap_overflow) > 0
    _assert_same(jr, tr)


@pytest.mark.parametrize("probes", [1, 2])
def test_scan_codes_matches_reference_trained_codebooks(world, trained_codes,
                                                        probes):
    cb, codes = trained_codes
    _, jr = _reference(world, cb, codes, probes=probes, q_cap=256, dead=True,
                       tag="trained")
    ti, _, tr = _port(world, cb, codes, probes=probes, q_cap=256, dead=True,
                      impl="pallas")
    q = world["q"].astype(np.float64).reshape(-1, M, 4)
    scale = ((q * q).sum(-1) + (cb.astype(np.float64) ** 2).sum(-1).max(-1)
             ).sum(-1)
    _assert_same(jr, tr, row_atol=2e-6 * scale)
    (wi, wd), (gi, gd) = _rerank_both(world, jr, tr, ti, True)
    np.testing.assert_array_equal(wi, gi.numpy())
    np.testing.assert_array_equal(wd, gd.numpy())


@pytest.mark.parametrize("codebooks", ["integer", "trained"])
@pytest.mark.parametrize("probes", [1, 2])
def test_wave_sweep_equals_fused(world, integer_codes, trained_codes, probes,
                                 codebooks):
    cb, codes = integer_codes if codebooks == "integer" else trained_codes
    _, _, a = _port(world, cb, codes, probes=probes, q_cap=256, dead=True,
                    impl="pallas")
    _, _, b = _port(world, cb, codes, probes=probes, q_cap=256, dead=True,
                    impl="fused")
    assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
    assert torch.equal(a.pairs, b.pairs)


def test_scan_codes_plan_needs_codes(world):
    with pytest.raises(ValueError, match="code_m"):
        tplan.plan(rows=4096, n_leaves=64, n_queries=10, n_shards=1, k=K,
                   layout="scan_codes")
    ti = _port_index(world["indexes"][False])
    lk = tlookup.build_lookup(world["tt"], torch.as_tensor(world["q"]))
    p = tplan.plan(rows=ti.rows, n_leaves=ti.n_leaves, n_queries=150,
                   n_shards=1, k=K, layout="scan_codes", code_m=M, code_bits=4)
    with pytest.raises(ValueError, match="codes"):
        search_with_lookup(ti, lk, p, n_queries=150)


@pytest.mark.parametrize("k,rows", [(1, 10**6), (20, 10**6), (20, 50), (200, 10**6)])
def test_default_rerank_matches_reference(k, rows):
    assert tplan.default_rerank(k, rows) == jplan.default_rerank(k, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("rerank", [64, 256])
def test_cuda_scan_codes_sweep_and_fused_agree(world, integer_codes, rerank):
    # on the card the wave sweep (K4, or the wide kernel past 128) and the
    # fused scan (K5, or the wide kernel) are bit-identical, and equal to
    # the CPU path, with tombstones
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cb, codes = integer_codes
    ti, p, want = _port(world, cb, codes, probes=1, q_cap=256, dead=True,
                        impl="fused", rerank=rerank)
    dev = torch.device("cuda")
    tic = interop.index_from_numpy(
        **{f: getattr(ti, f).numpy() for f in
           ("vecs", "ids", "leaves", "offsets", "n_valid", "overflow")},
        n_leaves=ti.n_leaves, device=dev)
    tree_c = interop.tree_from_numpy([lvl.numpy() for lvl in world["tt"].levels],
                                     device=dev)
    lk = tlookup.build_lookup(tree_c, torch.as_tensor(world["q"], device=dev))
    got = [search_with_lookup(tic, lk, dataclasses.replace(p, impl=impl),
                              n_queries=world["q"].shape[0],
                              codes=interop.codes_from_numpy(codes, dev),
                              codebooks=cb)
           for impl in ("pallas", "fused")]
    torch.cuda.synchronize()
    for f in ("ids", "dists", "pairs"):
        assert torch.equal(getattr(got[0], f), getattr(got[1], f)), f
        assert torch.equal(getattr(want, f), getattr(got[0], f).cpu()), f
