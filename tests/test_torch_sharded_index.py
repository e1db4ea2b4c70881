"""repro_torch's ``Index`` and ``ShardedIndex`` over a mesh of CPU shards:
a directory grown at two shards by either package and searched by the
other gives the same ids, distances and counts (tests/mesh_reference.py
runs the JAX package's ``Index`` on two host devices in a subprocess); a
mesh of another shard count is refused with the reference's message; the
id space advances past rows that routing dropped (ROADMAP P12, where the
reference reuses an id); and ``ShardedIndex`` on a mesh of four CPU
devices, its shards on disjoint submeshes, equals the unsharded index."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mesh_reference as mref
from repro_torch import interop
from repro_torch.distributed.meshutil import DeviceMesh
from repro_torch.index import Index, ShardedIndex

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
MESH2 = DeviceMesh((CPU,) * 2)


def _grow(idx, x):
    for lo, hi in zip(mref.APPENDS, mref.APPENDS[1:]):
        idx.append(x[lo:hi])
    idx.commit()
    idx.delete(mref.DEAD)
    idx.commit()
    return idx


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port grows ``port/`` at two shards; then the reference grows
    ``ref/``, searches it and the port's directory."""
    base = tmp_path_factory.mktemp("mesh_index")
    x, skew, q = mref.corpus()
    # the tree: the reference's, carried through its build case's numbers
    tree_npz = base / "tree.npz"
    run = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "mesh_reference.py"), "tree",
         str(tree_npz)], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert run.returncode == 0, run.stderr[-3000:]
    levels = np.load(tree_npz)
    tree = interop.tree_from_numpy(
        [levels[f"tree_{i}"] for i in range(len(mref.FANOUTS))], device="cpu")
    port_dir = str(base / "port")
    _grow(Index.create(tree, port_dir, mesh=MESH2), x)
    out = base / "index.npz"
    run = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "mesh_reference.py"), "index",
         str(out), port_dir], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert run.returncode == 0, run.stderr[-3000:]
    ref = dict(np.load(out))
    return dict(x=x, skew=skew, q=q, tree=tree, ref=ref, port_dir=port_dir,
                ref_dir=str(ref["ref_dir"]))


def _same(res, ref, tag):
    np.testing.assert_array_equal(res.ids.numpy(), ref[f"{tag}_ids"])
    np.testing.assert_array_equal(res.dists.numpy(), ref[f"{tag}_dists"])
    assert float(res.pairs) == float(ref[f"{tag}_pairs"])
    assert int(res.q_cap_overflow) == int(ref[f"{tag}_ov"])


@pytest.mark.parametrize("grown_by", ["ref", "port"])
@pytest.mark.parametrize("layout", ["point_major", "query_routed"])
@pytest.mark.parametrize("probes", [1, 2])
def test_directories_cross_read_at_two_shards(world, grown_by, layout, probes):
    idx = Index.open(world[f"{grown_by}_dir"], mesh=MESH2)
    assert idx.meta["n_shards"] == 2
    assert all(s.n_shards == 2 for s in idx.segments)
    res = idx.search(world["q"], mref.K, layout=layout, probes=probes,
                     impl="xla")
    # the reference's search of either directory
    _same(res, world["ref"], f"{grown_by}_{layout}_{probes}")


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def _close_json(a, b, path=""):
    """Equal JSON, floats within 1e-12 relative (norm stats)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for key in a:
            _close_json(a[key], b[key], f"{path}/{key}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _close_json(u, v, f"{path}/{i}")
    elif isinstance(a, float) and not float(a).is_integer():
        assert abs(a - b) <= 1e-12 * abs(a), (path, a, b)
    else:
        assert a == b, (path, a, b)


def test_two_shard_directories_hold_identical_bytes(world):
    """The same growth at two shards by either package writes the same
    files: every array with the reference's dtype and bytes (the routing
    overflow, ``index/5``, an int32 as the reference's), every JSON with
    the same keys and values."""
    pd, rd = world["port_dir"], world["ref_dir"]
    assert _files(pd) == _files(rd)
    n_arrays = 0
    for rel in _files(rd):
        a = Path(rd, rel).read_bytes()
        b = Path(pd, rel).read_bytes()
        if rel.endswith(".json"):
            _close_json(json.loads(b), json.loads(a), rel)
            continue
        if rel.endswith(".npy"):
            want, got = np.load(Path(rd, rel)), np.load(Path(pd, rel))
            assert got.dtype == want.dtype, (rel, got.dtype, want.dtype)
            assert got.shape == want.shape, rel
            n_arrays += 1
        assert b == a, rel
    assert n_arrays >= 12  # two segments' six index arrays at least


def test_open_refuses_another_shard_count(world):
    with pytest.raises(ValueError, match="built for 2 shards; current mesh "
                                         "has 4"):
        Index.open(world["ref_dir"], mesh=DeviceMesh((CPU,) * 4))
    with pytest.raises(ValueError, match="built for 2 shards"):
        Index.open(world["port_dir"], device="cpu")


def test_p12_ids_follow_the_rows_whatever_routing_dropped(world):
    """Two appends at four shards whose first loses its last row to
    routing: the reference's second segment starts one id early (it reuses
    the dropped row's id), the port's at the row number, so every id the
    port returns is the row its distance was measured to."""
    ref, skew, q = world["ref"], world["skew"], world["q"]
    a, b, c = mref.P12_APPENDS
    assert ref["p12_overflow"][0] > 0
    assert list(ref["p12_min_ids"]) == [0, b - 1]  # the reference's shift
    idx = Index.create(world["tree"], None, mesh=DeviceMesh((CPU,) * 4))
    idx.append(skew[a:b])
    assert idx.next_id == b
    idx.append(skew[b:c])
    assert idx.next_id == c
    assert [s.min_id for s in idx.segments] == [0, b]
    res = idx.search(q, mref.K, layout="point_major", impl="xla")
    ids, dists = res.ids.numpy(), res.dists.numpy()
    ok = ids >= 0
    true = ((skew[ids[ok]] - np.repeat(q, mref.K, 0).reshape(
        len(q), mref.K, -1)[ok]) ** 2).sum(-1)
    np.testing.assert_array_equal(dists[ok], true)
    # the reference's ids past the shift name the wrong rows
    rids, rd = ref["p12_ids"], ref["p12_dists"]
    late = rids >= b - 1
    assert late.any()
    wrong = ((skew[rids[late]] - np.repeat(q, mref.K, 0).reshape(
        len(q), mref.K, -1)[late]) ** 2).sum(-1) != rd[late]
    assert wrong.any()


def test_user_ids_advance_the_id_space_past_their_max(world):
    idx = Index.create(world["tree"], None, mesh=MESH2)
    idx.append(world["x"][:100], ids=np.arange(1000, 1100))
    assert idx.next_id == 1100


@pytest.fixture(scope="module")
def grown4(world):
    idx = Index.create(world["tree"], None, mesh=DeviceMesh((CPU,) * 4))
    return _grow(idx, world["x"])


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("layout", ["point_major", "query_routed"])
def test_sharded_index_on_four_devices_equals_unsharded(grown4, world,
                                                         n_shards, layout):
    sh = ShardedIndex(grown4, n_shards=n_shards)
    # the devices split evenly: each shard scans on its own submesh
    assert [m.n_shards for m in sh.submeshes] == [4 // n_shards] * n_shards
    for probes in (1, 2):
        want = grown4.search(world["q"], mref.K, layout=layout, probes=probes,
                             impl="xla")
        got = sh.search(world["q"], mref.K, layout=layout, probes=probes,
                        impl="xla")
        assert torch.equal(got.ids, want.ids)
        assert torch.equal(got.dists, want.dists)


@pytest.mark.parametrize("layout,probes", [("point_major", 1),
                                           ("query_routed", 2)])
def test_sessions_over_a_mesh_index_equal_its_search(grown4, world, layout,
                                                     probes):
    from repro_torch.serving import SearchSession, ShardedSearchSession

    q = world["q"]
    kw = dict(k=mref.K, layout=layout, probes=probes, buckets=(32, 64),
              cost_model="heuristic")
    want = grown4.search(q, mref.K, layout=layout, probes=probes, impl="xla")
    for sess in (SearchSession(grown4, **kw),
                 ShardedSearchSession(grown4, shards=2, **kw)):
        sess.warmup()
        ids, dists = sess.search(q)
        np.testing.assert_array_equal(ids, want.ids.numpy())
        np.testing.assert_array_equal(dists, want.dists.numpy())
        assert sess.steady_state_recompiles() == 0


def test_codes_and_read_rows_at_four_shards(grown4, world):
    grown4.enable_codes(m=4, bits=4, sample=2048, iters=4)
    live = np.setdiff1d(np.arange(mref.N), mref.DEAD)[:50]
    np.testing.assert_array_equal(grown4.read_rows(live).numpy(),
                                  world["x"][live])
    res = grown4.search(world["q"], mref.K, layout="scan_codes", rerank=16)
    # the same growth on one shard: the same valid rows in the same order
    # train the same codebooks, and a lookup row meets one leaf's rows in
    # the same order on either layout
    one = _grow(Index.create(world["tree"], None, device="cpu"), world["x"])
    one.enable_codes(m=4, bits=4, sample=2048, iters=4)
    want = one.search(world["q"], mref.K, layout="scan_codes", rerank=16)
    assert torch.equal(res.ids, want.ids)
    assert torch.equal(res.dists, want.dists)
    # compaction rebuilds over the mesh and keeps the answers
    grown4.compact()
    again = grown4.search(world["q"], mref.K, layout="scan_codes", rerank=16)
    assert torch.equal(again.ids, res.ids)
