"""repro_torch's segment lifecycle (``Index``) against the JAX package's.

Cross-reading, both ways: the port opens a directory the JAX package grew
(two appends, a delete, codes; a float32 wire and a bf16 one) and returns
its ``search`` results at both dense layouts, probes 1 and 2, and at
``scan_codes``; the JAX package opens what the port wrote, and the two
directories hold the same files, manifest keys and crc32s. The data are
integer-valued, so every fp32 distance is exact and results agree bit for
bit; the segments' norm stats are float64 norms taken on another device
and may differ in the last bit (held to 1e-12 relative).

Then the JAX package's own lifecycle invariants, held on the port on the
CPU: appends equal a one-shot build, open restores the committed state,
compaction equals a rebuild, delete equals a rebuild without the rows,
crash and failure safety, the guards, ``read_rows``, the incremental
compaction policy, ``gc`` and the zero-live-segment prune.
"""

import json
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro_torch.index.lifecycle as lifecycle_mod
from repro.core.tree import build_tree as j_build_tree
from repro.index import Index as JIndex
from repro_torch import batch_search, build_index, interop
from repro_torch.data import synth
from repro_torch.index import CompactionPolicy, Index, has_index
from repro_torch.index import manifest as manifest_lib
from repro_torch.obs import get_registry, set_registry

DIM = 24
N = 3000
SPLIT = 1300
K = 5
DEAD = np.concatenate([np.arange(7), [SPLIT - 1, SPLIT, N - 1],
                       np.arange(100, 3000, 97)])


def _mesh():
    return Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def corpus():
    x, _ = synth.sample_descriptors(N, DIM, seed=0, n_centers=50)
    jt = j_build_tree(jnp.asarray(x), (8, 4), key=jax.random.PRNGKey(1))
    tt = interop.tree_from_numpy([np.asarray(lvl) for lvl in jt.levels],
                                 device="cpu")
    # integer-valued queries near corpus rows: exact fp32 distances
    q = x[:80] + np.random.default_rng(2).integers(
        -3, 4, size=(80, DIM)).astype(np.float32)
    return x, jt, tt, q


@pytest.fixture(autouse=True)
def _fresh_registry():
    prev = set_registry(None)
    yield
    set_registry(prev)


def _grow(idx, x):
    idx.append(x[:SPLIT])
    idx.append(x[SPLIT:])
    idx.commit()
    return idx


def _same(a_ids, a_dists, b):
    np.testing.assert_array_equal(np.asarray(a_ids), b.ids.cpu().numpy())
    np.testing.assert_array_equal(np.asarray(a_dists), b.dists.cpu().numpy())


# ---------------------------------------------------------------------------
# cross-reading
# ---------------------------------------------------------------------------

WIRES = {"float32": (jnp.float32, torch.float32),
         "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SEARCHES = [("point_major", 1), ("point_major", 2), ("query_routed", 1),
            ("query_routed", 2), ("scan_codes", 1), ("scan_codes", 2)]


def _history(idx, x):
    """The directory both packages write: two appends, a delete, codes."""
    _grow(idx, x)
    idx.delete(DEAD)
    idx.commit()
    idx.enable_codes(m=4, bits=4)
    idx.commit()
    return idx


@pytest.fixture(scope="module", params=sorted(WIRES))
def both(request, corpus, tmp_path_factory):
    """(wire, reference handle, its dir, port handle, its dir)."""
    x, jt, tt, _ = corpus
    jw, tw = WIRES[request.param]
    root = tmp_path_factory.mktemp(f"cross_{request.param}")
    jd, td = str(root / "ref"), str(root / "port")
    ji = _history(JIndex.create(jt, jd, mesh=_mesh(), wire_dtype=jw), x)
    ti = _history(Index.create(tt, td, device="cpu", wire_dtype=tw), x)
    return request.param, ji, jd, ti, td


@pytest.mark.parametrize("layout,probes", SEARCHES)
def test_port_opens_reference_directory(both, corpus, layout, probes):
    _, ji, jd, _, _ = both
    q = corpus[3]
    ti = Index.open(jd, device="cpu")
    assert (ti.version, ti.n_segments, ti.rows) == (ji.version, ji.n_segments,
                                                    ji.rows)
    assert ti.wire_dtype == WIRES[both[0]][1]
    np.testing.assert_array_equal(ti.tombstones, ji.tombstones)
    jr = ji.search(q, k=K, layout=layout, probes=probes)
    tr = ti.search(q, k=K, layout=layout, probes=probes)
    _same(jr.ids, jr.dists, tr)
    assert float(jr.pairs) == float(tr.pairs)
    assert int(jr.q_cap_overflow) == int(tr.q_cap_overflow) == 0


@pytest.mark.parametrize("layout,probes", SEARCHES)
def test_reference_opens_port_directory(both, corpus, layout, probes):
    _, _, _, ti, td = both
    q = corpus[3]
    ji = JIndex.open(td, mesh=_mesh())
    assert (ji.version, ji.n_segments, ji.rows) == (ti.version, ti.n_segments,
                                                    ti.rows)
    jr = ji.search(q, k=K, layout=layout, probes=probes)
    tr = ti.search(q, k=K, layout=layout, probes=probes)
    _same(jr.ids, jr.dists, tr)
    assert float(jr.pairs) == float(tr.pairs)


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


def test_directories_hold_identical_bytes(both):
    """Same file names; every array file byte-identical (so its crc32
    too); every JSON with the same keys and values, the norm stats within
    1e-12 relative; the segment manifests' crc32s equal the files'."""
    _, _, jd, _, td = both
    assert _files(jd) == _files(td)
    for rel in _files(jd):
        a = open(os.path.join(jd, rel), "rb").read()
        b = open(os.path.join(td, rel), "rb").read()
        if rel.endswith(".json"):
            _close_json(json.loads(a), json.loads(b), rel)
        else:
            assert a == b, rel
    for rel in _files(td):
        if rel.endswith("manifest.json") and "step_" in rel:
            step = os.path.dirname(os.path.join(td, rel))
            man = json.load(open(os.path.join(td, rel)))
            for meta in man["leaves"].values():
                raw = np.load(os.path.join(step, meta["file"]))
                assert zlib.crc32(raw.tobytes()) == meta["crc32"]


# ---------------------------------------------------------------------------
# the reference's invariants, on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def oneshot(corpus):
    x, _, tt, _ = corpus
    return build_index(x, tt, wire_dtype=torch.float32, device="cpu")


def _ref_search(index, corpus, layout="point_major", probes=1, q_cap=512):
    _, _, tt, q = corpus
    return batch_search(index, tt, q, K, layout=layout, probes=probes,
                        q_cap=q_cap if layout == "point_major" else None,
                        device="cpu")


@pytest.mark.parametrize("layout,impl", [
    ("point_major", "xla"), ("point_major", "pallas"), ("point_major", "fused"),
    ("query_routed", "xla"), ("query_routed", "pallas")])
def test_append_search_bit_identical_to_oneshot(corpus, oneshot, tmp_path,
                                                layout, impl):
    x, _, tt, q = corpus
    idx = _grow(Index.create(tt, str(tmp_path / "idx"), device="cpu"), x)
    assert idx.n_segments == 2 and idx.rows == N
    for probes in (1, 2):
        res = idx.search(q, k=K, layout=layout, probes=probes, impl=impl,
                         q_cap=512 if layout == "point_major" else None)
        ref = _ref_search(oneshot, corpus, layout, probes)
        assert int(res.q_cap_overflow) == 0 == int(ref.q_cap_overflow)
        _same(ref.ids.numpy(), ref.dists.numpy(), res)


def test_from_built_wraps_one_segment(corpus, oneshot):
    idx = Index.from_built(oneshot, corpus[2])
    assert idx.n_segments == 1 and idx.rows == N and idx.version == 1
    res = idx.search(corpus[3], k=K, layout="point_major", q_cap=512)
    ref = _ref_search(oneshot, corpus)
    _same(ref.ids.numpy(), ref.dists.numpy(), res)


def test_open_restores_committed_state(corpus, oneshot, tmp_path):
    x, _, tt, q = corpus
    d = str(tmp_path / "idx")
    _grow(Index.create(tt, d, device="cpu"), x)
    idx = Index.open(d, device="cpu")
    assert idx.n_segments == 2 and idx.rows == N and idx.version == 1
    res = idx.search(q, k=K, layout="point_major", q_cap=512)
    ref = _ref_search(oneshot, corpus)
    _same(ref.ids.numpy(), ref.dists.numpy(), res)


def test_compact_matches_oneshot_arrays(corpus, oneshot, tmp_path):
    x, _, tt, q = corpus
    idx = _grow(Index.create(tt, str(tmp_path / "idx"), device="cpu"), x)
    before = idx.search(q, k=K, layout="point_major", q_cap=512)
    name = idx.compact()
    assert idx.n_segments == 1 and idx.rows == N
    seg = idx.segments[0]
    assert seg.name == name
    for f in ("vecs", "ids", "leaves", "offsets", "n_valid"):
        assert torch.equal(getattr(seg.index, f), getattr(oneshot, f)), f
    after = idx.search(q, k=K, layout="point_major", q_cap=512)
    _same(before.ids.numpy(), before.dists.numpy(), after)
    seg_dir = tmp_path / "idx" / manifest_lib.SEGMENTS_SUBDIR
    assert sorted(os.listdir(seg_dir)) == [name]


@pytest.mark.parametrize("layout", ["point_major", "query_routed"])
def test_delete_matches_rebuild_without_rows(corpus, tmp_path, layout):
    x, _, tt, q = corpus
    idx = _grow(Index.create(tt, str(tmp_path / "idx"), device="cpu"), x)
    dead = np.concatenate([np.arange(7), [SPLIT - 1, SPLIT, N - 1]])
    assert idx.delete(dead) == len(dead)
    assert idx.delete(dead) == 0  # idempotent: already tombstoned
    assert idx.delete([10**6]) == 0  # absent ids are not recorded
    assert idx.rows == N - len(dead)
    keep = ~np.isin(np.arange(N), dead)
    rebuilt = build_index(x[keep], tt, ids=np.flatnonzero(keep).astype(np.int32),
                          wire_dtype=torch.float32, device="cpu")
    ref = _ref_search(rebuilt, corpus, layout)
    for impl in ("xla", "fused") if layout == "point_major" else ("xla",):
        res = idx.search(q, k=K, layout=layout, impl=impl,
                         q_cap=512 if layout == "point_major" else None)
        _same(ref.ids.numpy(), ref.dists.numpy(), res)
    idx.commit()
    idx.compact()
    assert idx.rows == N - len(dead) and len(idx.tombstones) == 0
    for f in ("vecs", "ids", "leaves", "offsets"):
        assert torch.equal(getattr(idx.segments[0].index, f),
                           getattr(rebuilt, f)), f
    res2 = idx.search(q, k=K, layout=layout,
                      q_cap=512 if layout == "point_major" else None)
    _same(ref.ids.numpy(), ref.dists.numpy(), res2)


def test_crash_between_append_and_commit_is_invisible(corpus, tmp_path):
    x, _, tt, _ = corpus
    d = str(tmp_path / "idx")
    idx = Index.create(tt, d, device="cpu")
    idx.append(x[:SPLIT])
    v1 = idx.commit()
    dying = Index.open(d, device="cpu")
    orphan = dying.append(x[SPLIT:])
    del dying
    assert orphan in os.listdir(os.path.join(d, manifest_lib.SEGMENTS_SUBDIR))
    reopened = Index.open(d, device="cpu")
    assert reopened.version == v1 and reopened.n_segments == 1
    assert reopened.rows == SPLIT
    retried = reopened.append(x[SPLIT:])
    assert retried != orphan
    reopened.commit()
    final = Index.open(d, device="cpu")
    assert final.n_segments == 2 and final.rows == N


def test_failed_commit_stays_staged_and_retries(corpus, tmp_path, monkeypatch):
    x, _, tt, _ = corpus
    d = str(tmp_path / "idx")
    idx = Index.create(tt, d, device="cpu")
    idx.append(x[:SPLIT])

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(manifest_lib, "write", boom)
    with pytest.raises(OSError):
        idx.commit()
    monkeypatch.undo()
    assert idx.version == 0 and idx.staged_segments
    assert idx.commit() == 1
    assert Index.open(d, device="cpu").rows == SPLIT


def test_failed_compact_preserves_tombstones(corpus, tmp_path, monkeypatch):
    x, _, tt, q = corpus
    idx = _grow(Index.create(tt, str(tmp_path / "idx"), device="cpu"), x)
    idx.delete(np.arange(5))
    idx.commit()

    def boom(*a, **kw):
        raise RuntimeError("device OOM")

    monkeypatch.setattr(lifecycle_mod, "build_index", boom)
    with pytest.raises(RuntimeError):
        idx.compact()
    monkeypatch.undo()
    assert len(idx.tombstones) == 5 and idx.n_segments == 2
    ids = idx.search(q[:8], k=K, q_cap=512).ids.numpy()
    assert not np.isin(ids, np.arange(5)).any()
    idx.compact()
    assert idx.rows == N - 5


def test_concurrent_commit_loses_loudly_not_silently(corpus, tmp_path):
    x, _, tt, _ = corpus
    d = str(tmp_path / "idx")
    Index.create(tt, d, device="cpu")
    a = Index.open(d, device="cpu")
    b = Index.open(d, device="cpu")
    a.append(x[:100])
    b.append(x[100:200])
    assert a.commit() == 1
    with pytest.raises(FileExistsError, match="committed concurrently"):
        b.commit()
    assert Index.open(d, device="cpu").rows == 100
    assert b.staged_segments


def test_double_commit_is_idempotent(corpus, tmp_path):
    x, _, tt, _ = corpus
    d = str(tmp_path / "idx")
    idx = _grow(Index.create(tt, d, device="cpu"), x)
    v = idx.version
    files = sorted(os.listdir(d))
    assert idx.commit() == v
    assert idx.commit() == v
    assert sorted(os.listdir(d)) == files
    assert manifest_lib.list_versions(d) == [0, v]


def test_create_open_guards(corpus, tmp_path):
    _, _, tt, q = corpus
    d = str(tmp_path / "idx")
    assert not has_index(d)
    idx = Index.create(tt, d, device="cpu")
    assert has_index(d)
    with pytest.raises(FileExistsError):
        Index.create(tt, d, device="cpu")
    with pytest.raises(FileNotFoundError):
        Index.open(str(tmp_path / "nope"), device="cpu")
    res = idx.search(q[:4], k=3)
    assert (res.ids == -1).all() and torch.isinf(res.dists).all()
    # overwrite clears the old index's artifacts
    Index.create(tt, d, device="cpu", overwrite=True)
    assert manifest_lib.list_versions(d) == [0]


def test_legacy_format_dir_fails_actionably(tmp_path):
    d = tmp_path / "legacy"
    (d / "index_ckpt").mkdir(parents=True)
    assert not has_index(str(d))
    with pytest.raises(FileNotFoundError, match="pre-segment-format"):
        Index.open(str(d), device="cpu")


def test_append_id_validation(corpus):
    x, _, tt, _ = corpus
    idx = Index.create(tt, None, device="cpu")
    idx.append(x[:100])  # auto ids 0..99
    with pytest.raises(ValueError, match="collide"):
        idx.append(x[100:200], ids=np.arange(50, 150))
    with pytest.raises(ValueError, match="duplicate"):
        idx.append(x[100:200], ids=np.zeros(100, np.int64) + 500)
    with pytest.raises(ValueError, match="non-negative"):
        idx.append(x[100:200], ids=np.arange(-1, 99))
    idx.append(x[100:200])  # auto ids continue at 100
    assert idx.next_id == 200
    with pytest.raises(ValueError, match="int32"):
        idx.append(x[:4], ids=np.array([N, N + 1, N + 2, 2**31]))


def test_read_rows_by_descriptor_id(corpus, tmp_path):
    x, _, tt, _ = corpus
    idx = _grow(Index.create(tt, str(tmp_path / "idx"), device="cpu"), x)
    rows = np.array([2999, 0, 1300, 1299, 0])  # cross-segment, dups, order
    np.testing.assert_array_equal(idx.read_rows(rows).numpy(), x[rows])
    with pytest.raises(IndexError, match="not in the index"):
        idx.read_rows([N + 5])
    with pytest.raises(IndexError, match=">= 0"):
        idx.read_rows([-1])
    idx.delete([1300])
    with pytest.raises(IndexError, match="absent or deleted"):
        idx.read_rows(rows)
    assert idx.read_rows([]).shape == (0, DIM)


def test_incremental_compaction_policy_and_gc(corpus, tmp_path):
    x, _, tt, q = corpus
    d = str(tmp_path / "idx")
    idx = Index.create(tt, d, device="cpu")
    for lo, hi in ((0, 1400), (1400, 2800), (2800, 2960), (2960, 3000)):
        idx.append(x[lo:hi], ids=np.arange(lo, hi))
        idx.commit()
    pol = CompactionPolicy()
    assert [s.valid_rows for s in pol.select(idx.segments, idx.tombstones)] \
        == [160, 40]
    before = idx.search(q, k=K, layout="point_major", probes=2)
    merged = idx.compact(incremental=True, policy=pol)
    assert sorted(s.valid_rows for s in idx.segments) == [200, 1400, 1400]
    v = idx.version
    assert idx.compact(incremental=True, policy=pol) is None  # fixed point
    assert idx.version == v
    # a tombstone-heavy segment is reclaimed in one step; its neighbours'
    # tombstones survive
    idx.delete(np.arange(1400, 2400))
    idx.delete([5])
    idx.commit()
    mid = idx.search(q, k=K, layout="point_major", probes=2)
    names = [s.name for s in idx.segments]
    merged2 = idx.compact(incremental=True)
    assert merged2 is not None and names[1] not in [s.name for s in idx.segments]
    assert merged in [s.name for s in idx.segments]
    np.testing.assert_array_equal(idx.tombstones, [5])
    after = idx.search(q, k=K, layout="point_major", probes=2)
    _same(mid.ids.numpy(), mid.dists.numpy(), after)
    assert not torch.equal(before.ids, mid.ids)  # the deletes showed
    # gc: a dead writer's orphan and the superseded manifests go
    other = Index.open(d, device="cpu")
    other.append(x[:100], ids=np.arange(3000, 3100))
    del other
    fresh = Index.open(d, device="cpu")
    report = fresh.gc(dry_run=True)
    assert report["manifests"] and report["segments"]
    assert fresh.gc() == report
    assert fresh.gc(dry_run=True) == {"manifests": [], "segments": [],
                                      "tombstones": [], "codes": [], "tmp": []}
    _same(after.ids.numpy(), after.dists.numpy(),
          Index.open(d, device="cpu").search(q, k=K, layout="point_major",
                                             probes=2))


def test_zero_live_segment_pruned_result_identical(corpus, tmp_path):
    x, _, tt, q = corpus
    idx = _grow(Index.create(tt, str(tmp_path / "idx"), device="cpu"), x)
    idx.delete(np.arange(SPLIT, N))  # all of the second segment
    idx.commit()
    res = idx.search(q, k=K, layout="point_major", q_cap=512)
    assert get_registry().counter("index.segments_pruned").value >= 1
    assert not np.isin(res.ids.numpy(), np.arange(SPLIT, N)).any()
    keep = np.arange(SPLIT)
    rebuilt = build_index(x[keep], tt, ids=keep.astype(np.int32),
                          wire_dtype=torch.float32, device="cpu")
    ref = _ref_search(rebuilt, corpus)
    _same(ref.ids.numpy(), ref.dists.numpy(), res)


def test_snapshot_is_a_consistent_cut(corpus):
    x, _, tt, q = corpus
    idx = _grow(Index.create(tt, None, device="cpu"), x)
    snap = idx.snapshot()
    idx.delete(np.arange(50))
    assert snap.tombstones.size == 0 and idx.stamp > snap.stamp
    rows = idx.read_rows(np.arange(10), segments=snap.segments,
                         tombstones=snap.tombstones)
    np.testing.assert_array_equal(rows.numpy(), x[:10])


def test_auto_layout_equals_the_plan_it_picks(corpus, tmp_path):
    x, _, tt, q = corpus
    idx = _grow(Index.create(tt, str(tmp_path / "idx"), device="cpu"), x)
    from repro_torch.core.engine import plan as make_plan

    p = make_plan(rows=idx.segments[0].rows, n_leaves=idx.n_leaves,
                  n_queries=q.shape[0], n_shards=1, k=K, layout="auto",
                  calibration=idx.calibration)
    a = idx.search(q, k=K)
    b = idx.search(q, k=K, layout=p.layout, impl=p.impl)
    _same(b.ids.numpy(), b.dists.numpy(), a)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_index_lifecycle_matches_cpu(corpus, cuda, tmp_path):
    """The lifecycle on the card: grow, delete, commit, reopen, compact and
    codes, each search equal to the CPU index's bit for bit."""
    x, _, tt, q = corpus
    tc = interop.tree_from_numpy([lvl.numpy() for lvl in tt.levels], device=cuda)
    cpu = _history(Index.create(tt, str(tmp_path / "cpu"), device="cpu"), x)
    gpu = _history(Index.create(tc, str(tmp_path / "gpu"), device=cuda), x)
    gpu = Index.open(str(tmp_path / "gpu"), device=cuda)
    for layout, probes in SEARCHES:
        for impl in ("pallas", "fused") if layout != "query_routed" else ("xla",):
            a = cpu.search(q, k=K, layout=layout, probes=probes, impl=impl)
            b = gpu.search(q, k=K, layout=layout, probes=probes, impl=impl)
            _same(a.ids.numpy(), a.dists.numpy(), b)
            assert float(a.pairs) == float(b.pairs)
    cpu.compact()
    gpu.compact()
    for f in ("vecs", "ids", "leaves", "offsets"):
        assert torch.equal(getattr(cpu.segments[0].index, f),
                           getattr(gpu.segments[0].index, f).cpu()), f
