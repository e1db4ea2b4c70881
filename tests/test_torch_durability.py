"""Crash-at-every-boundary durability of repro_torch's ``Index``.

``tests/faults.py`` (FaultFS), imported as it is, enumerates every write,
fsync, link, rename and unlink that an operation -- append+commit,
delete+commit, full compact, incremental compact, enable_codes+commit --
performs under the index directory, and crashes at each one in turn.
Reopening the directory must always give exactly the pre-operation or the
post-operation state: the same version, the same published segment set
and the same search results, never a torn hybrid or a resurrected orphan;
and the surviving handle can retry the operation to completion (or learns
from ``FileExistsError`` that its first attempt already landed).
"""

import shutil

import numpy as np
import pytest
import torch

from faults import FaultFS, InjectedFault
from repro_torch import build_tree
from repro_torch.index import Index

DIM = 8
K = 3
_rng = np.random.default_rng(11)
VEC_A = _rng.standard_normal((96, DIM)).astype(np.float32)   # ids 0..95
VEC_B = _rng.standard_normal((64, DIM)).astype(np.float32)   # ids 96..159
VEC_C = _rng.standard_normal((48, DIM)).astype(np.float32)   # ids 160..207
QUERIES = _rng.standard_normal((4, DIM)).astype(np.float32)


def _build_base(d: str) -> None:
    """Two committed segments + committed tombstones over the first
    (24/96 dead: the default policy's tombstone-ratio trigger, so the
    incremental compaction has work)."""
    tree = build_tree(VEC_A, (4, 2), generator=torch.Generator().manual_seed(0),
                      device="cpu")
    idx = Index.create(tree, d, device="cpu")
    idx.append(VEC_A, ids=np.arange(96))
    idx.commit()
    idx.append(VEC_B, ids=np.arange(96, 160))
    idx.commit()
    idx.delete(np.arange(24))
    idx.commit()


@pytest.fixture(scope="module")
def pristine(tmp_path_factory) -> str:
    d = str(tmp_path_factory.mktemp("durability") / "base")
    _build_base(d)
    return d


def _probe(d: str):
    """(version, segment names, search ids, search dists) read fresh from
    disk -- the recovery observer."""
    idx = Index.open(d, device="cpu")
    r = idx.search(QUERIES, k=K)
    return (idx.version, tuple(s.name for s in idx.segments),
            r.ids.numpy().copy(), r.dists.numpy().copy())


# Each op takes (idx, ctx); ctx makes the staging half idempotent, so a
# retry after a crash mid-staging does not append twice.
def _op_append(idx, ctx):
    if not ctx.get("appended"):
        idx.append(VEC_C, ids=np.arange(160, 208))
        ctx["appended"] = True
    idx.commit()


def _op_delete(idx, ctx):
    idx.delete(np.arange(100, 140))  # idempotent by contract
    idx.commit()


def _op_compact_full(idx, ctx):
    idx.compact()


def _op_compact_incremental(idx, ctx):
    idx.compact(incremental=True)


def _op_enable_codes(idx, ctx):
    if not ctx.get("enabled"):
        idx.enable_codes(m=2, bits=4, seed=0)
        ctx["enabled"] = True
    idx.commit()


OPS = {
    "append": _op_append,
    "delete": _op_delete,
    "compact_full": _op_compact_full,
    "compact_incremental": _op_compact_incremental,
    "enable_codes": _op_enable_codes,
}


@pytest.mark.parametrize("opname", sorted(OPS))
def test_crash_at_every_write_boundary(pristine, tmp_path, opname):
    op = OPS[opname]
    pre = _probe(pristine)
    post_dir = str(tmp_path / "post")
    shutil.copytree(pristine, post_dir)
    op(Index.open(post_dir, device="cpu"), {})
    post = _probe(post_dir)
    assert post[0] > pre[0], "the op must publish a new version"

    count_dir = str(tmp_path / "count")
    shutil.copytree(pristine, count_dir)
    with FaultFS(count_dir) as fs:
        op(Index.open(count_dir, device="cpu"), {})
    boundaries = list(fs.boundaries)
    assert len(boundaries) >= 4, boundaries

    for i, bound in enumerate(boundaries):
        work = str(tmp_path / f"crash_{i}")
        shutil.copytree(pristine, work)
        idx = Index.open(work, device="cpu")
        ctx: dict = {}
        crashed = True
        with FaultFS(work, fail_at=i) as fs:
            try:
                op(idx, ctx)
                crashed = False
            except InjectedFault:
                pass
        assert fs.fired, (i, bound)
        if not crashed:
            # the boundary sat in a best-effort cleanup after publication
            got = _probe(work)
            assert got[0] == post[0] and got[1] == post[1], (i, bound)
            assert np.array_equal(got[2], post[2]), (i, bound)
            shutil.rmtree(work)
            continue
        got = _probe(work)
        if got[0] == pre[0]:
            ref = pre
        elif got[0] == post[0]:
            ref = post
        else:
            pytest.fail(f"boundary {i} ({bound}): reopened v{got[0]}, "
                        f"want v{pre[0]} or v{post[0]}")
        assert got[1] == ref[1], (i, bound)
        assert np.array_equal(got[2], ref[2]), (i, bound)
        assert np.array_equal(got[3], ref[3]), (i, bound)
        try:
            op(idx, ctx)
        except FileExistsError:
            assert _probe(work)[0] == post[0], (i, bound)
        after = _probe(work)
        assert after[0] >= post[0], (i, bound)
        assert np.array_equal(after[2], post[2]), (i, bound)
        assert np.array_equal(after[3], post[3]), (i, bound)
        Index.open(work, device="cpu").gc()
        final = _probe(work)
        assert np.array_equal(final[2], post[2]), (i, bound)
        shutil.rmtree(work)


def test_boundary_kinds_cover_publish_protocol(pristine, tmp_path):
    work = str(tmp_path / "kinds")
    shutil.copytree(pristine, work)
    with FaultFS(work) as fs:
        _op_append(Index.open(work, device="cpu"), {})
    kinds = {k for k, _ in fs.boundaries}
    assert {"open", "fsync", "link", "rename", "unlink"} <= kinds, fs.boundaries
