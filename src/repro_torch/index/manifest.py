"""Versioned index manifests: the commit log of a segment-based index.

The JAX package's ``index/manifest.py``, ported as it is (numpy and the
standard library only), so that either package reads the other's index.

A manifest is one JSON file, ``MANIFEST-<version>.json``, naming the exact
set of committed segments, the current tombstone file, and the id
allocator's high-water mark. Commits follow the CheckpointManager pattern
(write ``*.tmp``, then one atomic ``os.replace``), so a crash mid-commit
leaves at worst an ignorable ``.tmp`` and the previous manifest intact:
``latest()`` always resolves to the highest *complete* version. Segment
checkpoints and tombstone files are written *before* the manifest that
references them — an interrupted ``append``/``delete`` leaves orphan files
that no manifest names and that ``Index.open`` therefore never sees.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

import numpy as np

_MANIFEST_RE = re.compile(r"^MANIFEST-(\d{6})\.json$")

SEGMENTS_SUBDIR = "segments"
TOMBSTONES_SUBDIR = "tombstones"
TREE_SUBDIR = "tree"
CODES_SUBDIR = "codes"

FORMAT_VERSION = 1


@dataclasses.dataclass
class Manifest:
    """One committed state of the index."""

    version: int
    segments: list[str]  # committed segment names, append order
    tombstones: str | None  # relative path of the tombstone .npy, if any
    next_id: int  # id allocator high-water mark
    meta: dict  # user extra + static structure (fanouts, dim, ...)
    # serialized index.sharding.ShardPlan (scatter-gather serving);
    # absent on pre-sharding manifests, so from_json defaults it
    shard_plan: dict | None = None
    # serialized core.engine.costmodel.CalibrationStore (measured
    # ms/image per plan signature, the cost-model calibration data);
    # versioned like shard_plan — absent on pre-calibration manifests
    calibration: dict | None = None
    # compressed-codes tier (codes/): the serialized ProductQuantizer
    # plus per-segment relative paths of the uint8 code files; versioned
    # like shard_plan — absent on pre-codes manifests and on indexes that
    # never called enable_codes
    codes: dict | None = None

    def to_json(self) -> dict:
        return {
            "format": FORMAT_VERSION,
            "version": self.version,
            "segments": list(self.segments),
            "tombstones": self.tombstones,
            "next_id": int(self.next_id),
            "meta": dict(self.meta),
            "shard_plan": self.shard_plan,
            "calibration": self.calibration,
            "codes": self.codes,
        }

    @classmethod
    def from_json(cls, d: dict) -> "Manifest":
        return cls(
            version=int(d["version"]),
            segments=list(d["segments"]),
            tombstones=d.get("tombstones"),
            next_id=int(d.get("next_id", 0)),
            meta=dict(d.get("meta", {})),
            shard_plan=d.get("shard_plan"),
            calibration=d.get("calibration"),
            codes=d.get("codes"),
        )


def manifest_path(directory: str, version: int) -> str:
    return os.path.join(directory, f"MANIFEST-{version:06d}.json")


def list_versions(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _MANIFEST_RE.match(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def latest(directory: str) -> Manifest | None:
    """The highest complete (parseable) manifest, or ``None``.

    A truncated manifest cannot exist under the exclusive-link protocol,
    but a corrupt one must not take the versions below it down with it —
    walk downward to the newest readable state. Only corruption (bad
    JSON/fields) and concurrent removal are tolerated; other IO errors
    (permissions, EIO) propagate rather than silently serving stale data.
    """
    for version in reversed(list_versions(directory)):
        try:
            with open(manifest_path(directory, version)) as f:
                return Manifest.from_json(json.load(f))
        except (json.JSONDecodeError, KeyError, ValueError,
                FileNotFoundError):
            continue
    return None


def write(directory: str, manifest: Manifest) -> str:
    """Atomically *and exclusively* publish ``manifest``.

    ``os.link`` of the fsynced tmp file is both atomic (the complete file
    appears or nothing does) and exclusive (it fails with
    ``FileExistsError`` if the version was already published) — so two
    handles racing to commit the same next version cannot silently
    overwrite each other's manifest and orphan committed segments; the
    loser gets an error and must re-open. The one benign collision — the
    same handle retrying a commit that crashed *after* the link landed —
    re-publishes identical bytes (``json.dump`` is deterministic over the
    same state) and passes through.
    """
    final = manifest_path(directory, manifest.version)
    tmp = final + ".tmp"
    payload = json.dumps(manifest.to_json(), indent=1)
    with open(tmp, "w") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    try:
        os.link(tmp, final)
    except FileExistsError:
        with open(final) as f:
            if f.read() == payload:
                return final  # same handle retrying an interrupted commit
        raise FileExistsError(
            f"manifest version {manifest.version} already exists in "
            f"{directory} — another handle committed concurrently; reopen "
            "the index and retry"
        ) from None
    finally:
        os.unlink(tmp)
    return final


def write_tombstones(directory: str, version: int, ids: np.ndarray) -> str:
    """Persist the tombstone set for ``version``; returns the relative path.

    Written *before* the manifest that references it — an orphaned file
    from a crashed commit is ignored by every open. Publication is
    exclusive like the manifest's: a losing concurrent committer must not
    clobber the winner's already-linked tombstone file. The one benign
    collision — the same handle retrying a commit whose manifest write
    failed — re-publishes identical bytes and passes through.
    """
    sub = os.path.join(directory, TOMBSTONES_SUBDIR)
    os.makedirs(sub, exist_ok=True)
    payload = np.asarray(sorted(int(i) for i in ids), np.int64)
    rel = os.path.join(TOMBSTONES_SUBDIR, f"ts_{version:06d}.npy")
    final = os.path.join(directory, rel)
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, payload)
        f.flush()
        os.fsync(f.fileno())
    try:
        os.link(tmp, final)
    except FileExistsError:
        if np.array_equal(np.load(final), payload):
            return rel  # same handle retrying an interrupted commit
        raise FileExistsError(
            f"tombstone set for version {version} already exists in "
            f"{directory} with different contents — another handle "
            "committed concurrently; reopen the index and retry"
        ) from None
    finally:
        os.unlink(tmp)
    return rel


def write_codes(directory: str, name: str, codes: np.ndarray) -> str:
    """Persist one segment's ``(rows, m)`` uint8 PQ codes; returns the
    relative path.

    Same durability contract as :func:`write_tombstones`: written *before*
    the manifest that references it, fsynced, published with an exclusive
    ``os.link``. Segment names are never reused (``next_seq`` reserves
    orphans), so the only collision is the same handle retrying an
    interrupted commit — identical bytes pass through.
    """
    sub = os.path.join(directory, CODES_SUBDIR)
    os.makedirs(sub, exist_ok=True)
    payload = np.ascontiguousarray(codes, np.uint8)
    rel = os.path.join(CODES_SUBDIR, f"{name}.npy")
    final = os.path.join(directory, rel)
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, payload)
        f.flush()
        os.fsync(f.fileno())
    try:
        os.link(tmp, final)
    except FileExistsError:
        if np.array_equal(np.load(final), payload):
            return rel  # same handle retrying an interrupted commit
        raise FileExistsError(
            f"codes file for segment {name} already exists in {directory} "
            "with different contents — another handle committed "
            "concurrently; reopen the index and retry"
        ) from None
    finally:
        os.unlink(tmp)
    return rel


def read_codes(directory: str, rel_path: str) -> np.ndarray:
    return np.load(os.path.join(directory, rel_path)).astype(np.uint8)


def read_tombstones(directory: str, rel_path: str | None) -> np.ndarray:
    if not rel_path:
        return np.empty((0,), np.int64)
    return np.load(os.path.join(directory, rel_path)).astype(np.int64)
