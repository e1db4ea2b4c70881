"""Immutable index segments.

A segment is one cluster-sorted :class:`~repro_torch.core.index_build.
DistributedIndex` -- the output of one ``append`` (or of a compaction) --
persisted as one checkpoint in the JAX package's format
(:mod:`repro_torch.distributed.checkpoint`): the arrays ``index/0`` ..
``index/5`` are the index's ``(vecs, ids, leaves, offsets, n_valid,
overflow)``, the order in which the JAX package's ``DistributedIndex``
flattens, so either package reads the other's segments. Segments are
written once and never mutated; deletions are tombstones in the manifest,
applied as a mask at search time (:func:`masked_view`).

The segment lives on its index's device, and so do the id index
(:meth:`Segment.id_index`) and the masking; only per-segment stats (id
range, norm range) live on the host.
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np
import torch

from repro_torch.core.index_build import DistributedIndex
from repro_torch.distributed.checkpoint import CheckpointManager

_SEGMENT_RE = re.compile(r"^seg_(\d{6})$")

#: the checkpoint names of a DistributedIndex's arrays, in the order the
#: JAX package's pytree flattens it
INDEX_FIELDS = ("vecs", "ids", "leaves", "offsets", "n_valid", "overflow")
INDEX_KEYS = tuple(f"index/{i}" for i in range(len(INDEX_FIELDS)))

#: rows per chunk of the norm pass (bounds its float64 temporary)
_NORM_CHUNK = 1 << 20


def segment_name(seq: int) -> str:
    return f"seg_{seq:06d}"


def next_seq(segments_dir: str) -> int:
    """1 + the highest segment sequence number present on disk -- committed
    or orphaned. Orphans (crash between append and commit) keep their name
    reserved so a retried append never collides with them."""
    if not os.path.isdir(segments_dir):
        return 1
    seqs = [
        int(m.group(1))
        for name in os.listdir(segments_dir)
        if (m := _SEGMENT_RE.match(name))
    ]
    return max(seqs, default=0) + 1


def _norm_range(vecs: torch.Tensor, valid: torch.Tensor) -> tuple[float, float]:
    """(min, max) L2 norm of the valid rows, in float64 on the rows'
    device, in chunks of rows."""
    lo = torch.tensor(np.inf, dtype=torch.float64, device=vecs.device)
    hi = torch.tensor(-np.inf, dtype=torch.float64, device=vecs.device)
    for s in range(0, vecs.shape[0], _NORM_CHUNK):
        n = torch.linalg.vector_norm(vecs[s:s + _NORM_CHUNK].double(), dim=1)
        ok = valid[s:s + _NORM_CHUNK]
        lo = torch.minimum(lo, torch.where(ok, n, np.inf).min())
        hi = torch.maximum(hi, torch.where(ok, n, -np.inf).max())
    return float(lo), float(hi)


@dataclasses.dataclass
class Segment:
    """One immutable segment plus its static stats."""

    name: str
    index: DistributedIndex
    rows: int  # padded row count (index.rows)
    valid_rows: int  # rows with a real descriptor id
    min_id: int  # -1 when empty
    max_id: int  # -1 when empty
    # L2 norm range of the valid rows -- the dense-tier pruning bound.
    # -1.0 = unknown (or empty); pruning is skipped for such segments.
    min_norm: float = -1.0
    max_norm: float = -1.0
    _id_index: object = dataclasses.field(default=None, repr=False,
                                          compare=False)

    def id_index(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Cached ``(sorted_ids, row_order)`` int64 tensors on the
        segment's device, for id -> row probes. Padding ``-1`` ids sort
        first and never match a probed (non-negative) id."""
        if self._id_index is None:
            self._id_index = torch.sort(self.index.ids.long(), stable=True)
        return self._id_index

    def find(self, ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(hit, row)`` for int64 ``ids`` on the segment's device: whether
        each id lives here, and its row (meaningful where ``hit``)."""
        sorted_ids, order = self.id_index()
        pos = torch.searchsorted(sorted_ids, ids)
        at = pos.clamp(max=sorted_ids.numel() - 1)
        hit = (pos < sorted_ids.numel()) & (sorted_ids[at] == ids)
        return hit, order[at]

    def overlaps(self, ids: np.ndarray) -> bool:
        """Can any of ``ids`` (non-empty) live in this segment?"""
        return (
            self.valid_rows > 0
            and int(ids.min()) <= self.max_id
            and int(ids.max()) >= self.min_id
        )

    @classmethod
    def from_built(cls, name: str, index: DistributedIndex) -> "Segment":
        valid = index.ids >= 0
        n = int(valid.sum())
        if n:
            min_norm, max_norm = _norm_range(index.vecs, valid)
            min_id = int(torch.where(valid, index.ids, torch.iinfo(torch.int32).max).min())
            max_id = int(index.ids.max())
        else:
            min_norm = max_norm = -1.0
            min_id = max_id = -1
        return cls(name=name, index=index, rows=int(index.rows), valid_rows=n,
                   min_id=min_id, max_id=max_id, min_norm=min_norm,
                   max_norm=max_norm)

    @property
    def n_shards(self) -> int:
        return int(self.index.offsets.shape[0])

    def stats(self) -> dict:
        return {
            "name": self.name,
            "rows": self.rows,
            "valid_rows": self.valid_rows,
            "min_id": self.min_id,
            "max_id": self.max_id,
            "min_norm": self.min_norm,
            "max_norm": self.max_norm,
            "n_shards": self.n_shards,
        }

    # -- persistence --------------------------------------------------------
    def save(self, segments_dir: str) -> str:
        mgr = CheckpointManager(os.path.join(segments_dir, self.name), keep=1)
        return mgr.save(
            0,
            {key: getattr(self.index, f)
             for key, f in zip(INDEX_KEYS, INDEX_FIELDS)},
            extra=dict(
                self.stats(),
                n_leaves=int(self.index.n_leaves),
                dim=int(self.index.vecs.shape[-1]),
            ),
        )

    @classmethod
    def load(cls, segments_dir: str, name: str, device) -> "Segment":
        """Restore segment ``name`` onto ``device``, every file crc-checked."""
        mgr = CheckpointManager(os.path.join(segments_dir, name), keep=1)
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"segment {name} has no complete checkpoint under "
                f"{segments_dir}"
            )
        arrays, manifest = mgr.restore(INDEX_KEYS, step, device=device)
        meta = manifest["extra"]
        fields = {f: arrays[key] for key, f in zip(INDEX_KEYS, INDEX_FIELDS)}
        fields["vecs"] = fields["vecs"].float().contiguous()
        for f in INDEX_FIELDS[1:]:
            fields[f] = fields[f].to(torch.int32)
        index = DistributedIndex(**fields, n_leaves=int(meta["n_leaves"]))
        return cls(
            name=name,
            index=index,
            rows=int(meta["rows"]),
            valid_rows=int(meta["valid_rows"]),
            min_id=int(meta.get("min_id", -1)),
            max_id=int(meta.get("max_id", -1)),
            min_norm=float(meta.get("min_norm", -1.0)),
            max_norm=float(meta.get("max_norm", -1.0)),
        )


def tombstone_hits(segment: Segment, tombstones: np.ndarray) -> torch.Tensor:
    """(rows,) bool on the segment's device: the rows whose id is in the
    sorted ``tombstones``."""
    ids = segment.index.ids.long()
    ts = torch.as_tensor(tombstones, dtype=torch.int64, device=ids.device)
    pos = torch.searchsorted(ts, ids)
    return (pos < ts.numel()) & (ts[pos.clamp(max=ts.numel() - 1)] == ids)


def dead_counts(segments, tombstones: np.ndarray) -> np.ndarray:
    """Per-segment count of valid rows killed by ``tombstones`` (a sorted
    array of unique ids -- each id lives in exactly one segment, so the
    counts partition the tombstone set). Feeds the compaction policy's
    tombstone-ratio trigger and the search-time zero-live-segment prune.
    """
    out = np.zeros(len(segments), np.int64)
    ts = np.asarray(tombstones, np.int64)
    if ts.size == 0:
        return out
    for i, seg in enumerate(segments):
        if not seg.overlaps(ts):
            continue
        sorted_ids, _ = seg.id_index()
        probe = torch.as_tensor(ts, device=sorted_ids.device)
        pos = torch.searchsorted(sorted_ids, probe)
        at = pos.clamp(max=sorted_ids.numel() - 1)
        out[i] = int(((pos < sorted_ids.numel())
                      & (sorted_ids[at] == probe)).sum())
    return out


# Tombstoned rows keep their leaf (CSR offsets stay valid, and the leaves
# stay sorted, as the kernels need) but get this magnitude written into
# every vector lane: the partial distance ||p||^2 - 2 p.q becomes ~1e32 at
# d = 128 -- finite, yet far above any real candidate, so a dead row never
# displaces a live neighbour from a tile's top-k. Its id is -1, so when it
# *is* selected (a leaf with fewer than k live rows) the scan masks it to
# -1 / inf -- exactly a padding row's fate. The JAX package's value.
TOMBSTONE_VEC = 1e15


def masked_view(segment: Segment, tombstones: np.ndarray) -> DistributedIndex:
    """The segment's index with tombstoned rows masked out of every scan.

    Bit-identical to rebuilding without the dead rows: live rows'
    distances are untouched, dead rows sort behind every live candidate,
    and a selected dead row degenerates to the ``-1``/``inf`` slot an
    absent row would have produced. The segment is copied (on its device)
    only when a tombstone falls inside its id range.
    """
    if tombstones.size == 0 or segment.valid_rows == 0:
        return segment.index
    lo = np.searchsorted(tombstones, segment.min_id)
    hi = np.searchsorted(tombstones, segment.max_id, side="right")
    if lo == hi:
        return segment.index  # no tombstone inside this segment's id range
    hit = tombstone_hits(segment, tombstones[lo:hi])
    index = segment.index
    vecs = index.vecs.clone()
    vecs[hit] = TOMBSTONE_VEC
    return dataclasses.replace(
        index, ids=torch.where(hit, -1, index.ids).to(torch.int32), vecs=vecs)
