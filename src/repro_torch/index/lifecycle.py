"""The segment-based index lifecycle (paper sections 2.2-2.3 as an API).

The paper's collection *grows between runs*: descriptors are indexed in
grid-sized batches, and every search job runs against whatever index
files exist so far. :class:`Index` is that workflow as one object, the
JAX package's ``index/lifecycle.py`` on one card:

  ``Index.create(tree, dir)``   new index bound to a vocabulary tree
  ``Index.open(dir)``           restore the last committed state
  ``idx.append(vecs, ids)``     ``build_index`` into a new immutable,
                                durably written *segment*
  ``idx.commit()``              atomic manifest bump -- the only operation
                                that makes appends/deletes visible to a
                                later ``open`` (crash-safe, idempotent)
  ``idx.delete(ids)``           tombstones (masked at search, dropped at
                                compaction)
  ``idx.compact()``             merge segments into one, dropping
                                tombstoned rows; commits atomically
  ``idx.search(queries, ...)``  one executor run per segment over one
                                shared lookup build, merged across segments

The directory is the JAX package's format, file for file (manifests,
segment checkpoints, tree, tombstones, codes), so either package opens
what the other wrote. Search over N segments is bit-identical to a
one-shot ``build_index`` + ``batch_search`` over the concatenated rows
(and after ``compact()`` the index arrays themselves match a rebuild).

Everything stays on the index's device (``device=``, the card by
default): segments, their id indexes, tombstone masks, compaction's
gather and ``read_rows``. Only ids, per-segment stats and the running
top-k of the norm-bound pruning come to the host.

A handle sees its own uncommitted writes; a fresh ``open`` sees only the
last committed manifest.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import threading
from typing import Sequence

import numpy as np
import torch

from repro_torch.codes import CODES_FORMAT, ProductQuantizer, rerank_exact
from repro_torch.core.engine.costmodel import CalibrationStore, backend_name
from repro_torch.core.engine.executors import SearchResult
from repro_torch.core.engine.plan import SearchPlan, plan as make_plan
from repro_torch.core.index_build import (
    DistributedIndex,
    MeshIndex,
    build_index,
    index_ids,
    index_rows,
)
from repro_torch.core.lookup import build_lookup
from repro_torch.core.search import search_with_lookup
from repro_torch.core.tree import VocabTree
from repro_torch.device import dtype_name
from repro_torch.distributed.meshutil import DeviceMesh, as_mesh
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.index import manifest as manifest_lib
from repro_torch.index.manifest import Manifest
from repro_torch.index.segment import (
    Segment,
    dead_counts,
    masked_view,
    next_seq,
    segment_name,
    tombstone_hits,
)
from repro_torch.index.sharding import ShardPlan, empty_result
from repro_torch.obs import get_registry, get_tracer

# the pre-segment format (one monolithic checkpoint); detected only to
# fail actionably -- there is no in-place migration
LEGACY_CKPT_SUBDIR = "index_ckpt"

_WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}


def has_legacy_index(directory: str) -> bool:
    return bool(directory) and os.path.isdir(
        os.path.join(directory, LEGACY_CKPT_SUBDIR))


def has_index(directory: str) -> bool:
    """True when ``directory`` holds at least one committed manifest."""
    return bool(directory) and manifest_lib.latest(directory) is not None


def _tree_keys(n_levels: int) -> list[str]:
    """The tree's checkpoint names: the JAX package's ``VocabTree`` flattens
    to ``(levels,)``, so level ``i`` is ``tree/0/<i>``."""
    return [f"tree/0/{i}" for i in range(n_levels)]


def _save_tree(directory: str, tree: VocabTree, meta: dict) -> None:
    mgr = CheckpointManager(
        os.path.join(directory, manifest_lib.TREE_SUBDIR), keep=1)
    mgr.save(0, dict(zip(_tree_keys(len(tree.levels)), tree.levels)),
             extra=meta)


def _load_tree(directory: str, device) -> tuple[VocabTree, dict]:
    mgr = CheckpointManager(
        os.path.join(directory, manifest_lib.TREE_SUBDIR), keep=1)
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no index tree checkpoint under {directory}")
    meta = mgr.read_manifest(step)["extra"]
    keys = _tree_keys(int(meta["n_levels"]))
    arrays, _ = mgr.restore(keys, step, device=device)
    levels = tuple(arrays[key].float().contiguous() for key in keys)
    return VocabTree(levels=levels), meta


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """When an *incremental* compaction step merges which segments.

    ``Index.compact(incremental=True)`` asks the policy for one batch of
    victims per call: first any segment whose dead/valid ratio is at least
    ``tombstone_ratio``; otherwise the smallest size tier (segments whose
    live-row counts sit within ``size_tier_factor`` of the smallest). A
    tier smaller than ``min_tier_segments`` is left alone (a compacted
    index is a fixed point); ``max_segments_per_step`` bounds the rows one
    step rewrites. The JAX package's policy.
    """

    size_tier_factor: float = 4.0
    min_tier_segments: int = 2
    tombstone_ratio: float = 0.25
    max_segments_per_step: int = 8

    def select(self, segments: Sequence[Segment],
               tombstones: np.ndarray) -> list[Segment]:
        """The victims of one incremental step, in index order (possibly
        empty). Pure function of committed state."""
        segments = list(segments)
        if not segments:
            return []
        dead = dead_counts(segments, tombstones)
        heavy = {s.name for s, d in zip(segments, dead)
                 if s.valid_rows and d / s.valid_rows >= self.tombstone_ratio}
        if heavy:
            victims = [s for s in segments if s.name in heavy]
            return victims[: self.max_segments_per_step]
        live = {s.name: int(s.valid_rows - d) for s, d in zip(segments, dead)}
        order = sorted(segments, key=lambda s: (live[s.name], s.name))
        tier = [order[0]]
        for s in order[1:]:
            if live[s.name] <= self.size_tier_factor * max(
                    1, live[tier[0].name]):
                tier.append(s)
            else:
                break
        if len(tier) < self.min_tier_segments:
            return []
        chosen = {s.name for s in tier[: self.max_segments_per_step]}
        return [s for s in segments if s.name in chosen]


@dataclasses.dataclass(frozen=True)
class IndexSnapshot:
    """One consistent, immutable cut of an :class:`Index`'s state: every
    array here is immutable (segments, views) or a private copy
    (tombstones). ``stamp`` is the index's monotone mutation counter."""

    stamp: int
    version: int
    segments: tuple[Segment, ...]
    views: tuple[DistributedIndex, ...]
    tombstones: np.ndarray
    shard_plan: ShardPlan | None
    quantizer: ProductQuantizer | None
    codes: dict


class Index:
    """Segment-based index with a durable lifecycle, on one device or over
    the shards of a mesh (each segment a ``MeshIndex``)."""

    def __init__(
        self,
        directory: str | None,
        tree: VocabTree,
        device=None,
        *,
        mesh: DeviceMesh | None = None,
        segments: Sequence[Segment] = (),
        tombstones: np.ndarray | None = None,
        version: int = 0,
        next_id: int = 0,
        meta: dict | None = None,
        wire_dtype=torch.float32,
        shard_plan: ShardPlan | None = None,
        calibration: CalibrationStore | None = None,
        quantizer: ProductQuantizer | None = None,
        codes: dict | None = None,
        codes_paths: dict | None = None,
    ):
        self.directory = directory
        self.tree = tree
        self.mesh = as_mesh(mesh, tree.device if device is None else device)
        self.device = self.mesh.first
        self.wire_dtype = wire_dtype
        self._committed: list[Segment] = list(segments)
        self._staged: list[Segment] = []
        self._shard_plan = shard_plan
        self._shard_plan_dirty = False
        # compressed-codes tier: the PQ quantizer, per-segment (rows, m)
        # uint8 codes on the device, and the paths of published code files
        self.quantizer = quantizer
        # (one tensor per shard, on its device, for a segment of S shards)
        self._codes: dict = dict(codes or {})
        self._codes_paths: dict[str, str] = dict(codes_paths or {})
        self._codes_dirty = False
        # index-scoped calibration of this device's backend; records of
        # other backends ride along unread (core/engine/costmodel.py)
        self.calibration = (calibration if calibration is not None
                            else CalibrationStore(backend_name(self.device)))
        self._tombstones = (
            np.sort(np.asarray(tombstones, np.int64))
            if tombstones is not None and len(tombstones)
            else np.empty((0,), np.int64))
        self._tombstones_dirty = False
        self._version = version
        self._next_id = int(next_id)
        self._user_meta = dict(meta or {})  # carried in every manifest
        self._meta_dirty = False
        self._views: tuple[DistributedIndex, ...] | None = None
        self._mem_seq = 0  # segment naming for ephemeral (dir-less) indexes
        self._lock = threading.RLock()
        self._stamp = 0

    # -- construction -------------------------------------------------------
    @classmethod
    def create(cls, tree: VocabTree, directory: str | None = None, *,
               device="cuda", mesh: DeviceMesh | None = None,
               wire_dtype=torch.float32,
               extra: dict | None = None, overwrite: bool = False) -> "Index":
        """New empty index bound to ``tree``.

        Args:
          tree: the vocabulary tree every later append/search routes
            through; it must live on ``device``.
          directory: durable home of the index; ``None`` gives an
            ephemeral index (same API, nothing on disk).
          device: where segments live and searches run (the card by
            default; ``"cpu"`` runs the plain versions).
          mesh: the shards' devices instead of ``device``: every segment
            is built over them (``build_index(..., mesh=)``) and searched
            shard by shard; the tree lives on the mesh's first device.
          wire_dtype: the routed shuffle's payload dtype for appends and
            compactions (float32, the JAX package's default, keeps grown
            indexes bit-identical to one-shot rebuilds of float rows;
            bfloat16 halves the shuffle's bytes, exact on integer rows).
          extra: user metadata carried in every manifest.
          overwrite: clear a previous index's artifacts (manifests,
            segments, tree, tombstones); other files are left alone.

        Raises:
          FileExistsError: ``directory`` already holds an index and
            ``overwrite`` is False.
        """
        mesh = as_mesh(mesh, device)
        if tree.device != mesh.first:
            raise ValueError(f"tree on {tree.device}, index on {mesh.first}")
        idx = cls(directory, tree, mesh=mesh, wire_dtype=wire_dtype, meta=extra)
        if directory:
            if has_index(directory) and not overwrite:
                raise FileExistsError(
                    f"{directory} already holds an index; use Index.open "
                    "or create(..., overwrite=True)")
            if overwrite and os.path.isdir(directory):
                for v in manifest_lib.list_versions(directory):
                    os.remove(manifest_lib.manifest_path(directory, v))
                for sub in (manifest_lib.SEGMENTS_SUBDIR,
                            manifest_lib.TOMBSTONES_SUBDIR,
                            manifest_lib.TREE_SUBDIR):
                    shutil.rmtree(os.path.join(directory, sub),
                                  ignore_errors=True)
            os.makedirs(directory, exist_ok=True)
            _save_tree(directory, tree, idx._tree_meta())
            manifest_lib.write(directory, idx._manifest())
        return idx

    @classmethod
    def open(cls, directory: str, device="cuda",
             mesh: DeviceMesh | None = None) -> "Index":
        """Restore the last *committed* state from ``directory`` onto
        ``device``, or onto ``mesh`` (every segment and tree file
        crc-checked on load).

        Raises:
          FileNotFoundError: no committed manifest (including the
            pre-segment ``index_ckpt/`` format, reported actionably).
          ValueError: a segment was built for another shard count than
            the mesh's (one without ``mesh``).
        """
        m = manifest_lib.latest(directory)
        if m is None:
            if has_legacy_index(directory):
                raise FileNotFoundError(
                    f"{directory} holds a pre-segment-format index "
                    f"({LEGACY_CKPT_SUBDIR}/), which this version no longer "
                    "reads -- rebuild it (e.g. serve --rebuild, or "
                    "Index.create + append + commit)")
            raise FileNotFoundError(f"no index manifest under {directory}")
        mesh = as_mesh(mesh, device)
        dev = mesh.first
        tree, tree_meta = _load_tree(directory, dev)
        seg_dir = os.path.join(directory, manifest_lib.SEGMENTS_SUBDIR)
        segments = []
        for name in m.segments:
            with get_tracer().span("index.load", segment=name):
                segments.append(Segment.load(seg_dir, name, mesh))
        wire = _WIRE_DTYPES[tree_meta.get("wire_dtype", "float32")]
        quantizer, codes, codes_paths = None, {}, {}
        if m.codes:
            quantizer = ProductQuantizer.from_json(m.codes["quantizer"])
            codes_paths = dict(m.codes.get("segments", {}))
            codes = {name: _place_codes(
                         manifest_lib.read_codes(directory, rel), mesh)
                     for name, rel in codes_paths.items()
                     if name in m.segments}
        return cls(
            directory, tree, mesh=mesh, segments=segments,
            tombstones=manifest_lib.read_tombstones(directory, m.tombstones),
            version=m.version, next_id=m.next_id, meta=m.meta,
            wire_dtype=wire,
            shard_plan=ShardPlan.from_json(m.shard_plan) if m.shard_plan else None,
            calibration=CalibrationStore.from_json(
                m.calibration, backend=backend_name(dev)),
            quantizer=quantizer, codes=codes, codes_paths=codes_paths)

    @classmethod
    def from_built(cls, built: DistributedIndex | MeshIndex, tree: VocabTree, *,
                   extra: dict | None = None) -> "Index":
        """Ephemeral single-segment wrapper around an already-built index
        (on the tree's device, or on a mesh whose first device it is)."""
        idx = cls.create(tree, None, mesh=built.mesh, extra=extra)
        idx.append_built(built)
        idx.commit()
        return idx

    # -- basic accessors ----------------------------------------------------
    @property
    def n_leaves(self) -> int:
        return self.tree.n_leaves

    @property
    def dim(self) -> int:
        return self.tree.dim

    @property
    def version(self) -> int:
        return self._version

    @property
    def next_id(self) -> int:
        """Next auto-assigned descriptor id (the id-space high-water mark)."""
        return self._next_id

    @property
    def stamp(self) -> int:
        """Monotone mutation counter: equal stamps mean the state is
        unchanged between them."""
        return self._stamp

    def snapshot(self) -> IndexSnapshot:
        """A consistent :class:`IndexSnapshot` of this handle's view
        (committed + staged), taken under the writer lock."""
        with self._lock:
            segs = self.segments
            return IndexSnapshot(
                stamp=self._stamp, version=self._version, segments=segs,
                views=self.segment_views(), tombstones=self._tombstones.copy(),
                shard_plan=self._shard_plan, quantizer=self.quantizer,
                codes=({s.name: self._codes[s.name] for s in segs}
                       if self.quantizer is not None else {}))

    @property
    def segments(self) -> tuple[Segment, ...]:
        """Committed + staged segments, in append order."""
        return tuple(self._committed) + tuple(self._staged)

    @property
    def n_segments(self) -> int:
        return len(self._committed) + len(self._staged)

    @property
    def staged_segments(self) -> tuple[str, ...]:
        return tuple(s.name for s in self._staged)

    @property
    def tombstones(self) -> np.ndarray:
        return self._tombstones.copy()

    @property
    def shard_plan(self) -> ShardPlan | None:
        """The scatter-gather :class:`ShardPlan` bound to this index
        (persisted in the manifest), or ``None``."""
        return self._shard_plan

    def set_shard_plan(self, plan: ShardPlan | None) -> None:
        """Stage a shard plan (or clear with ``None``); durable at the next
        :meth:`commit`. Raises ``ValueError`` unless ``plan`` assigns
        exactly this index's current segments."""
        if plan is not None and not plan.covers(
                [s.name for s in self.segments]):
            raise ValueError(
                "shard plan does not cover the index's current segments; "
                "derive one with ShardPlan.for_index")
        with self._lock:
            self._shard_plan = plan
            self._shard_plan_dirty = True
            self._stamp += 1

    # -- compressed-codes tier ----------------------------------------------
    def enable_codes(self, *, m: int = 8, bits: int = 8, sample: int = 65_536,
                     iters: int = 16, seed: int = 0) -> ProductQuantizer:
        """Train a :class:`~repro_torch.codes.ProductQuantizer` on this
        index's rows (every row with an id, in segment order, as the JAX
        package does: the same rows train the same codebooks) and encode
        every segment on the device (staged; durable after :meth:`commit`).
        Later appends and compactions encode their new segments.

        Raises:
          ValueError: no indexed row, or ``dim`` is not divisible by ``m``.
        """
        segs = self.segments
        valid = [torch.nonzero(index_ids(s.index) >= 0)[:, 0] for s in segs]
        counts = np.array([v.numel() for v in valid], np.int64)
        n = int(counts.sum())
        if n == 0:
            raise ValueError("enable_codes needs at least one indexed row")
        with get_tracer().span("index.enable_codes", rows=n, m=m, bits=bits):
            pos = ProductQuantizer.sample_rows(n, self.dim, m=m, bits=bits,
                                               seed=seed, sample=sample)
            # the sampled rows of the segments' concatenated valid rows
            starts = np.concatenate([[0], np.cumsum(counts)])
            parts = []
            for s, (seg, rows) in enumerate(zip(segs, valid)):
                lo, hi = np.searchsorted(pos, starts[s:s + 2])
                local = torch.as_tensor(pos[lo:hi] - starts[s], device=rows.device)
                parts.append(index_rows(seg.index, rows[local]).cpu().numpy())
            pq = ProductQuantizer.fit(np.concatenate(parts), m=m, bits=bits,
                                      seed=seed, iters=iters, trained_rows=n)
            codes = {seg.name: _encode(pq, seg.index) for seg in segs}
        with self._lock:
            self.quantizer = pq
            self._codes = codes
            self._codes_paths = {}
            self._codes_dirty = True
            self._stamp += 1
        return self.quantizer

    @property
    def rows(self) -> int:
        """Live (searchable) descriptor rows: valid minus tombstoned."""
        return sum(s.valid_rows for s in self.segments) - len(self._tombstones)

    def codes_stats(self) -> dict | None:
        """Footprint of the compressed tier, or ``None`` when disabled."""
        pq = self.quantizer
        if pq is None:
            return None
        return {
            "code_m": pq.m,
            "code_bits": pq.bits,
            "bytes_per_row": pq.bytes_per_row,
            "raw_bytes_per_row": 4 * self.dim,
            "compression_ratio": pq.compression_ratio(),
            "codebook_bytes": pq.codebook_bytes,
        }

    @property
    def meta(self) -> dict:
        """User extra merged with the derived structure and size keys, as
        the JAX package's ``Index.meta`` has them."""
        out = dict(self._user_meta)
        out.update(self._tree_meta())
        out.update(
            rows=sum(s.rows for s in self.segments),
            valid_rows=sum(s.valid_rows for s in self.segments),
            live_rows=self.rows,
            n_shards=self.mesh.n_shards,
            n_segments=self.n_segments,
            n_tombstones=int(len(self._tombstones)),
            next_id=self._next_id,
            version=self._version,
        )
        return out

    def stats(self) -> dict:
        """:attr:`meta` with each segment's :meth:`Segment.stats` and the
        names of the staged segments."""
        return dict(
            self.meta,
            segments=[s.stats() for s in self.segments],
            staged=list(self.staged_segments),
        )

    def _tree_meta(self) -> dict:
        return {
            "n_leaves": int(self.tree.n_leaves),
            "n_levels": len(self.tree.levels),
            "fanouts": [int(f) for f in self.tree.fanouts],
            "dim": int(self.tree.dim),
            "wire_dtype": dtype_name(self.wire_dtype),
        }

    def _manifest(self, tombstones_rel: str | None = None, *,
                  version: int | None = None,
                  segments: Sequence[Segment] | None = None,
                  shard_plan: ShardPlan | None = None,
                  codes_paths: dict | None = None) -> Manifest:
        segs = self._committed if segments is None else segments
        cal = self.calibration
        return Manifest(
            version=self._version if version is None else version,
            segments=[s.name for s in segs],
            tombstones=tombstones_rel,
            next_id=self._next_id,
            meta=self._user_meta,
            shard_plan=shard_plan.to_json() if shard_plan else None,
            calibration=(cal.to_json() if len(cal) or cal.n_tile_configs
                         or cal.n_carried else None),
            codes=self._codes_payload(segs, codes_paths),
        )

    def _codes_payload(self, segments: Sequence[Segment],
                       paths: dict | None = None) -> dict | None:
        if self.quantizer is None:
            return None
        paths = self._codes_paths if paths is None else paths
        return {
            "format": CODES_FORMAT,
            "quantizer": self.quantizer.to_json(),
            "segments": {s.name: paths[s.name] for s in segments
                         if s.name in paths},
        }

    def _write_codes(self, name: str, codes) -> str:
        if not isinstance(codes, torch.Tensor):  # one table per shard
            codes = torch.cat([c.cpu() for c in codes])
        return manifest_lib.write_codes(self.directory, name,
                                        codes.cpu().numpy())

    def _plan_for(self, segments: Sequence[Segment]) -> ShardPlan | None:
        """The bound shard plan updated to ``segments``: unchanged when it
        still covers them, re-derived (same strategy and shard count)
        after an append/compact; explicit plans cannot follow and drop."""
        p = self._shard_plan
        if p is None:
            return None
        names = [s.name for s in segments]
        if p.covers(names):
            return p
        if p.strategy == "round_robin":
            return ShardPlan.round_robin(names, p.n_shards)
        if p.strategy == "balanced":
            return ShardPlan.balanced(
                names, [s.valid_rows for s in segments], p.n_shards)
        return None

    # -- write path ---------------------------------------------------------
    def _segments_dir(self) -> str:
        return os.path.join(self.directory, manifest_lib.SEGMENTS_SUBDIR)

    def _next_name(self) -> str:
        if self.directory:
            return segment_name(next_seq(self._segments_dir()))
        self._mem_seq += 1
        return segment_name(self._mem_seq)

    def _indexed(self, ids: np.ndarray) -> np.ndarray:
        """(n,) bool: which of ``ids`` (non-empty int64) some segment holds,
        probed on the device through the segments' id indexes, only in
        segments whose id range can overlap them."""
        found = torch.zeros(ids.shape, dtype=torch.bool, device=self.device)
        probe = torch.as_tensor(ids, dtype=torch.int64, device=self.device)
        for seg in self.segments:
            if seg.overlaps(ids):
                found |= seg.find(probe)[0]
        return found.cpu().numpy()

    def append(self, vecs, ids=None, *, wave_rows: int | None = None,
               capacity_factor: float = 2.0) -> str:
        """Assign + route + cluster-sort ``vecs`` into a new immutable
        segment (staged; durable after :meth:`commit`), through the same
        ``build_index`` a one-shot build runs, at this index's wire dtype.

        Args:
          vecs: ``(n, dim)`` descriptor rows (numpy or a tensor; float32).
          ids: explicit non-negative descriptor ids; default is the next
            contiguous range of the id space.
          wave_rows: assignment wave size (default 4096; the last wave
            holds the remainder).
          capacity_factor: routing headroom for skewed leaves.

        Raises:
          ValueError: wrong shape, zero rows, negative/duplicate/colliding
            ids, or an id past the int32 id space.
        """
        vecs = torch.as_tensor(vecs, device=self.device).float().contiguous()
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise ValueError(
                f"append expects (n, {self.dim}) rows; got {tuple(vecs.shape)}")
        n = vecs.shape[0]
        if n == 0:
            raise ValueError("append of zero rows")
        if ids is None:
            ids = np.arange(self._next_id, self._next_id + n, dtype=np.int64)
        else:
            ids = np.asarray(ids, np.int64)
            if ids.shape != (n,):
                raise ValueError(f"ids shape {ids.shape} != ({n},)")
            if ids.size and ids.min() < 0:
                raise ValueError("descriptor ids must be non-negative")
            if len(np.unique(ids)) != n:
                raise ValueError("duplicate ids within the appended batch")
            if ids.min() < self._next_id and self._indexed(ids).any():
                raise ValueError("appended ids collide with indexed ids")
        if int(ids.max()) > np.iinfo(np.int32).max:
            # the engine carries ids as int32; a wrapped id would silently
            # become padding and the row would vanish
            raise ValueError(
                f"descriptor id {int(ids.max())} exceeds int32 -- the id "
                "space is full; compact() after deletes or re-id the corpus")
        with get_tracer().span("index.append", rows=n):
            built = build_index(
                vecs, self.tree,
                ids=torch.as_tensor(ids.astype(np.int32), device=self.device),
                wave_rows=wave_rows, capacity_factor=capacity_factor,
                wire_dtype=self.wire_dtype, mesh=self.mesh)
            # the id space advances past every id given, whatever routing
            # dropped (ROADMAP P12)
            name = self.append_built(built, next_id=int(ids.max()) + 1)
        reg = get_registry()
        reg.counter("index.appends").inc()
        reg.counter("index.rows_appended").inc(n)
        return name

    def append_built(self, built: DistributedIndex | MeshIndex, *, name=None,
                     next_id: int | None = None) -> str:
        """Adopt an already-built index (on this index's mesh) as a staged
        segment. The next default id becomes at least ``next_id`` and one
        past the segment's largest surviving id."""
        if int(built.n_leaves) != self.n_leaves:
            raise ValueError(f"built index has {built.n_leaves} leaves; tree "
                             f"has {self.n_leaves}")
        if built.mesh != self.mesh:
            raise ValueError(f"built index on {built.mesh.devices}, index on "
                             f"{self.mesh.devices}")
        seg = Segment.from_built(name or self._next_name(), built)
        if self.directory:
            with get_tracer().span("index.save", segment=seg.name, rows=seg.rows):
                seg.save(self._segments_dir())  # durable *before* it is staged
        new_codes = None
        if self.quantizer is not None:
            # the codes follow every append: encode the new segment's rows
            # (padding rows carry LEAF_SENTINEL and never match)
            new_codes = _encode(self.quantizer, seg.index)
        with self._lock:
            self._staged.append(seg)
            if new_codes is not None:
                self._codes[seg.name] = new_codes
                self._codes_dirty = True
            self._next_id = max(self._next_id, seg.max_id + 1, next_id or 0)
            self._views = None
            self._stamp += 1
        return seg.name

    def update_meta(self, **kw) -> None:
        """Stage user-metadata updates (e.g. an ingest cursor); durable at
        the next :meth:`commit` alongside whatever else is staged."""
        with self._lock:
            self._user_meta.update(kw)
            self._meta_dirty = True
            self._stamp += 1

    def delete(self, ids) -> int:
        """Tombstone descriptor ids (staged; durable after :meth:`commit`).
        Absent or already-deleted ids are ignored. Returns how many ids
        were newly tombstoned; they stop matching at once for this handle
        and are dropped at the next :meth:`compact`."""
        ids = np.unique(np.asarray(ids, np.int64))
        ids = ids[~np.isin(ids, self._tombstones)]
        if ids.size:
            ids = ids[self._indexed(ids)]
        if ids.size == 0:
            return 0
        with self._lock:
            self._tombstones = np.sort(np.concatenate([self._tombstones, ids]))
            self._tombstones_dirty = True
            self._views = None
            self._stamp += 1
        reg = get_registry()
        reg.counter("index.tombstoned").inc(int(ids.size))
        reg.gauge("index.tombstones_live").set(int(self._tombstones.size))
        return int(ids.size)

    def commit(self) -> int:
        """Publish staged segments + tombstones + metadata + shard plan +
        calibration: one atomic manifest bump.

        Idempotent: with nothing staged it returns the current version
        without writing. A crash before the manifest link leaves the
        previous committed state intact (staged segment checkpoints become
        ignorable orphans); a crash after it leaves the new state.

        Raises:
          FileExistsError: another handle committed this version first --
            reopen and retry.
          OSError: the durable write failed; the handle stays staged, so a
            retried ``commit()`` publishes.
        """
        if not (self._staged or self._tombstones_dirty or self._meta_dirty
                or self._shard_plan_dirty or self._codes_dirty
                or self.calibration.dirty):
            return self._version
        # durable writes first, memory state only after they succeed
        version = self._version + 1
        segments = self._committed + self._staged
        plan = self._plan_for(segments)
        with get_tracer().span("index.commit", version=version,
                               staged=len(self._staged)):
            if self.directory:
                rel = None
                if len(self._tombstones):
                    rel = manifest_lib.write_tombstones(
                        self.directory, version, self._tombstones)
                if self.quantizer is not None:
                    # code files are durable before the manifest naming them
                    for seg in segments:
                        if seg.name not in self._codes_paths:
                            self._codes_paths[seg.name] = self._write_codes(
                                seg.name, self._codes[seg.name])
                manifest_lib.write(
                    self.directory,
                    self._manifest(rel, version=version, segments=segments,
                                   shard_plan=plan))
        get_registry().counter("index.commits").inc()
        with self._lock:
            self._version = version
            self._committed = segments
            self._staged = []
            self._shard_plan = plan
            self._tombstones_dirty = False
            self._meta_dirty = False
            self._shard_plan_dirty = False
            self._codes_dirty = False
            self.calibration.mark_clean()
            self._stamp += 1
        return version

    def _live_rows(self, victims: Sequence[Segment]):
        """(vecs, ids) of the victims' live rows, ordered by id, gathered on
        the device."""
        rows, ids = [], []
        for seg in victims:
            seg_ids = index_ids(seg.index)
            live = seg_ids >= 0
            if self._tombstones.size:
                live &= ~tombstone_hits(seg_ids, self._tombstones)
            r = torch.nonzero(live)[:, 0]
            rows.append(r)
            ids.append(seg_ids[r].long())
        all_i = torch.cat(ids) if ids else torch.empty(
            (0,), dtype=torch.int64, device=self.device)
        order = torch.argsort(all_i, stable=True)
        out = torch.empty((all_i.numel(), self.dim), dtype=torch.float32,
                          device=self.device)
        at = torch.empty_like(order)
        at[order] = torch.arange(order.numel(), device=self.device)
        s = 0
        for seg, r in zip(victims, rows):
            out[at[s:s + r.numel()]] = index_rows(seg.index, r)
            s += r.numel()
        return out, all_i[order]

    def compact(self, incremental: bool = False,
                policy: CompactionPolicy | None = None) -> str | None:
        """Merge segments into one, dropping their tombstoned rows.

        ``compact()`` merges every segment; ``compact(incremental=True)``
        merges the :class:`CompactionPolicy`'s victims only, carrying the
        other segments, their code files and their tombstones through.
        Publishes through the same manifest path a commit uses; search
        results are bit-identical before and after (the victims' live
        rows reappear, id-sorted, in the merged segment at the first
        victim's position). Victim checkpoints are removed only after the
        manifest bump.

        Returns the merged segment's name; ``None`` when no merged segment
        was produced (no live rows, or an incremental fixed point).

        Raises:
          FileExistsError: a concurrent commit won the version race.
          Exception: a failed rebuild or write propagates with segments
            and tombstones exactly as committed.
        """
        tr = get_tracer()
        t_start = tr.now() if tr.enabled else 0.0
        old = self.segments
        if incremental:
            pol = policy if policy is not None else CompactionPolicy()
            victims = pol.select(old, self._tombstones)
            if not victims:
                return None
        else:
            victims = list(old)
        victim_names = {s.name for s in victims}
        # the masked views are a cache: free their device copies before
        # the rebuild (they come back on the next search)
        self._views = None
        all_v, all_i = self._live_rows(victims)
        # build + durably publish first; the handle's state is replaced
        # only once the new manifest exists
        if all_i.numel() == 0:
            merged: list[Segment] = []
        else:
            built = build_index(all_v, self.tree, ids=all_i.to(torch.int32),
                                wire_dtype=self.wire_dtype, mesh=self.mesh)
            del all_v
            seg = Segment.from_built(self._next_name(), built)
            if self.directory:
                with get_tracer().span("index.save", segment=seg.name,
                                       rows=seg.rows):
                    seg.save(self._segments_dir())
            merged = [seg]
        n_out = int(all_i.numel())
        # survivors keep their order; the merged segment takes the first
        # victim's slot (stable cross-segment ties)
        new_committed: list[Segment] = []
        placed = False
        for s in old:
            if s.name in victim_names:
                if not placed:
                    new_committed.extend(merged)
                    placed = True
                continue
            new_committed.append(s)
        if not placed:
            new_committed.extend(merged)
        # tombstones of the victims died with them; those in surviving
        # segments stay
        new_tombstones = np.empty((0,), np.int64)
        if incremental and self._tombstones.size:
            survivors = [s for s in old if s.name not in victim_names]
            keep = torch.zeros(self._tombstones.shape, dtype=torch.bool,
                               device=self.device)
            probe = torch.as_tensor(self._tombstones, device=self.device)
            for s in survivors:
                if s.valid_rows and s.overlaps(self._tombstones):
                    keep |= s.find(probe)[0]
            new_tombstones = self._tombstones[keep.cpu().numpy()]
        new_codes, new_codes_paths = self._codes, self._codes_paths
        if self.quantizer is not None:
            # the quantizer survives; only the merged segment is encoded
            new_codes = {name: c for name, c in self._codes.items()
                         if name not in victim_names}
            for s in merged:
                new_codes[s.name] = _encode(self.quantizer, s.index)
            new_codes_paths = {name: p for name, p in self._codes_paths.items()
                               if name not in victim_names}
            if self.directory:
                for s in new_committed:
                    if s.name not in new_codes_paths:
                        new_codes_paths[s.name] = self._write_codes(
                            s.name, new_codes[s.name])
        version = self._version + 1
        plan = self._plan_for(new_committed)
        if self.directory:
            rel = None
            if new_tombstones.size:
                rel = manifest_lib.write_tombstones(
                    self.directory, version, new_tombstones)
            manifest_lib.write(
                self.directory,
                self._manifest(rel, version=version, segments=new_committed,
                               shard_plan=plan, codes_paths=new_codes_paths))
        with self._lock:
            self._committed = new_committed
            self._staged = []
            self._shard_plan = plan
            self._shard_plan_dirty = False
            self._tombstones = new_tombstones
            self._tombstones_dirty = False
            self._meta_dirty = False
            self._codes = new_codes
            self._codes_paths = new_codes_paths
            self._codes_dirty = False
            self.calibration.mark_clean()
            self._version = version
            self._views = None
            self._stamp += 1
        if self.directory:
            self._gc_segments(old)
        if tr.enabled:
            tr.add_span("index.compact", t_start, tr.now(),
                        segments_in=len(victims), rows_out=n_out,
                        version=version, incremental=bool(incremental))
        reg = get_registry()
        reg.counter("index.compacts").inc()
        reg.gauge("index.tombstones_live").set(int(new_tombstones.size))
        return merged[0].name if merged else None

    def _gc_segments(self, old: Sequence[Segment]) -> None:
        live = {s.name for s in self._committed}
        for seg in old:
            if seg.name in live:
                continue
            shutil.rmtree(os.path.join(self._segments_dir(), seg.name),
                          ignore_errors=True)
            try:
                os.remove(os.path.join(self.directory, manifest_lib.CODES_SUBDIR,
                                       f"{seg.name}.npy"))
            except OSError:
                pass

    def gc(self, *, dry_run: bool = False) -> dict:
        """Collect artifacts unreachable from the newest on-disk manifest:
        superseded manifests, orphan segment checkpoints, unreferenced
        tombstone/code files and stray ``*.tmp`` files. This handle's own
        staged segments are never collected. Returns the relative paths
        by kind (collected, or only listed under ``dry_run``)."""
        report: dict[str, list[str]] = {
            "manifests": [], "segments": [], "tombstones": [], "codes": [],
            "tmp": []}
        d = self.directory
        if not d:
            return report
        m = manifest_lib.latest(d)
        if m is None:
            return report
        keep_segments = set(m.segments) | {s.name for s in self._staged}
        keep_files = {m.tombstones} if m.tombstones else set()
        if m.codes:
            keep_files |= set(m.codes.get("segments", {}).values())
        for v in manifest_lib.list_versions(d):
            if v != m.version:
                report["manifests"].append(
                    os.path.basename(manifest_lib.manifest_path(d, v)))
        seg_dir = os.path.join(d, manifest_lib.SEGMENTS_SUBDIR)
        if os.path.isdir(seg_dir):
            for name in sorted(os.listdir(seg_dir)):
                if name.startswith("seg_") and name not in keep_segments:
                    report["segments"].append(
                        os.path.join(manifest_lib.SEGMENTS_SUBDIR, name))
        for sub, key in ((manifest_lib.TOMBSTONES_SUBDIR, "tombstones"),
                         (manifest_lib.CODES_SUBDIR, "codes")):
            p = os.path.join(d, sub)
            if not os.path.isdir(p):
                continue
            for name in sorted(os.listdir(p)):
                rel = os.path.join(sub, name)
                if name.endswith(".tmp"):
                    report["tmp"].append(rel)
                elif rel not in keep_files:
                    report[key].append(rel)
        for name in sorted(os.listdir(d)):
            if name.endswith(".tmp") and os.path.isfile(os.path.join(d, name)):
                report["tmp"].append(name)
        if not dry_run:
            for rel in report["segments"]:
                shutil.rmtree(os.path.join(d, rel), ignore_errors=True)
            for key in ("manifests", "tombstones", "codes", "tmp"):
                for rel in report[key]:
                    try:
                        os.remove(os.path.join(d, rel))
                    except OSError:
                        pass
        return report

    # -- read path ----------------------------------------------------------
    def read_rows(self, ids, *, segments=None, tombstones=None) -> torch.Tensor:
        """Gather stored descriptor rows by id, on the device: each
        range-overlapping segment is probed through its id index (no
        concatenated copy of the corpus). Ids may repeat and come in any
        order; tombstoned ids read as missing at once. ``segments`` /
        ``tombstones`` pin a snapshot's cut. Returns ``(n, dim)`` float32
        on this index's device -- the rerank fetch.

        Raises:
          IndexError: a negative id, or an id absent or deleted.
        """
        segs = self.segments if segments is None else tuple(segments)
        ts = (self._tombstones if tombstones is None
              else np.asarray(tombstones, np.int64))
        ids = torch.as_tensor(ids, device=self.device).long().reshape(-1)
        if ids.numel() == 0:
            return torch.empty((0, self.dim), dtype=torch.float32,
                               device=self.device)
        uniq, inverse = torch.unique(ids, return_inverse=True)
        lo, hi = int(uniq[0]), int(uniq[-1])
        if lo < 0:
            # never let a requested -1 match a padding row's -1 id
            raise IndexError(f"descriptor ids must be >= 0; got {lo}")
        out = torch.empty((uniq.numel(), self.dim), dtype=torch.float32,
                          device=self.device)
        found = torch.zeros(uniq.shape, dtype=torch.bool, device=self.device)
        for seg in segs:
            if not seg.overlaps(np.array([lo, hi])):
                continue
            hit, row = seg.find(uniq)
            hit &= ~found
            out[hit] = index_rows(seg.index, row[hit])
            found |= hit
        if ts.size:
            found &= ~torch.isin(uniq, torch.as_tensor(ts, device=self.device))
        if not bool(found.all()):
            missing = uniq[~found].cpu().numpy()
            raise IndexError(
                "descriptor ids not in the index (absent or deleted): "
                f"{missing[:8].tolist()}" + ("..." if missing.size > 8 else ""))
        return out[inverse]

    def segment_views(self) -> tuple[DistributedIndex | MeshIndex, ...]:
        """Per-segment indexes with tombstones masked (cached until the
        next append/delete/compact)."""
        if self._views is None:
            self._views = tuple(masked_view(s, self._tombstones)
                                for s in self.segments)
        return self._views

    def search(self, queries, k: int = 10, *, plan: SearchPlan | None = None,
               layout: str = "auto", probes: int = 1, impl: str = "xla",
               block_rows: int | None = None, q_cap: int | None = None,
               q_tile: int | None = None, p_cap: int | None = None,
               rerank: int | None = None, cost_model="auto") -> SearchResult:
        """k-NN over every live row: one shared lookup build, one executor
        run per segment, one ascending-distance merge across segments.

        Args:
          queries: ``(q, dim)`` query rows (numpy or a tensor; float32).
          k: neighbours per query.
          plan: optional :class:`SearchPlan` template whose fields override
            the keyword arguments; budgets are re-resolved per segment
            (tile sizes must divide each segment's rows).
          layout/probes/impl/block_rows/q_cap/q_tile/p_cap: per-call plan
            knobs, as in :func:`repro_torch.core.engine.plan`; ``layout``
            also takes ``"scan_codes"`` once :meth:`enable_codes` ran, and
            ``"auto"`` (the default) lets the cost model pick.
          rerank: ADC candidates per query for ``scan_codes``.
          cost_model: which model ranks ``"auto"`` choices, consulting this
            index's calibration (of its own backend only).

        Returns a :class:`SearchResult` on the index's device: ``(q, k)``
        ids (-1 where fewer than ``k`` live rows matched) and squared-L2
        dists (inf there), plus exact pair and overflow counts. Dense
        layouts are bit-identical to a one-shot build + search over the
        live rows; ``scan_codes`` returns the exact-reranked top-k of the
        ADC candidates.

        Raises:
          ValueError: invalid plan knobs, or ``layout="scan_codes"``
            without :meth:`enable_codes`.
        """
        if plan is not None:
            layout, k, probes, impl = plan.layout, plan.k, plan.probes, plan.impl
            block_rows = plan.block_rows if block_rows is None else block_rows
            q_cap = plan.q_cap if q_cap is None else q_cap
            q_tile = plan.q_tile if q_tile is None else q_tile
            p_cap = plan.p_cap if p_cap is None else p_cap
            rerank = plan.rerank if rerank is None else rerank
        queries = torch.as_tensor(queries, device=self.device).float().contiguous()
        q = queries.shape[0]
        views = self.segment_views()
        if not views:
            return empty_result(q, k, self.device)
        # ADC distances are incomparable with exact ones, so codes-vs-exact
        # is resolved once on the aggregate shape
        if layout == "scan_codes" and self.quantizer is None:
            raise ValueError("layout='scan_codes' needs PQ codes; call "
                             "enable_codes() first")
        use_codes = False
        if self.quantizer is not None and layout in ("auto", "scan_codes"):
            agg = make_plan(
                rows=sum(v.rows for v in views), n_leaves=self.n_leaves,
                n_queries=q, n_shards=self.mesh.n_shards, k=k, probes=probes, layout=layout,
                impl=impl, model=cost_model, calibration=self.calibration,
                dim=self.dim, rerank=rerank, code_m=self.quantizer.m,
                code_bits=self.quantizer.bits)
            use_codes = agg.layout == "scan_codes"
        lookup = build_lookup(self.tree, queries, probes=probes)
        per = []
        pruned = 0
        segs_all = self.segments
        live_counts = (np.array([s.valid_rows for s in segs_all], np.int64)
                       - dead_counts(segs_all, self._tombstones))
        # dense-tier norm-bound pruning: a segment whose rows' L2 norms
        # all sit outside [kth_dist - margin] of every query's running
        # top-k cannot contribute (||p - q||^2 >= (||p|| - ||q||)^2) --
        # exact, and only for exact distances. The running top-k is read
        # before each next segment runs.
        q_norms = best_d = None
        if not use_codes and any(s.min_norm >= 0.0 for s in segs_all):
            q_norms = torch.linalg.vector_norm(queries.double(), dim=1)
            best_d = torch.full((q, k), np.inf, dtype=torch.float64,
                                device=self.device)
        for i, (seg, view) in enumerate(zip(segs_all, views)):
            if live_counts[i] == 0:
                pruned += 1  # every row is padding or tombstoned
                continue
            if (best_d is not None and seg.min_norm >= 0.0
                    and bool(torch.isfinite(best_d[:, -1]).all())):
                gap = torch.maximum(seg.min_norm - q_norms,
                                    q_norms - seg.max_norm)
                lb = gap.clamp(min=0.0) ** 2
                # the margin absorbs fp32 accumulation error in the exact
                # distances (about 1e-7 relative) and the last-bit
                # difference of norms taken on another device
                margin = 1e-4 * (seg.max_norm + q_norms) ** 2 + 1e-6
                if bool((lb > best_d[:, -1] + margin).all()):
                    pruned += 1
                    continue
            if use_codes:
                p = make_plan(
                    rows=view.rows, n_leaves=self.n_leaves, n_queries=q,
                    n_shards=view.n_shards, k=k, probes=probes,
                    layout="scan_codes",
                    impl=impl, block_rows=block_rows, q_cap=q_cap,
                    model=cost_model, calibration=self.calibration,
                    dim=self.dim, rerank=rerank, code_m=self.quantizer.m,
                    code_bits=self.quantizer.bits)
                per.append(search_with_lookup(
                    view, lookup, p, n_queries=q, codes=self._codes[seg.name],
                    codebooks=self.quantizer.codebooks))
                continue
            p = make_plan(
                rows=view.rows, n_leaves=self.n_leaves, n_queries=q,
                n_shards=view.n_shards, k=k, probes=probes, layout=layout,
                impl=impl,
                block_rows=block_rows, q_cap=q_cap, q_tile=q_tile,
                p_cap=p_cap, model=cost_model, calibration=self.calibration)
            per.append(search_with_lookup(view, lookup, p, n_queries=q))
            if best_d is not None:
                best_d = torch.sort(torch.cat(
                    [best_d, per[-1].dists.double()], dim=1), dim=1).values[:, :k]
        if pruned:
            get_registry().counter("index.segments_pruned").inc(pruned)
        if not per:
            return empty_result(q, k, self.device)
        if use_codes:
            r_max = max(r.ids.shape[1] for r in per)
            cand = per[0] if len(per) == 1 else _merge_results(per, r_max)
            with get_tracer().span("engine.rerank", k=k,
                                   candidates=int(cand.ids.shape[1])):
                ids_r, dists_r = rerank_exact(self.read_rows, queries,
                                              cand.ids, k)
            return SearchResult(ids=ids_r, dists=dists_r, pairs=cand.pairs,
                                q_cap_overflow=cand.q_cap_overflow)
        if len(per) == 1:
            return per[0]
        return _merge_results(per, k)


def _encode(pq: ProductQuantizer, index):
    """A segment's codes: ``(rows, m)`` uint8 on its device, or one such
    table per shard, each encoded on the shard's device."""
    if index.n_shards == 1:
        return pq.encode(index.parts[0].vecs)
    return tuple(pq.encode(p.vecs) for p in index.parts)


def _place_codes(codes: np.ndarray, mesh: DeviceMesh):
    """A stored ``(S*R, m)`` code table on the mesh: one tensor for one
    shard, else shard ``s``'s block on its device."""
    if mesh.n_shards == 1:
        return torch.as_tensor(codes, device=mesh.first)
    rows = codes.shape[0] // mesh.n_shards
    return tuple(torch.as_tensor(codes[s * rows:(s + 1) * rows], device=dev)
                 for s, dev in enumerate(mesh.devices))


def _merge_results(per: Sequence[SearchResult], k: int) -> SearchResult:
    """Fold per-segment k-NN tables into one: a stable ascending-distance
    sort of the segment-ordered concatenation (the same merge the
    executors apply across shards), so ties keep segment-major order."""
    all_i = torch.cat([r.ids for r in per], dim=1)
    all_d = torch.cat([r.dists for r in per], dim=1)
    sel = torch.sort(all_d, dim=1, stable=True).indices[:, :k]
    return SearchResult(
        ids=torch.gather(all_i, 1, sel),
        dists=torch.gather(all_d, 1, sel),
        pairs=sum(r.pairs for r in per),
        q_cap_overflow=sum(r.q_cap_overflow for r in per),
    )
