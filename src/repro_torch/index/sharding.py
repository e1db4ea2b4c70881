"""Sharded scatter-gather search: partition an :class:`Index` across shards.

The JAX package's ``index/sharding.py`` on one card. :class:`ShardPlan`
is an explicit, manifest-persisted mapping of the index's immutable
segments onto N shards (its JSON is the JAX package's, so either package
reads the other's plan), and :class:`ShardedIndex` scans each shard's
segments independently and merges the per-shard candidates.

Exactness. The gather merge is bit-identical to the unsharded
``Index.search``: every candidate carries its *global merge slot*
``segment_ordinal * k + position``; the unsharded merge is a stable
ascending-distance sort over the segment-ordered concatenation, i.e. a
total order by ``(distance, slot)``. Each shard keeps its local top-k
under that same order, and the top-k of a union of per-shard top-k lists
under a total order equals the top-k of all candidates.

Placement. On one card every shard shares the device and the shards scan
in turn -- the JAX package's own one-device regime, where every shard
shares the mesh: same results, summed time. Shards on separate GPUs wait
for the multi-GPU port (ROADMAP M13).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.codes import rerank_exact
from repro_torch.core.engine import costmodel as costmodel_lib
from repro_torch.core.engine.executors import SearchResult
from repro_torch.core.engine.plan import plan as make_plan
from repro_torch.core.lookup import build_lookup
from repro_torch.core.search import search_with_lookup
from repro_torch.index.segment import dead_counts
from repro_torch.obs import get_registry

STRATEGIES = ("round_robin", "balanced", "explicit")


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Explicit mapping of segment names onto shards.

    ``assignment[s]`` lists the segment names owned by shard ``s``, each in
    global append order (the order the index's manifest lists them) — the
    invariant the bit-identical merge relies on. Plans are value objects:
    derive one with :meth:`round_robin` / :meth:`balanced` /
    :meth:`explicit` (or :meth:`for_index`), persist it via
    ``Index.set_shard_plan`` + ``commit`` and it comes back from
    ``Index.open``.
    """

    n_shards: int
    strategy: str  # "round_robin" | "balanced" | "explicit"
    assignment: tuple[tuple[str, ...], ...]  # per shard, global order

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"{self.n_shards=} must be >= 1")
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"unknown shard strategy {self.strategy!r}; want {STRATEGIES}"
            )
        if len(self.assignment) != self.n_shards:
            raise ValueError(
                f"assignment has {len(self.assignment)} shards; plan says "
                f"{self.n_shards}"
            )
        flat = [name for shard in self.assignment for name in shard]
        if len(set(flat)) != len(flat):
            raise ValueError("shard plan assigns a segment twice")

    # -- derivation ---------------------------------------------------------
    @classmethod
    def round_robin(cls, segment_names: Sequence[str],
                    n_shards: int) -> "ShardPlan":
        """Segment ``i`` goes to shard ``i % n_shards`` — the paper's
        partition-by-arrival default; even counts, arbitrary sizes."""
        names = list(segment_names)
        return cls(
            n_shards=n_shards,
            strategy="round_robin",
            assignment=tuple(
                tuple(names[s::n_shards]) for s in range(n_shards)
            ),
        )

    @classmethod
    def balanced(cls, segment_names: Sequence[str], sizes: Sequence[int],
                 n_shards: int) -> "ShardPlan":
        """Size-balanced greedy (LPT): biggest segment first onto the
        least-loaded shard, so shard scan times stay even when segment
        sizes are skewed (many small appends + one compacted giant)."""
        names = list(segment_names)
        if len(sizes) != len(names):
            raise ValueError(f"{len(sizes)} sizes for {len(names)} segments")
        order = sorted(range(len(names)), key=lambda i: (-int(sizes[i]), i))
        loads = [0] * n_shards
        owner: dict[int, int] = {}
        for i in order:
            s = min(range(n_shards), key=lambda j: (loads[j], j))
            owner[i] = s
            loads[s] += int(sizes[i])
        return cls(
            n_shards=n_shards,
            strategy="balanced",
            # global (append) order within each shard, not LPT pick order
            assignment=tuple(
                tuple(names[i] for i in range(len(names)) if owner[i] == s)
                for s in range(n_shards)
            ),
        )

    @classmethod
    def explicit(cls, assignment: Sequence[Sequence[str]]) -> "ShardPlan":
        """Pin segments to shards by hand (operator override)."""
        return cls(
            n_shards=len(assignment),
            strategy="explicit",
            assignment=tuple(tuple(s) for s in assignment),
        )

    @classmethod
    def for_index(cls, index, n_shards: int,
                  strategy: str = "round_robin") -> "ShardPlan":
        """Derive a plan over ``index``'s current segments (committed +
        staged, in append order).

        Raises ``ValueError`` for an unknown or non-derivable strategy
        (``explicit`` plans cannot be derived — build one with
        :meth:`explicit`).
        """
        segs = index.segments
        if strategy == "round_robin":
            return cls.round_robin([s.name for s in segs], n_shards)
        if strategy == "balanced":
            return cls.balanced(
                [s.name for s in segs], [s.valid_rows for s in segs], n_shards
            )
        raise ValueError(
            f"cannot derive a {strategy!r} plan; want one of "
            "('round_robin', 'balanced')"
        )

    # -- queries ------------------------------------------------------------
    def shard_of(self, segment_name: str) -> int:
        for s, names in enumerate(self.assignment):
            if segment_name in names:
                return s
        raise KeyError(f"segment {segment_name!r} not in shard plan")

    def covers(self, segment_names: Sequence[str]) -> bool:
        """True when the plan assigns exactly the given segment set (the
        staleness check: an append/compact since the plan was made means a
        re-derive is needed)."""
        flat = {n for shard in self.assignment for n in shard}
        return flat == set(segment_names)

    def rederived(self, index) -> "ShardPlan":
        """The same strategy re-applied to ``index``'s current segments —
        how a persisted plan follows appends and compactions. Explicit
        plans cannot be re-derived and raise ``ValueError``."""
        return self.for_index(index, self.n_shards, self.strategy)

    # -- persistence --------------------------------------------------------
    def to_json(self) -> dict:
        return {
            "n_shards": self.n_shards,
            "strategy": self.strategy,
            "assignment": [list(s) for s in self.assignment],
        }

    @classmethod
    def from_json(cls, d: dict) -> "ShardPlan":
        return cls(
            n_shards=int(d["n_shards"]),
            strategy=d["strategy"],
            assignment=tuple(tuple(s) for s in d["assignment"]),
        )

    def describe(self) -> str:
        sizes = "/".join(str(len(s)) for s in self.assignment)
        return f"{self.strategy} x{self.n_shards} (segments {sizes})"


# ---------------------------------------------------------------------------
# merge helpers. A *slot* is a candidate's position in the unsharded
# segment-ordered concatenation: segment_ordinal * k + column.
# ---------------------------------------------------------------------------


def empty_result(q: int, k: int, device) -> SearchResult:
    """The no-neighbour result: ids -1, dists inf, no pairs, no overflow."""
    return SearchResult(
        ids=torch.full((q, k), -1, dtype=torch.int32, device=device),
        dists=torch.full((q, k), torch.inf, dtype=torch.float32, device=device),
        pairs=torch.zeros((), dtype=torch.float32, device=device),
        q_cap_overflow=torch.zeros((), dtype=torch.int32, device=device),
    )


def shard_local_partial(
    per_segment: Sequence[SearchResult], ordinals: Sequence[int], k: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold one shard's per-segment k-NN tables into its local top-k.

    ``ordinals`` are the segments' global append positions (ascending, so
    the concatenated slot row is strictly increasing and a *stable* sort
    by distance is exactly the ``(distance, slot)`` total order). Returns
    ``(ids, dists, slots)`` of shape ``(q, k)`` each.
    """
    ids = torch.cat([r.ids for r in per_segment], dim=1)
    dists = torch.cat([r.dists for r in per_segment], dim=1)
    slots = torch.cat([torch.arange(g * k, g * k + k, device=ids.device)
                       for g in ordinals])
    slots = slots.expand(ids.shape[0], slots.numel())
    sel = torch.sort(dists, dim=1, stable=True).indices[:, :k]
    return (torch.gather(ids, 1, sel), torch.gather(dists, 1, sel),
            torch.gather(slots, 1, sel))


def gather_merge(partials, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fuse per-shard ``(ids, dists, slots)`` partials into the global
    top-k, ordered by ``(distance, slot)`` -- bit-identical to the
    unsharded stable merge over the segment-ordered concatenation."""
    ids = torch.cat([p[0] for p in partials], dim=1)
    dists = torch.cat([p[1] for p in partials], dim=1)
    slots = torch.cat([p[2] for p in partials], dim=1)
    # primary key dists, ties by slot: sort by slot, then stably by dists
    by_slot = torch.sort(slots, dim=1, stable=True).indices
    d1 = torch.gather(dists, 1, by_slot)
    sel = torch.gather(by_slot, 1,
                       torch.sort(d1, dim=1, stable=True).indices)[:, :k]
    return torch.gather(ids, 1, sel), torch.gather(dists, 1, sel)


def _pad_cols(res: SearchResult, width: int) -> SearchResult:
    """Right-pad a candidate table to ``width`` columns with the engine's
    absent-row sentinels (``-1``/``inf`` sort behind every candidate)."""
    w = int(res.ids.shape[1])
    if w == width:
        return res
    pad = width - w
    return SearchResult(
        ids=torch.nn.functional.pad(res.ids, (0, pad), value=-1),
        dists=torch.nn.functional.pad(res.dists, (0, pad), value=torch.inf),
        pairs=res.pairs, q_cap_overflow=res.q_cap_overflow,
    )


def fitted_shard_scales(index, shard_views, *, cost_model, n_queries: int,
                        k: int, probes: int, layout: str, impl: str,
                        max_scale: float = 2.0) -> list[float]:
    """Per-shard slab-headroom multipliers from fitted per-shard costs,
    as the JAX package's: all ones (the uniform split) until
    ``index.calibration`` yields a usable fit of its own backend, or when
    any shard cannot be planned or priced."""
    fitted = costmodel_lib.fitted_component(cost_model, index.calibration)
    if fitted is None:
        return [1.0] * len(shard_views)
    probe_plans, shapes = [], []
    for shard in shard_views:
        if not shard:
            continue
        rows = sum(int(v.rows) for _, v in shard)
        try:
            probe_plans.append(make_plan(
                rows=rows, n_leaves=index.n_leaves, n_queries=n_queries,
                n_shards=1, k=k, probes=probes, layout=layout, impl=impl,
                model=cost_model, calibration=index.calibration))
        except ValueError:
            return [1.0] * len(shard_views)
        shapes.append(costmodel_lib.PlanShapes(
            rows=rows, n_queries=n_queries, n_shards=1,
            n_leaves=index.n_leaves))
    scales = iter(costmodel_lib.shard_slab_scales(
        fitted, probe_plans, shapes, max_scale=max_scale))
    return [next(scales) if shard else 1.0 for shard in shard_views]


class ShardedIndex:
    """Scatter-gather search view over an :class:`Index` and a
    :class:`ShardPlan`.

    Wraps -- never copies -- the underlying index: segments stay where the
    lifecycle put them, tombstones are applied by the same masked views,
    and the plan only decides which shard scans which segment. Construct
    with an explicit ``plan``, or give ``n_shards`` (+ ``strategy``) to
    derive one; a persisted plan on the index is picked up when neither is
    given.
    """

    def __init__(self, index, plan: ShardPlan | None = None, *,
                 n_shards: int | None = None, strategy: str = "round_robin",
                 segments=None, views=None, codes=None, tombstones=None):
        self.index = index
        # segments/views/codes/tombstones pin the scatter to one
        # IndexSnapshot's cut instead of the index's live state: a serving
        # session keeps resolving against it while the index mutates
        self._pin_segments = tuple(segments) if segments is not None else None
        self._pin_views = tuple(views) if views is not None else None
        self._pin_codes = dict(codes) if codes is not None else None
        self._pin_tombstones = (np.asarray(tombstones, np.int64)
                                if tombstones is not None else None)
        if plan is None:
            if n_shards is not None:
                plan = ShardPlan.for_index(index, n_shards, strategy)
            elif getattr(index, "shard_plan", None) is not None:
                plan = index.shard_plan
            else:
                raise ValueError(
                    "need a ShardPlan, n_shards, or an index with a "
                    "persisted shard plan")
        if not plan.covers([s.name for s in self.segments]):
            raise ValueError(
                "shard plan does not cover the index's current segments "
                f"({plan.describe()} vs {len(self.segments)} segments); "
                "re-derive with plan.rederived(index)")
        self.plan = plan

    @property
    def n_shards(self) -> int:
        return self.plan.n_shards

    @property
    def segments(self) -> tuple:
        """The segment cut this view scatters over: the pinned one when
        given, else the index's live committed + staged set."""
        if self._pin_segments is not None:
            return self._pin_segments
        return tuple(self.index.segments)

    def segment_views(self) -> tuple:
        if self._pin_views is not None:
            return self._pin_views
        return tuple(self.index.segment_views())

    @property
    def tombstones(self) -> np.ndarray:
        if self._pin_tombstones is not None:
            return self._pin_tombstones
        return self.index.tombstones

    def _codes(self, name: str):
        if self._pin_codes is not None:
            return self._pin_codes[name]
        return self.index._codes[name]

    def shard_views(self) -> list[list[tuple[int, object]]]:
        """Per shard: ``(global_ordinal, masked DistributedIndex view)``
        pairs in global append order."""
        by_name = {s.name: (g, v) for g, (s, v) in enumerate(
            zip(self.segments, self.segment_views()))}
        return [[by_name[name] for name in shard]
                for shard in self.plan.assignment]

    def _live_counts(self) -> np.ndarray:
        segs = self.segments
        valid = np.array([s.valid_rows for s in segs], np.int64)
        return valid - dead_counts(segs, self.tombstones)

    def stats(self) -> dict:
        """The plan and each shard's segments and valid rows."""
        segs = {s.name: s for s in self.segments}
        return {"plan": self.plan.to_json(), "shards": [
            {"shard": s, "segments": list(names),
             "rows": sum(segs[n].valid_rows for n in names)}
            for s, names in enumerate(self.plan.assignment)]}

    def search(self, queries, k: int = 10, *, plan=None, layout: str = "auto",
               probes: int = 1, impl: str = "xla",
               block_rows: int | None = None, q_cap: int | None = None,
               q_tile: int | None = None, p_cap: int | None = None,
               rerank: int | None = None, cost_model="auto") -> SearchResult:
        """Scatter-gather k-NN: one shared lookup build, each shard scans
        its segments, per-shard candidates merge by ``(distance, slot)``.

        Arguments mirror :meth:`Index.search`. In the zero-overflow regime
        the result is bit-identical to :meth:`Index.search` (ids and
        distances, every layout, any ``probes``, tombstones respected) at
        every shard count and under every ``cost_model``; ``pairs`` and
        ``q_cap_overflow`` are summed across shards.
        """
        idx = self.index
        if plan is not None:
            layout, k, probes, impl = plan.layout, plan.k, plan.probes, plan.impl
            block_rows = plan.block_rows if block_rows is None else block_rows
            q_cap = plan.q_cap if q_cap is None else q_cap
            q_tile = plan.q_tile if q_tile is None else q_tile
            p_cap = plan.p_cap if p_cap is None else p_cap
            rerank = plan.rerank if rerank is None else rerank
        queries = torch.as_tensor(queries, device=idx.device).float().contiguous()
        q = queries.shape[0]
        views = self.shard_views()
        if not any(views):
            return empty_result(q, k, idx.device)
        pq = idx.quantizer
        if layout == "scan_codes" and pq is None:
            raise ValueError("layout='scan_codes' needs PQ codes; call "
                             "enable_codes() first")
        use_codes = False
        if pq is not None and layout in ("auto", "scan_codes"):
            agg = make_plan(
                rows=sum(int(v.rows) for shard in views for _, v in shard),
                n_leaves=idx.n_leaves, n_queries=q, n_shards=1, k=k,
                probes=probes, layout=layout, impl=impl, model=cost_model,
                calibration=idx.calibration, dim=idx.dim, rerank=rerank,
                code_m=pq.m, code_bits=pq.bits)
            use_codes = agg.layout == "scan_codes"
        lookup = build_lookup(idx.tree, queries, probes=probes)
        scales = fitted_shard_scales(
            idx, views, cost_model=cost_model, n_queries=q, k=k,
            probes=probes, layout="auto" if use_codes else layout, impl=impl)
        live = self._live_counts()
        segs = self.segments
        partials, entries_by_shard = [], []
        pairs = overflow = 0
        pruned = 0
        for shard, scale in zip(views, scales):
            per_seg, ordinals = [], []
            for g, view in shard:
                if live[g] == 0:
                    pruned += 1  # only (-1, inf) sentinels could come out
                    continue
                if use_codes:
                    p = make_plan(
                        rows=view.rows, n_leaves=idx.n_leaves, n_queries=q,
                        n_shards=1, k=k, probes=probes, layout="scan_codes",
                        impl=impl, block_rows=block_rows, q_cap=q_cap,
                        model=cost_model, calibration=idx.calibration,
                        dim=idx.dim, rerank=rerank, code_m=pq.m,
                        code_bits=pq.bits)
                    pinned = q_cap is not None
                else:
                    p = make_plan(
                        rows=view.rows, n_leaves=idx.n_leaves, n_queries=q,
                        n_shards=1, k=k, probes=probes, layout=layout,
                        impl=impl, block_rows=block_rows, q_cap=q_cap,
                        q_tile=q_tile, p_cap=p_cap, model=cost_model,
                        calibration=idx.calibration)
                    # never scale a budget the caller pinned
                    pinned = (q_cap is not None if p.layout == "point_major"
                              else p_cap is not None)
                if not pinned:
                    p = costmodel_lib.scale_slab_budget(
                        p, scale, n_queries=q, shard_rows=view.rows)
                kw = {}
                if use_codes:
                    kw = dict(codes=self._codes(segs[g].name),
                              codebooks=pq.codebooks)
                res = search_with_lookup(view, lookup, p, n_queries=q, **kw)
                per_seg.append(res)
                ordinals.append(g)
                pairs = pairs + res.pairs
                overflow = overflow + res.q_cap_overflow
            if not per_seg:
                continue  # an empty scatter leg, or every segment pruned
            if use_codes:
                entries_by_shard.append(list(zip(ordinals, per_seg)))
            else:
                partials.append(shard_local_partial(per_seg, ordinals, k))
        if pruned:
            get_registry().counter("index.segments_pruned").inc(pruned)
        if not (partials or entries_by_shard):
            return empty_result(q, k, idx.device)
        if use_codes:
            # per-segment candidate widths can differ (rerank clamps to
            # each segment's block_rows); pad to one width so slots agree
            r_max = max(int(r.ids.shape[1]) for e in entries_by_shard
                        for _, r in e)
            partials = [shard_local_partial([_pad_cols(r, r_max) for _, r in e],
                                            [g for g, _ in e], r_max)
                        for e in entries_by_shard]
            cand_ids, _ = gather_merge(partials, r_max)
            segs_ts = dict(segments=self.segments, tombstones=self.tombstones)
            ids, dists = rerank_exact(lambda i: idx.read_rows(i, **segs_ts),
                                      queries, cand_ids, k)
        else:
            ids, dists = gather_merge(partials, k)
        return SearchResult(ids=ids, dists=dists, pairs=pairs,
                            q_cap_overflow=overflow)
