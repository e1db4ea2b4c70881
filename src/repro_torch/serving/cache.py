"""Hot-leaf cache: the in-memory analog of the paper's lookup-table
broadcast (§2.5), specialised to skewed online traffic.

The paper ships auxiliary data (tree + lookup table) to every map task once
per batch job so the scan itself never waits on it. An online service sees
the same effect *across requests*: under a skewed (Zipf) query stream a
small set of tree leaves absorbs most of the routed queries. This cache
pins those leaves' index slabs (vectors, descriptor ids and segment
ordinals, gathered on the index's device) and answers a repeated query
locally -- one K1 launch (``kernels.l2topk.l2_topk``) over exactly the
leaves the engine would have scanned -- without occupying a micro-batch
slot. The JAX package keeps its slabs in host numpy; here they stay on the
index's device, so a hit on the card runs on the card.

Two layers of keying:

  * ``leaf_id -> slab`` -- admitted once a leaf has been routed to
    ``admit_after`` times, evicted when over ``capacity`` leaves;
  * ``query bytes -> probe leaves`` -- the routing memo (host side).
    Routing is a tree descent (device work), so a cache *hit* must not
    need it: only queries whose exact bytes have been routed before can be
    cache-served, which is precisely the hot-repeated-query population the
    cache targets.

Eviction is **cost-aware** by default (``eviction="cost"``): resident
leaves are ranked by predicted *ms saved per resident byte* -- routing
frequency x the engine cost a hit avoids (the serving session feeds the
fitted :class:`~repro_torch.core.engine.costmodel.CostModel`'s predicted
ms/image via :meth:`HotLeafCache.note_engine_cost`) / the slab's resident
bytes -- and the lowest-value-per-byte leaf goes first. A huge lukewarm
slab is evicted before a small hot one even if touched more recently,
so a fixed budget holds the leaves that actually buy tail latency.
``eviction="lru"`` keeps the original recency policy.

A hit equals the engine's answer bit for bit: K1 computes the partial
distance ``||p||^2 - 2 p.q`` in the engine kernels' order of operations,
``||q||^2`` is added as the executors add it, and the candidates are
ordered as the engine's merges order them -- by (distance, segment, probe,
row). Tombstoned rows stay in the slabs as the masked views hold them
(far away, id ``-1``) and degenerate to the ``-1``/``inf`` slot, as in the
engine.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.distance import sq_norms
from repro_torch.kernels.l2topk.ops import l2_topk


def _nbytes(slab) -> int:
    return sum(t.numel() * t.element_size() for t in slab)


class HotLeafCache:
    """Hot-leaf slab cache + routing memo, with hit accounting.

    Args:
      capacity_leaves: resident-leaf budget (0 disables the cache).
      admit_after: leaf routings before a leaf's slab is admitted.
      memo_capacity: routing-memo entries kept (exact query bytes).
      eviction: ``"cost"`` (predicted ms-saved-per-resident-byte, the
        default) or ``"lru"`` (recency — the original policy).

    Raises:
      ValueError: an unknown ``eviction`` policy.
    """

    def __init__(self, capacity_leaves: int, *, admit_after: int = 2,
                 memo_capacity: int = 65536, eviction: str = "cost"):
        if eviction not in ("cost", "lru"):
            raise ValueError(
                f"unknown eviction policy {eviction!r}; want cost|lru"
            )
        self.capacity = int(capacity_leaves)
        self.admit_after = int(admit_after)
        self.memo_capacity = int(memo_capacity)
        self.eviction = eviction
        # leaf -> (vecs, ids, segment ordinals, leaf column), on the device
        self._slabs: OrderedDict[int, tuple] = OrderedDict()
        self._freq: dict[int, int] = {}
        self._memo: OrderedDict[bytes, np.ndarray] = OrderedDict()
        self.hits = 0  # requests answered entirely from cache
        self.misses = 0  # requests that went to the engine
        self.evictions = 0  # slabs dropped to stay within capacity
        self.cost_hint_ms = None  # predicted/measured engine ms a hit saves
        # index-side tables (attach_index)
        self._views = None  # the segments' leaf-sorted indexes
        self._starts = None  # per segment: leaf -> first row (host)
        # unified-registry source (held weakly there): one registry dump
        # carries the cache counters next to the serving/index series
        from repro_torch.obs import get_registry

        get_registry().register_source(
            f"hot_leaf_cache@{id(self):x}", self,
            HotLeafCache.registry_series,
        )

    def registry_series(self) -> dict:
        """The registry view of :meth:`stats` under ``cache.*`` names."""
        s = self.stats()
        return {f"cache.{k}": v for k, v in s.items()}

    # -- index attachment ---------------------------------------------------
    def attach_index(self, views, n_leaves: int) -> None:
        """Point the cache at ``views``: the segments' leaf-sorted indexes
        in segment order (anything with ``vecs``/``ids``/``leaves`` on one
        device, leaves ascending; padding leaves past ``n_leaves`` are never
        reached). Nothing is copied here: each segment's leaf runs are
        located once (``searchsorted``), and a leaf's rows are gathered on
        the device when it is admitted.

        Re-attaching (a serving session refresh after the index grew or
        rows were deleted) drops every admitted slab and memo: a stale
        slab would keep serving pre-delete rows the engine now masks.
        """
        self._slabs.clear()
        self._freq.clear()
        self._memo.clear()
        self._views = tuple(views)
        self._starts = [
            torch.searchsorted(v.leaves, torch.arange(
                n_leaves + 1, dtype=v.leaves.dtype, device=v.leaves.device)
            ).cpu().numpy()
            for v in self._views
        ]

    def _gather(self, leaf: int) -> tuple:
        """Leaf ``leaf``'s rows of every segment, segment-major, each
        segment's run in row order: (vecs, ids, segment ordinals, leaf
        column), on the index's device."""
        parts = [(g, v, int(st[leaf]), int(st[leaf + 1]))
                 for g, (v, st) in enumerate(zip(self._views, self._starts))]
        parts = [(g, v, lo, hi) for g, v, lo, hi in parts if hi > lo]
        v0 = self._views[0]
        if not parts:
            return (v0.vecs.new_zeros((0, v0.vecs.shape[1]), dtype=torch.float32),
                    v0.ids.new_zeros((0,), dtype=torch.int32),
                    v0.ids.new_zeros((0,), dtype=torch.int32),
                    v0.ids.new_zeros((0,), dtype=torch.int32))
        vecs = torch.cat([v.vecs[lo:hi].float() for _, v, lo, hi in parts])
        ids = torch.cat([v.ids[lo:hi].to(torch.int32) for _, v, lo, hi in parts])
        segs = torch.cat([torch.full((hi - lo,), g, dtype=torch.int32,
                                     device=vecs.device)
                          for g, _, lo, hi in parts])
        return vecs, ids, segs, torch.full_like(segs, leaf)

    # -- serve path ---------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self.capacity > 0 and self._views is not None

    @property
    def n_cached_leaves(self) -> int:
        return len(self._slabs)

    @property
    def hit_rate(self) -> float:
        """Hits / (hits + misses); 0.0 on an idle or never-attached cache
        (never a division by zero)."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    @property
    def resident_bytes(self) -> int:
        """Device bytes held by the admitted slabs (vectors, ids, segment
        ordinals and leaf columns)."""
        return sum(_nbytes(slab) for slab in self._slabs.values())

    def note_engine_cost(self, ms_per_image: float | None) -> None:
        """Feed the predicted (fitted cost model) or measured engine
        ms/image a cache hit saves — the numerator of the cost-aware
        eviction score. Folded as an EMA so one outlier dispatch cannot
        flip the ranking; ``None``/non-positive values are ignored."""
        if ms_per_image is None or ms_per_image <= 0:
            return
        ms = float(ms_per_image)
        if self.cost_hint_ms is None:
            self.cost_hint_ms = ms
        else:
            self.cost_hint_ms += 0.25 * (ms - self.cost_hint_ms)

    def _score(self, leaf: int) -> float:
        """Predicted ms saved per resident byte: routing frequency x the
        engine cost a hit avoids / the slab's resident bytes. Without a
        cost hint the hint cancels out of the ranking (frequency per
        byte). Empty slabs score 0 — first out."""
        nbytes = _nbytes(self._slabs[leaf])
        if not nbytes:
            return 0.0
        hint = self.cost_hint_ms if self.cost_hint_ms else 1.0
        return self._freq.get(leaf, 0) * hint / nbytes

    def _evict_one(self) -> None:
        """Drop one slab: the lowest ms-saved-per-byte leaf under
        ``eviction="cost"``, the least-recently-used under ``"lru"``."""
        if self.eviction == "cost":
            victim = min(self._slabs, key=self._score)
            del self._slabs[victim]
        else:
            self._slabs.popitem(last=False)
        self.evictions += 1

    def try_serve(
        self, queries: np.ndarray, k: int
    ) -> tuple[np.ndarray, np.ndarray] | None:
        """Answer a request's query rows entirely from cache, or ``None``.

        Serves only when *every* row's routing is memoised and *every*
        routed leaf is resident -- a partial hit would still cost an engine
        dispatch, so it counts as a miss. A hit is one K1 launch over the
        routed leaves' slabs (ascending leaf order, as K1 needs), one
        lookup row per (query, probe).
        """
        if not self.enabled:
            return None
        routed = []
        for q in queries:
            lv = self._memo.get(np.ascontiguousarray(q).tobytes())
            if lv is None or not all(int(l) in self._slabs for l in lv):
                self.misses += 1
                return None
            routed.append(lv)
        self.hits += 1
        leaves = np.stack(routed)  # (n, probes)
        n, probes = leaves.shape
        out_i = np.full((n, k), -1, np.int32)
        out_d = np.full((n, k), np.inf, np.float32)
        need = np.unique(leaves)  # ascending
        slabs = []
        for l in need:
            self._slabs.move_to_end(int(l))  # LRU touch
            slabs.append(self._slabs[int(l)])
        pv, pid, pseg, pleaf = (torch.cat(t) for t in zip(*slabs))
        if pv.shape[0] == 0:
            return out_i, out_d
        dev = pv.device
        q = torch.as_tensor(np.asarray(queries, np.float32)).to(dev)
        lq = q.repeat_interleave(probes, dim=0)  # row r * probes + j
        q_leaves = torch.as_tensor(leaves.reshape(-1).astype(np.int32)).to(dev)
        width = min(k, pv.shape[0])
        d, rows = l2_topk(pv, pleaf, lq, q_leaves, k=width)
        # the executors' order: ||q||^2 added to the partial distance, then
        # a row that maps to no live id degenerates to -1 / inf
        d = d + sq_norms(lq)[:, None]
        r = rows.clamp(min=0).long()
        ids = torch.where(rows >= 0, pid[r], -1)
        d = torch.where(ids >= 0, d, torch.inf).reshape(n, probes * width)
        ids = ids.reshape(n, probes * width)
        seg = pseg[r].reshape(n, probes * width)
        # candidates come (probe, column)-major, each probe's columns by
        # (distance, segment, row): two stable sorts give the engine's
        # (distance, segment, probe, row) order
        by_seg = torch.sort(seg, dim=1, stable=True).indices
        d, ids = d.gather(1, by_seg), ids.gather(1, by_seg)
        top = torch.sort(d, dim=1, stable=True).indices[:, :k]
        cols = top.shape[1]
        out_d[:, :cols] = d.gather(1, top).cpu().numpy()
        out_i[:, :cols] = ids.gather(1, top).cpu().numpy()
        return out_i, out_d

    # -- learn path (after an engine dispatch) ------------------------------
    def record(self, queries: np.ndarray, probe_leaves: np.ndarray, *,
               exact: bool = True) -> None:
        """Memoise routing for served queries and admit/evict hot leaves.

        ``exact=False`` (the dispatch reported slab-budget overflow) skips
        learning entirely: a cached full-slab scan would *disagree* with
        the starved engine answer for the same query."""
        if not self.enabled or not exact:
            return
        for q, lv in zip(queries, probe_leaves):
            key = np.ascontiguousarray(q).tobytes()
            if key not in self._memo:
                if len(self._memo) >= self.memo_capacity:
                    self._memo.popitem(last=False)
                self._memo[key] = np.asarray(lv, np.int64).copy()
            for l in lv:
                l = int(l)
                self._freq[l] = self._freq.get(l, 0) + 1
                if l in self._slabs:
                    self._slabs.move_to_end(l)
                elif self._freq[l] >= self.admit_after:
                    self._slabs[l] = self._gather(l)
                    while len(self._slabs) > self.capacity:
                        self._evict_one()

    def stats(self) -> dict:
        """Well-formed counters at any lifecycle stage — including a
        cache that was never attached to an index or never served a
        request (all rates defined, no division by zero)."""
        return {
            "enabled": self.enabled,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hit_rate,
            "cached_leaves": self.n_cached_leaves,
            "capacity_leaves": self.capacity,
            "resident_bytes": self.resident_bytes,
            "memo_entries": len(self._memo),
            "eviction": self.eviction,
            "evictions": self.evictions,
            "cost_hint_ms": self.cost_hint_ms,
        }
