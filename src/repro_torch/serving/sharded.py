"""Sharded scatter-gather serving: N shard ladders behind one session.

The paper's search phase runs as a fleet of map tasks, each scanning its
partition of the index, with one merge step fusing per-partition candidate
lists (section 2.4). :class:`ShardedSearchSession` is that topology as a
serving layer over a :class:`~repro_torch.index.ShardedIndex`:

  * **scatter** -- every dispatch snaps to a bucket and runs the padded
    query batch through one pipeline *per shard* (each shard owns a full
    bucket ladder over its segments, all built at construction and run
    once by :meth:`~ShardedSearchSession.warmup`);
  * **gather** -- per-shard partials carry global merge *slots*
    (``segment_ordinal * width + column``), so the fuse
    (:func:`repro_torch.index.sharding.gather_merge`) reproduces the
    unsharded stable ascending-distance merge bit for bit: results equal a
    plain :class:`~repro_torch.serving.SearchSession` over the same index
    at any shard count, every layout, any probe width, tombstones
    respected;
  * **above the scatter** -- the hot-leaf cache keys on the pre-scatter
    query bytes and records routing post-gather; the micro-batcher
    coalesces above the session exactly as in the unsharded case.

Placement is the ``ShardedIndex``'s: when the index's mesh splits evenly
over the shards, each shard's rungs run on its own submesh (its own
cards), and its partials come to the index's first device for the
gather; otherwise every shard shares the mesh and the shards run in turn
(the JAX package's one-device regime: same results, summed time).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.codes import rerank_exact
from repro_torch.core.engine import (
    PlanShapes,
    SearchPlan,
    fitted_component,
    plan as make_plan,
    snap_to_bucket,
)
from repro_torch.core.engine.costmodel import plan_signature, signature_key
from repro_torch.core.engine.executors import SearchResult
from repro_torch.index.sharding import (
    ShardedIndex,
    ShardPlan,
    fitted_shard_scales,
    gather_merge,
)
from repro_torch.obs import get_tracer
from repro_torch.serving.session import SearchSession, make_bucket_runtime, sync
from repro_torch.serving.slo import slab_scale_cap


@dataclasses.dataclass
class _ShardedRuntime:
    """One bucket rung, fanned out: one pipeline per non-empty shard."""

    bucket: int  # query-row capacity of this rung
    parts: tuple  # (shard_index, views, _BucketRuntime) per non-empty shard
    plan: SearchPlan  # primary plan (largest shard), for reporting
    plans: tuple  # every resolved per-segment plan across shards
    q_total: int  # largest per-segment padded lookup row count
    plan_rows: tuple = ()  # (plan, rows, n_shards) across shards


class ShardedSearchSession(SearchSession):
    """Scatter-gather :class:`SearchSession`: the same public surface (the
    micro-batcher, trace replay and CLI drive either), shard by shard
    underneath.

    Construct from a ``repro_torch.index.Index`` plus ``shards=N`` (+
    ``shard_strategy``), an explicit ``shard_plan``, or an index whose
    manifest carries a persisted plan; a ``ShardedIndex`` is accepted too.
    ``target_p95_ms`` caps the fitted per-shard slab-headroom multipliers
    (:func:`repro_torch.serving.slo.slab_scale_cap`). Other keywords are
    :class:`SearchSession`'s.

    Raises ``ValueError`` when no shard plan can be resolved, or when an
    explicit plan no longer covers the index's segments after a refresh
    (derivable strategies re-derive).
    """

    def __init__(self, index, tree=None, *, shards: int | None = None,
                 shard_plan: ShardPlan | None = None,
                 shard_strategy: str = "round_robin",
                 target_p95_ms: float | None = None, **session_kw):
        if isinstance(index, ShardedIndex):
            shard_plan = shard_plan or index.plan
            index = index.index
        self._n_shards_arg = shards
        self._shard_plan_arg = shard_plan
        self._strategy_arg = shard_strategy
        self._target_p95_ms = target_p95_ms
        super().__init__(index, tree, **session_kw)

    # -- runtime construction -----------------------------------------------
    def _derive_plan(self, n_shards: int, strategy: str) -> ShardPlan:
        """A plan over the *pinned* segment cut (a concurrent append must
        not leak into the plan this session serves)."""
        segs = self._pin.segments
        if strategy == "round_robin":
            return ShardPlan.round_robin([s.name for s in segs], n_shards)
        if strategy == "balanced":
            return ShardPlan.balanced([s.name for s in segs],
                                      [s.valid_rows for s in segs], n_shards)
        raise ValueError(f"cannot derive a {strategy!r} plan; want one of "
                         "('round_robin', 'balanced')")

    def _resolve_plan(self) -> ShardPlan:
        plan = self._shard_plan_arg
        if plan is None and self._n_shards_arg is not None:
            return self._derive_plan(self._n_shards_arg, self._strategy_arg)
        if plan is None:
            plan = self._pin.shard_plan
        if plan is None:
            raise ValueError(
                "ShardedSearchSession needs shards=N, a shard_plan, or an "
                "index with a persisted shard plan")
        if not plan.covers([s.name for s in self._pin.segments]):
            # raises for explicit plans (they cannot follow a changed cut)
            plan = self._derive_plan(plan.n_shards, plan.strategy)
        return plan

    def _build_runtimes(self) -> None:
        self.sharded = ShardedIndex(
            self.index, plan=self._resolve_plan(),
            segments=self._pin.segments, views=self._pin.views,
            codes=self._pin.codes or None, tombstones=self._pin.tombstones)
        shard_views = self.sharded.shard_views()
        self._shard_codes = {}
        if self._use_codes:
            # device codes by global segment ordinal, placed on the shard's
            # submesh with its views; each shard's rung sees only its own
            # segments' codes
            segs = self.sharded.segments
            for si, shard in enumerate(shard_views):
                if shard:
                    self._shard_codes[si] = tuple(
                        self.sharded._codes(segs[g].name) for g, _ in shard)
        self._runtimes = {}
        for b in self.buckets:
            scales = self._shard_scales(shard_views, b)
            rerank = self._global_rerank(shard_views, b)
            parts = []
            for si, (shard, scale) in enumerate(zip(shard_views, scales)):
                if not shard:
                    continue  # more shards than segments: an empty leg
                views = tuple(v for _, v in shard)
                rt = make_bucket_runtime(
                    self.index.n_leaves, views, b, k=self.k,
                    probes=self.probes, layout=self.serving_layout,
                    impl=self.impl, ordinals=tuple(g for g, _ in shard),
                    emit_slots=True, cost_model=self.cost_model,
                    calibration=self.index.calibration, slab_scale=scale,
                    rerank=rerank, codes=self._shard_codes.get(si),
                    codebooks=self._codebooks_dev)
                parts.append((si, views, rt))
            primary = max(range(len(parts)),
                          key=lambda i: sum(int(v.rows) for v in parts[i][1]))
            self._runtimes[b] = _ShardedRuntime(
                bucket=b, parts=tuple(parts), plan=parts[primary][2].plan,
                plans=tuple(p for _, _, rt in parts for p in rt.plans),
                q_total=max(rt.q_total for _, _, rt in parts),
                # every shard scans the dispatch: the rows-share attribution
                # then covers every executed plan
                plan_rows=tuple(pr for _, _, rt in parts for pr in rt.plan_rows))

    def _global_rerank(self, shard_views, bucket: int) -> int | None:
        """One uniform ADC candidate width for every shard's rung at this
        bucket (the min over all segments' plans), so the gather's slot
        arithmetic stays one global order. ``None`` on dense tiers."""
        if not self._use_codes:
            return None
        pq = self._pin.quantizer
        return min(
            make_plan(rows=view.rows, n_leaves=self.index.n_leaves,
                      n_queries=bucket, n_shards=1, k=self.k,
                      probes=self.probes, layout="scan_codes", impl=self.impl,
                      model=self.cost_model,
                      calibration=self.index.calibration, dim=self.index.dim,
                      rerank=self.rerank, code_m=pq.m,
                      code_bits=pq.bits).rerank
            for shard in shard_views for _, view in shard)

    def _shard_scales(self, shard_views, bucket: int) -> list[float]:
        """Per-shard slab-headroom multipliers for one rung
        (:func:`~repro_torch.index.sharding.fitted_shard_scales`: all ones
        until the calibration yields a fit); with ``target_p95_ms`` the
        ceiling shrinks so a grown dispatch still fits the target."""
        max_scale = 2.0
        if self._target_p95_ms:
            max_scale = slab_scale_cap(
                self._target_p95_ms,
                self._predicted_dispatch_ms(shard_views, bucket))
        return fitted_shard_scales(
            self.index, shard_views, cost_model=self.cost_model,
            n_queries=bucket, k=self.k, probes=self.probes,
            # codes rungs budget like the dense point-major family; the
            # grow-only scales keep any mispricing result-safe
            layout="auto" if self._use_codes else self.layout,
            impl=self.impl, max_scale=max_scale)

    def _predicted_dispatch_ms(self, shard_views, bucket: int) -> float | None:
        """Fitted prediction of one full-bucket dispatch at scale 1: the
        sum of the shards' scans (they run back to back on one card);
        ``None`` when a shard cannot be planned or priced."""
        fitted = fitted_component(self.cost_model, self.index.calibration)
        if fitted is None:
            return None
        total = 0.0
        for shard in shard_views:
            if not shard:
                continue
            rows = sum(int(v.rows) for _, v in shard)
            try:
                p = make_plan(rows=rows, n_leaves=self.index.n_leaves,
                              n_queries=bucket, n_shards=1, k=self.k,
                              probes=self.probes, layout=self.layout,
                              impl=self.impl, model=self.cost_model,
                              calibration=self.index.calibration)
            except ValueError:
                return None
            pred = fitted.predict_ms(p, PlanShapes(
                rows=rows, n_queries=bucket, n_shards=1,
                n_leaves=self.index.n_leaves))
            if pred is None:
                return None
            total += pred
        return total or None

    # -- build accounting -----------------------------------------------------
    def _rungs(self):
        return [rt for rtb in self._runtimes.values() for _, _, rt in rtb.parts]

    def warmup(self) -> float:
        """Run every shard's every rung once on a dummy batch. Returns the
        wall ms."""
        d = self.index.dim
        with get_tracer().span("session.warmup", buckets=len(self.buckets),
                               shards=self.n_shards):
            t0 = time.perf_counter()
            a0 = self._allocator_events()
            for rtb in self._runtimes.values():
                dummy = torch.zeros((rtb.bucket, d), dtype=torch.float32,
                                    device=self.device)
                for si, views, rt in rtb.parts:
                    self._dispatch_shard(si, rt, views, dummy, 0)
            sync(self.device)
            dt_ms = (time.perf_counter() - t0) * 1e3
            self._device_allocs += self._allocator_events() - a0
        self.metrics.warmup_ms += dt_ms
        self._warmed_compiles = self.recompiles()
        self._warmed = True
        return dt_ms

    # -- serve path ----------------------------------------------------------
    def _dispatch_shard(self, si, rt, views, buf, n_valid: int):
        """One shard's pipeline (codes rungs also take that shard's codes
        and the codebook table)."""
        extra = (() if rt.rerank is None
                 else (self._shard_codes[si], self._codebooks_dev))
        res, leaves, slots = rt.fn(views, self.tree, buf, n_valid, *extra)
        # a shard on its own submesh answers there: its partial comes to
        # the index's first device for the gather (queued, no host sync)
        if res.ids.device != self.device:
            res = SearchResult(*(t.to(self.device) for t in (
                res.ids, res.dists, res.pairs, res.q_cap_overflow)))
            slots = slots.to(self.device)
        return res, leaves.to(self.device), slots

    def _execute(self, queries: np.ndarray, *, n_images: int | None = None):
        """Scatter one micro-batch to every shard, gather-merge the
        partials. The unsharded ``_execute``'s contract: returns ``(ids,
        dists, probe_leaves, seconds)``, feeds the metrics, the
        (pre-scatter) hot-leaf cache and the calibration store."""
        n, _ = queries.shape
        if n > self.max_batch_rows:
            raise ValueError(
                f"batch of {n} rows exceeds largest bucket "
                f"{self.max_batch_rows}; split it across dispatches")
        rtb = self._runtimes[snap_to_bucket(n, self.buckets)]
        tr = get_tracer()
        a0 = self._allocator_events()
        t0 = time.perf_counter()
        buf = self._padded(queries, rtb.bucket)
        outs = []
        for si, views, rt in rtb.parts:
            if tr.enabled:
                # per-shard spans need per-shard completion times: wait for
                # each leg (the results are the same either way)
                with tr.span("shard.scan", shard=si, bucket=rtb.bucket,
                             rows=sum(int(v.rows) for v in views),
                             segments=len(views)):
                    outs.append(self._dispatch_shard(si, rt, views, buf, n))
                    sync(self.device)
            else:
                outs.append(self._dispatch_shard(si, rt, views, buf, n))
        # codes rungs gather CANDIDATE tables (one width, slot-tagged), then
        # one exact rerank gives the final top-k
        width = rtb.parts[0][2].rerank or self.k
        with tr.span("gather.merge", shards=len(rtb.parts), rows=n):
            ids_t, dists_t = gather_merge(
                [(res.ids[:n], res.dists[:n], slots[:n])
                 for res, _leaves, slots in outs], width)
        if self._use_codes:
            with tr.span("engine.rerank", k=self.k, candidates=width):
                ids_t, dists_t = rerank_exact(self._read_pinned_rows, buf[:n],
                                              ids_t, self.k)
        sync(self.device)
        dt = time.perf_counter() - t0
        self._device_allocs += self._allocator_events() - a0
        if tr.enabled:
            t1 = tr.now()
            tr.add_span(
                "engine.execute", t1 - dt, t1, rows=n, bucket=rtb.bucket,
                layout=rtb.plan.layout, shards=len(rtb.parts),
                plan=signature_key(plan_signature(rtb.plan)),
                cost_model=self.active_cost_model())
        ids, dists = ids_t.cpu().numpy(), dists_t.cpu().numpy()
        # every shard routes the same queries through the same tree: the
        # first shard's probe-leaf matrix is THE routing
        leaves_np = outs[0][1][:n].cpu().numpy()
        overflow = sum(int(res.q_cap_overflow) for res, _, _ in outs)
        self._account(rtb, n, dt, overflow, n_images)
        if not self._use_codes:
            self.cache.record(queries, leaves_np, exact=overflow == 0)
        return ids, dists, leaves_np, dt

    # -- reporting ------------------------------------------------------------
    @property
    def n_shards(self) -> int:
        return self.sharded.n_shards

    @property
    def shard_plan(self) -> ShardPlan:
        return self.sharded.plan

    def per_shard_stats(self) -> dict:
        """The bound plan plus rows and segments per shard."""
        return self.sharded.stats()

    def plan_summary(self) -> list[dict]:
        return [
            {
                "bucket": rtb.bucket,
                "cost_model": self.cost_model,
                "layout": rtb.plan.layout,
                "impl": rtb.plan.impl,
                "q_total": rtb.q_total,
                "block_rows": rtb.plan.block_rows,
                "q_cap": rtb.plan.q_cap,
                "q_tile": rtb.plan.q_tile,
                "p_cap": rtb.plan.p_cap,
                "rerank": rtb.plan.rerank,
                "segments": len(rtb.plans),
                "shards": len(rtb.parts),
            }
            for rtb in self._runtimes.values()
        ]
