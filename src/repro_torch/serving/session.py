"""SearchSession: the long-lived serving core, on one device.

The paper's search phase is a batch job: build (or load) the index, ship
the lookup table, scan. A *service* runs the same engine continuously. The
JAX package's session exists to keep XLA from recompiling per batch shape;
here the same structure keeps the steady state free of new pipelines:

  * **Index-backed** -- a session serves one :class:`repro_torch.index.Index`
    (a legacy ``(DistributedIndex, tree)`` pair is wrapped in an ephemeral
    single-segment index). Each bucket rung holds ONE pipeline that builds
    the lookup once and runs every segment's executor over it, merging the
    per-segment k-NN tables on the device with a stable sort, so a grown,
    multi-segment index answers bit-identically to ``Index.search``;
  * **load-or-build** -- ``Index.open`` when a committed manifest exists,
    else build + commit (index-once / serve-many across restarts);
  * **bucketed pipelines** -- a small ladder of padded batch sizes
    (``engine.bucket_ladder``), one pipeline per rung (probe routing ->
    fixed-shape lookup -> executors -> merge), built at construction and
    run once by :meth:`SearchSession.warmup`. Requests snap up to a rung
    (``snap_to_bucket``) with the valid-row count passed as a Python int,
    so rows past it get the pad leaf and never reach a lookup row;
  * **build accounting** -- :meth:`SearchSession.recompiles` counts the
    executors this session built (at construction and at every refresh:
    a dispatch never builds one) and, on the card, the caching
    allocator's new device segments and allocation retries during its
    dispatches -- the device work a warmed rung must not need again;
    :meth:`steady_state_recompiles` is what came after warmup (the serving
    invariant: 0);
  * **hot-leaf cache** -- ``serving.cache.HotLeafCache`` answers repeated
    hot queries from leaf slabs on the index's device, through K1 (see its
    docstring);
  * **metrics** -- ``serving.metrics.ServingMetrics``, and the measured
    ms/image of every post-warmup dispatch recorded into the index's
    calibration store (``Index.commit`` persists it), under this device's
    backend -- what ``plan(layout="auto")`` consults next.

An engine time runs from the host-to-device copy of the padded batch to
the synchronised end of its work on the card (``torch.cuda.synchronize``),
as the JAX package times ``jnp.asarray`` through ``block_until_ready``:
the micro-batcher's virtual clock advances by it.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Sequence

import numpy as np
import torch

from repro_torch.codes import rerank_exact
from repro_torch.core.engine import (
    PlanShapes,
    SearchPlan,
    bucket_ladder,
    fitted_component,
    make_executor,
    plan as make_plan,
    resolve_model,
    scale_slab_budget,
    snap_to_bucket,
)
from repro_torch.core.engine.costmodel import plan_signature, signature_key
from repro_torch.core.engine.executors import SearchResult, pad_lookup
from repro_torch.core.index_build import DistributedIndex
from repro_torch.core.lookup import build_lookup_bucketed
from repro_torch.core.search import lookup_q_total
from repro_torch.core.tree import VocabTree
from repro_torch.distributed.meshutil import DeviceMesh, as_mesh
from repro_torch.index import Index, has_index, has_legacy_index
from repro_torch.obs import get_tracer
from repro_torch.serving.cache import HotLeafCache
from repro_torch.serving.metrics import ServingMetrics


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class _BucketRuntime:
    """One rung: per-segment plans + one pipeline over all segments."""

    bucket: int  # query-row capacity of this rung
    plan: SearchPlan  # primary plan (largest segment), for reporting
    plans: tuple  # one resolved plan per segment
    q_total: int  # largest per-segment padded lookup row count
    fn: object  # (segments, tree, queries, n_valid[, codes, codebooks])
    plan_rows: tuple = ()  # (unscaled plan, rows, n_shards) per segment
    # scan_codes rungs only: the uniform ADC candidate width the pipeline
    # emits (the caller reranks exactly)
    rerank: int | None = None
    builds: int = 0  # executors built for this rung (one per segment)


def make_bucket_runtime(
    n_leaves: int,
    segments,
    bucket: int,
    *,
    k: int,
    probes: int,
    layout: str,
    impl: str,
    ordinals=None,
    emit_slots: bool = False,
    cost_model="auto",
    calibration=None,
    slab_scale: float = 1.0,
    rerank: int | None = None,
    codes=None,
    codebooks=None,
) -> _BucketRuntime:
    """Build one bucket rung over ``segments`` (masked segment views).

    ``cost_model``/``calibration`` pick the model that ranks an ``"auto"``
    layout; ``slab_scale`` grows each segment plan's slab budget (the
    sharded session's fitted per-shard headroom; never shrinks, so it is
    result-safe).

    The pipeline runs ONE lookup build (probe routing + leaf sort) shared
    by every segment, then each segment's executor over it, then the
    cross-segment ascending-distance merge on the device: a stable sort,
    so ties keep segment-major order, as ``Index.search`` merges.

    ``ordinals`` are the segments' global append positions (default
    ``0..len-1``). With ``emit_slots=True`` the pipeline returns
    ``(result, leaves, slots)`` where ``slots[q, j] = ordinal * width +
    column`` is each candidate's position in the global segment-ordered
    concatenation -- the key the sharded gather merge fuses partials by.
    """
    if ordinals is None:
        ordinals = tuple(range(len(segments)))
    q_rows = bucket * probes
    use_codes = layout == "scan_codes"
    code_kw = {}
    if use_codes:
        if codes is None or codebooks is None:
            raise ValueError("scan_codes rungs need codes + codebooks")
        m, n_centers, dsub = codebooks.shape
        code_kw = dict(dim=m * dsub, rerank=rerank, code_m=int(m),
                       code_bits=int(n_centers).bit_length() - 1)

    def base_plan(view, rerank_override=None):
        kw = dict(code_kw)
        if rerank_override is not None:
            kw["rerank"] = rerank_override
        return make_plan(rows=view.rows, n_leaves=n_leaves, n_queries=bucket,
                         n_shards=view.n_shards, k=k, probes=probes,
                         layout=layout,
                         impl=impl, model=cost_model, calibration=calibration,
                         **kw)

    base_plans = [base_plan(view) for view in segments]
    r = k
    if use_codes:
        # one uniform ADC candidate width across segments (each plan may
        # clamp rerank to its own block_rows): the min is valid everywhere
        # and keeps the merge's slot arithmetic a single stride
        r = min(p.rerank for p in base_plans)
        base_plans = [p if p.rerank == r else base_plan(view, rerank_override=r)
                      for p, view in zip(base_plans, segments)]
    plans, q_totals, execs = [], [], []
    for base_p, view in zip(base_plans, segments):
        ns = view.n_shards
        p = scale_slab_budget(base_p, slab_scale, n_queries=bucket,
                              shard_rows=view.rows // ns)
        q_total = lookup_q_total(p, bucket, ns)
        execs.append(make_executor(p, n_leaves=n_leaves,
                                   shard_rows=view.rows // ns, q_total=q_total,
                                   n_shards=ns))
        plans.append(p)
        q_totals.append(q_total)
    primary = max(range(len(plans)), key=lambda i: segments[i].rows)
    width = r if use_codes else k
    slot_row = None
    if emit_slots:
        slot_row = torch.cat([
            torch.arange(g * width, g * width + width, dtype=torch.int32)
            for g in ordinals]).to(segments[0].device)

    def merge(outs, leaves):
        if len(outs) == 1 and not emit_slots:
            return outs[0], leaves
        all_d = torch.cat([o.dists[:bucket] for o in outs], dim=1)
        all_i = torch.cat([o.ids[:bucket] for o in outs], dim=1)
        # stable: ties keep the concatenation's (segment-major) order
        sel = torch.sort(all_d, dim=1, stable=True).indices[:, :width]
        merged = SearchResult(
            ids=torch.gather(all_i, 1, sel),
            dists=torch.gather(all_d, 1, sel),
            pairs=sum(o.pairs for o in outs),
            q_cap_overflow=sum(o.q_cap_overflow for o in outs))
        if emit_slots:
            return merged, leaves, slot_row[sel]
        return merged, leaves

    def pipeline(segs, tree, queries, n_valid, seg_codes=None, cbs=None):
        lookup, leaves = build_lookup_bucketed(tree, queries, n_valid,
                                               probes=probes, q_total=q_rows)
        if use_codes:
            outs = [fn(seg, pad_lookup(lookup, qt), c, cbs)
                    for seg, fn, qt, c in zip(segs, execs, q_totals, seg_codes)]
        else:
            outs = [fn(seg, pad_lookup(lookup, qt))
                    for seg, fn, qt in zip(segs, execs, q_totals)]
        return merge(outs, leaves)

    return _BucketRuntime(
        bucket=bucket, plan=plans[primary], plans=tuple(plans),
        q_total=max(q_totals), fn=pipeline,
        # calibration keys on the UNSCALED plans: what a later plan()
        # consult derives, before any slab scaling
        plan_rows=tuple((bp, int(v.rows), v.n_shards)
                        for bp, v in zip(base_plans, segments)),
        rerank=r if use_codes else None, builds=len(execs))


def attach_cache(cache: HotLeafCache, views, n_leaves: int) -> None:
    """Point a hot-leaf cache at ``views`` (the masked segment views, on
    the index's device): tombstoned rows keep their masked id ``-1``, so a
    cached slab can never resurrect a deleted row. Does nothing when the
    cache is off (capacity 0)."""
    if cache.capacity > 0:
        cache.attach_index(views, n_leaves)


def load_or_build_index(index_dir: str | None, *, build_fn, device="cuda",
                        mesh: DeviceMesh | None = None, rebuild: bool = False):
    """Index-once / serve-many: ``Index.open`` when ``index_dir`` holds a
    committed non-empty manifest, else ``build_fn()``, committed there
    (when a directory is given).

    ``build_fn`` returns either ``(built, tree, extra)`` (a
    ``DistributedIndex`` or ``MeshIndex``, its tree and metadata;
    committed here as one segment) or an already-committed
    :class:`~repro_torch.index.Index`. The index lives on ``mesh``
    (default: one shard on ``device``); a directory of another shard count
    raises. Returns ``(index, meta)``; ``meta["restored"]`` says which
    path ran. A directory in the pre-segment ``index_ckpt/`` format is
    rebuilt, with a warning (``Index.open`` on it raises).
    """
    mesh = as_mesh(mesh, device)
    if index_dir and not rebuild and has_index(index_dir):
        opened = Index.open(index_dir, mesh=mesh)
        if opened.n_segments:
            return opened, dict(opened.meta, restored=True)
        # a crash between create and the first commit left a committed
        # empty index: rebuild instead of serving nothing
    if index_dir and not has_index(index_dir) and has_legacy_index(index_dir):
        warnings.warn(
            f"{index_dir} holds a pre-segment-format index (index_ckpt/), "
            "which this version no longer reads; rebuilding it in the "
            "segment format", stacklevel=2)
    out = build_fn()
    if isinstance(out, Index):
        return out, dict(out.meta, restored=False)
    built, tree, extra = out
    idx = Index.create(tree, index_dir or None, mesh=mesh, extra=extra,
                       overwrite=True)
    idx.append_built(built)
    idx.commit()
    return idx, dict(extra or {}, restored=False)


class SearchSession:
    """Long-lived search service over one :class:`repro_torch.index.Index`,
    on the index's device.

    Args:
      index: a ``repro_torch.index.Index``, or (legacy) a
        ``DistributedIndex`` with its ``tree`` as the second argument.
      k/layout/probes/impl: the serving plan knobs (see
        :func:`repro_torch.core.engine.plan`). ``layout`` also takes
        ``"scan_codes"`` on an index with PQ codes; with ``"auto"`` the
        cost model may pick the codes tier. That decision is made once per
        session, so every rung serves the same tier.
      rerank: ADC candidates per query to rerank exactly on the codes tier.
      cost_model: which cost model ranks an ``"auto"`` layout, consulting
        the index's calibration store; post-warmup dispatches record their
        measured ms/image back into it (durable at the index's next
        ``commit``).
      max_batch_rows/n_buckets/buckets: the bucket ladder (explicit
        ``buckets`` override the derived geometric ladder).
      cache_leaves/cache_admit_after/cache_eviction: the hot-leaf cache's
        capacity (0 = off), admission threshold and eviction policy.

    Raises:
      TypeError: a non-``Index`` first argument without its ``tree``.
      ValueError: an index with no segments, or ``scan_codes`` without
        codes.
    """

    def __init__(
        self,
        index,
        tree: VocabTree | None = None,
        *,
        k: int = 10,
        layout: str = "auto",
        probes: int = 1,
        impl: str = "xla",
        rerank: int | None = None,
        max_batch_rows: int = 4096,
        n_buckets: int = 3,
        buckets: Sequence[int] | None = None,
        cache_leaves: int = 0,
        cache_admit_after: int = 2,
        cache_eviction: str = "cost",
        cost_model: str = "auto",
    ):
        if isinstance(index, Index):
            self.index = index
        else:
            if not isinstance(index, DistributedIndex) or tree is None:
                raise TypeError(
                    "SearchSession takes a repro_torch.index.Index, or the "
                    "legacy (DistributedIndex, tree) pair")
            self.index = Index.from_built(index, tree)
        self.tree = self.index.tree
        self.device = self.index.device
        # pin one consistent cut of the index: every rung, cache slab and
        # rerank fetch resolves against it until refresh()/maybe_refresh()
        self._pin = self.index.snapshot()
        self._segments = self._pin.views
        if not self._segments:
            raise ValueError("cannot serve an index with no segments")
        self.k = int(k)
        self.layout = layout
        self.probes = int(probes)
        self.impl = impl
        self.rerank = rerank
        self.cost_model = cost_model
        self.buckets = (tuple(sorted(int(b) for b in buckets)) if buckets
                        else bucket_ladder(max_batch_rows, n_buckets=n_buckets))
        pq = self._pin.quantizer
        if layout == "scan_codes" and pq is None:
            raise ValueError("layout='scan_codes' needs PQ codes; call "
                             "index.enable_codes() first")
        # codes-vs-exact resolves ONCE on the aggregate shape (ADC and exact
        # distances are incomparable across a merge)
        self._use_codes = False
        if pq is not None and layout in ("auto", "scan_codes"):
            agg = make_plan(
                rows=sum(int(v.rows) for v in self._segments),
                n_leaves=self.index.n_leaves, n_queries=self.buckets[-1],
                n_shards=self.index.mesh.n_shards, k=self.k,
                probes=self.probes, layout=layout,
                impl=impl, model=cost_model,
                calibration=self.index.calibration, dim=self.index.dim,
                rerank=rerank, code_m=pq.m, code_bits=pq.bits)
            self._use_codes = agg.layout == "scan_codes"
        self._codes_dev = self._codebooks_dev = None
        if self._use_codes:
            self._refresh_codes()
        self.metrics = ServingMetrics()
        self.cache = HotLeafCache(cache_leaves, admit_after=cache_admit_after,
                                  eviction=cache_eviction)
        self._builds = 0  # executors built by this session
        self._device_allocs = 0  # allocator segments + retries in dispatches
        self._attach_cache()
        self._warmed_compiles: int | None = None
        self._rebuild()
        # seed the cache's eviction score with the model's view of what
        # one engine-served image costs (the measured EMA refines it)
        self.cache.note_engine_cost(self.predicted_ms_per_image())

    def _attach_cache(self) -> None:
        attach_cache(self.cache, self._segments, self.index.n_leaves)

    def _refresh_codes(self) -> None:
        """Each pinned segment's PQ codes + the codebook table on the
        device, aligned with ``self._segments``."""
        self._codes_dev = tuple(self._pin.codes[s.name]
                                for s in self._pin.segments)
        self._codebooks_dev = torch.as_tensor(self._pin.quantizer.codebooks,
                                              device=self.device)

    def _read_pinned_rows(self, ids) -> torch.Tensor:
        """Rerank row fetches against the pinned cut: a concurrent delete
        or compaction cannot make an in-flight candidate unreadable."""
        return self.index.read_rows(ids, segments=self._pin.segments,
                                    tombstones=self._pin.tombstones)

    @property
    def serving_layout(self) -> str:
        """The layout the rungs execute (``layout`` with the session's
        one-time codes decision applied)."""
        return "scan_codes" if self._use_codes else self.layout

    def _build_runtimes(self) -> None:
        """One runtime per bucket rung (the sharded session builds one per
        (shard, bucket) pair instead)."""
        self._runtimes = {b: self._make_runtime(b) for b in self.buckets}

    def _rebuild(self) -> None:
        """Build the rungs over the pinned cut, counting their executors;
        they serve unwarmed until the next :meth:`warmup`."""
        self._build_runtimes()
        self._builds += sum(rt.builds for rt in self._rungs())
        self._warmed = False

    # -- construction -------------------------------------------------------
    @classmethod
    def load_or_build(cls, index_dir: str | None, *, build_fn, device="cuda",
                      rebuild: bool = False, **session_kw):
        """:func:`load_or_build_index`, then a session over the index.
        Returns ``(session, meta)``."""
        idx, meta = load_or_build_index(index_dir, build_fn=build_fn,
                                        device=device, rebuild=rebuild)
        return cls(idx, **session_kw), meta

    @property
    def pinned_version(self) -> int:
        """The manifest version this session serves (the snapshot pinned
        at construction or the last refresh)."""
        return self._pin.version

    def refresh(self) -> None:
        """Re-pin the index's current state and rebuild the rungs; warm
        them with :meth:`warmup` (prefer :meth:`maybe_refresh`, which
        warms before it returns). Until then the rebuilt executors count
        as steady-state recompiles."""
        self._adopt(self.index.snapshot())

    def maybe_refresh(self) -> bool:
        """Adopt the index's latest state iff it changed since the pin --
        the serve loop's read-during-write hook, O(1) when nothing changed.
        On change the new snapshot's rungs are built AND warmed before this
        returns, so queued requests never see a half-adopted index. An
        index mutated down to zero segments keeps the old pin. Returns
        ``True`` when a new snapshot was adopted."""
        if self.index.stamp == self._pin.stamp:
            return False
        snap = self.index.snapshot()
        if not snap.segments:
            return False
        self._adopt(snap)
        self.warmup()
        return True

    def _adopt(self, snap) -> None:
        self._pin = snap
        self._segments = snap.views
        self._attach_cache()
        if self._use_codes:
            self._refresh_codes()
        self._rebuild()

    def _make_runtime(self, bucket: int) -> _BucketRuntime:
        return make_bucket_runtime(
            self.index.n_leaves, self._segments, bucket, k=self.k,
            probes=self.probes, layout=self.serving_layout, impl=self.impl,
            cost_model=self.cost_model, calibration=self.index.calibration,
            rerank=self.rerank, codes=self._codes_dev,
            codebooks=self._codebooks_dev)

    def active_cost_model(self) -> str:
        """Which model currently decides (e.g. ``"auto(fitted)"``)."""
        return resolve_model(self.cost_model,
                             self.index.calibration).describe()

    def predicted_ms_per_image(self, bucket: int | None = None) -> float | None:
        """Modelled engine ms per image for one dispatch at ``bucket``
        (default: the largest rung): the fitted model summed over the
        rung's per-segment plans, else the calibration store's
        exact-signature means, else this session's measured ms/image;
        ``None`` when nothing can price it."""
        b = self.buckets[-1] if bucket is None else snap_to_bucket(
            min(int(bucket), self.max_batch_rows), self.buckets)
        rt = self._runtimes[b]
        fitted = fitted_component(self.cost_model, self.index.calibration)
        for model in (fitted, self.index.calibration):
            if model is None:
                continue
            preds = [
                model.predict_ms(p, PlanShapes(
                    rows=rows, n_queries=rt.bucket, n_shards=ns,
                    n_leaves=self.index.n_leaves, dim=self._shapes_dim(p)))
                if fitted is model else model.mean_ms(p)
                for p, rows, ns in rt.plan_rows
            ]
            if all(v is not None for v in preds):
                total = float(sum(preds))
                if total > 0:
                    return total
        if self.metrics.engine_images:
            return self.metrics.ms_per_image
        return None

    # -- build accounting ---------------------------------------------------
    def _rungs(self):
        """Every rung runtime (the sharded session: every shard's)."""
        return self._runtimes.values()

    def recompiles(self) -> int:
        """Builds so far: the executors this session built (construction
        and every refresh), plus -- on the card -- the caching allocator's
        new device segments and allocation retries during its warmups and
        dispatches."""
        return self._builds + self._device_allocs

    def steady_state_recompiles(self) -> int:
        """Builds after the last warmup: executors of a refresh not yet
        warmed, and device memory a warmed rung allocated anew. The
        serving invariant is 0."""
        if self._warmed_compiles is None:
            return 0
        n = self.recompiles() - self._warmed_compiles
        self.metrics.recompiles_after_warmup = n
        return n

    def _allocator_events(self) -> int:
        """The caching allocator's device segments allocated + allocation
        retries so far in this process (0 on the CPU)."""
        if self.device.type != "cuda":
            return 0
        st = torch.cuda.memory_stats(self.device)
        return (int(st.get("segment.all.allocated", 0))
                + int(st.get("num_alloc_retries", 0)))

    def warmup(self) -> float:
        """Run every rung once on a dummy batch (no valid rows), so the
        steady state only replays built pipelines. Returns the wall ms
        (also folded into the metrics)."""
        d = self.index.dim
        with get_tracer().span("session.warmup", buckets=len(self.buckets)):
            t0 = time.perf_counter()
            a0 = self._allocator_events()
            for rt in self._runtimes.values():
                dummy = torch.zeros((rt.bucket, d), dtype=torch.float32,
                                    device=self.device)
                self._dispatch(rt, dummy, 0)
            sync(self.device)
            dt_ms = (time.perf_counter() - t0) * 1e3
            self._device_allocs += self._allocator_events() - a0
        self.metrics.warmup_ms += dt_ms
        self._warmed_compiles = self.recompiles()
        self._warmed = True
        return dt_ms

    # -- serve path ---------------------------------------------------------
    @property
    def max_batch_rows(self) -> int:
        return self.buckets[-1]

    def _dispatch(self, rt: _BucketRuntime, buf, n_valid: int):
        """One rung's pipeline (codes rungs also take the device codes and
        the codebook table)."""
        extra = (() if rt.rerank is None
                 else (self._codes_dev, self._codebooks_dev))
        return rt.fn(self._segments, self.tree, buf, n_valid, *extra)

    def _padded(self, queries: np.ndarray, bucket: int) -> torch.Tensor:
        n, d = queries.shape
        buf = torch.zeros((bucket, d), dtype=torch.float32, device=self.device)
        buf[:n] = torch.as_tensor(queries, device=self.device)
        return buf

    def _execute(self, queries: np.ndarray, *, n_images: int | None = None):
        """Run one micro-batch through its snapped rung.

        Returns ``(ids (n,k), dists (n,k), probe_leaves (n,probes),
        seconds)`` as numpy; feeds the metrics, the hot-leaf cache and the
        calibration store.
        """
        n, _ = queries.shape
        if n > self.max_batch_rows:
            raise ValueError(
                f"batch of {n} rows exceeds largest bucket "
                f"{self.max_batch_rows}; split it across dispatches")
        rt = self._runtimes[snap_to_bucket(n, self.buckets)]
        a0 = self._allocator_events()
        t0 = time.perf_counter()
        buf = self._padded(queries, rt.bucket)
        res, leaves = self._dispatch(rt, buf, n)
        ids_t, dists_t = res.ids[:n], res.dists[:n]
        tr = get_tracer()
        if self._use_codes:
            # the rung emitted rt.rerank ADC candidates per query: rerank
            # them exactly (the rerank is part of serving the request)
            with tr.span("engine.rerank", k=self.k,
                         candidates=int(ids_t.shape[1])):
                ids_t, dists_t = rerank_exact(self._read_pinned_rows, buf[:n],
                                              ids_t, self.k)
        sync(self.device)
        dt = time.perf_counter() - t0
        self._device_allocs += self._allocator_events() - a0
        ids, dists = ids_t.cpu().numpy(), dists_t.cpu().numpy()
        leaves_np = leaves[:n].cpu().numpy()
        if tr.enabled:
            t1 = tr.now()
            tr.add_span(
                "engine.execute", t1 - dt, t1, rows=n, bucket=rt.bucket,
                layout=rt.plan.layout, segments=len(rt.plans),
                plan=signature_key(plan_signature(rt.plan)),
                cost_model=self.active_cost_model())
        overflow = int(res.q_cap_overflow)
        self._account(rt, n, dt, overflow, n_images)
        if not self._use_codes:
            # a starved dispatch must not seed the cache (a cached full-slab
            # scan would disagree with the truncated engine answer); codes
            # sessions never seed it (a hit would answer with exact scans)
            self.cache.record(queries, leaves_np, exact=overflow == 0)
        return ids, dists, leaves_np, dt

    def _account(self, rt, n: int, dt: float, overflow: int,
                 n_images: int | None) -> None:
        m = self.metrics
        m.engine_batches += 1
        m.engine_ms += dt * 1e3
        m.query_rows += n
        m.q_cap_overflow += overflow
        if n_images:
            m.engine_images += n_images
            self._record_calibration(rt, dt * 1e3 / n_images)
            self.cache.note_engine_cost(dt * 1e3 / n_images)

    def search(self, queries: np.ndarray, *, n_images: int | None = None):
        """One-shot search of ``(n, d)`` query rows.

        Args:
          queries: ``(n, d)`` float rows; batches larger than the top
            bucket are split across dispatches.
          n_images: images this batch represents -- feeds the ms/image
            metric and the calibration store when given.

        Returns ``(ids, dists)``, numpy ``(n, k)`` each: bit-identical to
        ``Index.search`` under the same plans.
        """
        queries = np.asarray(queries, np.float32)
        if len(queries) <= self.max_batch_rows:
            ids, dists, _, _ = self._execute(queries, n_images=n_images)
            return ids, dists
        # split batches: per-chunk observations would attribute the whole
        # request's images to one chunk's time, so only the aggregate
        # image count is fed
        out_i, out_d = [], []
        for s in range(0, len(queries), self.max_batch_rows):
            ids, dists, _, _ = self._execute(queries[s:s + self.max_batch_rows])
            out_i.append(ids)
            out_d.append(dists)
        if n_images:
            self.metrics.engine_images += n_images
        return np.concatenate(out_i), np.concatenate(out_d)

    def serve_many(self, request_batches) -> list[tuple[np.ndarray, np.ndarray]]:
        """Serve a coalesced micro-batch in one dispatch: one ``(ids,
        dists)`` pair per request, in order.

        Raises:
          ValueError: the concatenated batch exceeds the largest bucket.
        """
        sizes = [len(q) for q in request_batches]
        ids, dists, _, _ = self._execute(
            np.concatenate(request_batches).astype(np.float32, copy=False),
            n_images=len(request_batches))
        out, off = [], 0
        for s in sizes:
            out.append((ids[off:off + s], dists[off:off + s]))
            off += s
        return out

    def _record_calibration(self, rt, ms_per_image: float) -> None:
        """Measured ms/image -> the index's calibration store, split over
        the rung's per-segment plans by row share, at the unscaled plans'
        shapes (what the next per-segment ``plan()`` consult asks about).
        Only on warmed rungs: a first run must not taint the records."""
        if not self._warmed:
            return
        total = sum(r for _, r, _ in rt.plan_rows) or 1
        for p, rows, n_shards in rt.plan_rows:
            p.observe(ms_per_image * rows / total,
                      store=self.index.calibration,
                      shapes=PlanShapes(rows=rows, n_queries=rt.bucket,
                                        n_shards=n_shards,
                                        n_leaves=self.index.n_leaves,
                                        dim=self._shapes_dim(p)))

    def _shapes_dim(self, p: SearchPlan) -> int:
        """``PlanShapes.dim``: the codes tier prices by dim, the dense
        layouts record ``dim=0``, as every dense consult asks."""
        return self.index.dim if p.layout == "scan_codes" else 0

    def plan_summary(self) -> list[dict]:
        return [
            {
                "bucket": rt.bucket,
                "cost_model": self.cost_model,
                "layout": rt.plan.layout,
                "impl": rt.plan.impl,
                "q_total": rt.q_total,
                "block_rows": rt.plan.block_rows,
                "q_cap": rt.plan.q_cap,
                "q_tile": rt.plan.q_tile,
                "p_cap": rt.plan.p_cap,
                "rerank": rt.plan.rerank,
                "segments": len(rt.plans),
            }
            for rt in self._runtimes.values()
        ]
