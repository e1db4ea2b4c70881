"""Declarative search plans + the auto-planning entry point.

A :class:`SearchPlan` is the static description an executor is built from.
``plan()`` resolves an ``"auto"`` layout or impl and any unset budgets from
the index and query shapes, as the JAX package's ``plan()`` does; *which*
candidate wins is delegated to the cost models of
:mod:`repro_torch.core.engine.costmodel` (fitted > observed > heuristic):

  * ``point_major`` -- the shard sweeps its rows in waves of
    ``block_rows`` against a ``q_cap``-row query slab, carrying a
    ``(rows, k)`` running-best table;
  * ``query_routed`` -- lookup rows go to the shard owning their leaf,
    then each ``q_tile`` query tile reads one ``p_cap`` point slab;
  * ``scan_codes`` -- the point-major sweep over uint8 PQ codes, keeping
    ``rerank`` candidates for an exact rerank.

For the same shapes and the same calibration JSON it picks the same plan
as the JAX package; calibration of another backend is never consulted
(``costmodel``'s module docstring). The model only picks layouts and
budgets: results are bit-identical under every model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core.engine import costmodel as costmodel_lib
from repro_torch.core.engine.costmodel import (
    LAYOUTS,
    CalibrationStore,
    PlanShapes,
)
from repro_torch.device import dtype_name

IMPLS = ("xla", "pallas", "fused", "auto")


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def largest_divisor_leq(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is ``<= cap`` -- O(sqrt n). Used to
    snap requested tile sizes onto the shard grid."""
    if n <= 0:
        raise ValueError(f"{n=} must be positive")
    cap = max(1, min(cap, n))
    best = 1
    for lo in range(1, int(math.isqrt(n)) + 1):
        if n % lo:
            continue
        hi = n // lo
        if lo <= cap and lo > best:
            best = lo
        if hi <= cap and hi > best:
            best = hi
    return best


def bucket_ladder(
    max_queries: int,
    *,
    n_buckets: int = 4,
    min_queries: int = 32,
) -> tuple[int, ...]:
    """Padded batch-size buckets for the serving layer, ascending.

    A geometric ladder from ``max_queries`` down (each rung about half the
    one above), every rung snapped to a *divisor* of ``max_queries`` by
    :func:`largest_divisor_leq`, so a full bucket of small requests
    coalesces exactly into the next rung. Serving sessions build one
    pipeline per rung at warmup; steady-state requests snap up to a rung.
    """
    if max_queries < 1:
        raise ValueError(f"{max_queries=} must be positive")
    min_queries = max(1, min(min_queries, max_queries))
    rungs = {max_queries}
    target = max_queries // 2
    while len(rungs) < n_buckets and target >= min_queries:
        rung = largest_divisor_leq(max_queries, target)
        if rung >= min_queries:  # divisor-poor sizes: no sub-floor rungs
            rungs.add(rung)
        target //= 2
    return tuple(sorted(rungs))


def snap_to_bucket(n: int, buckets) -> int:
    """Smallest warmed bucket that fits ``n`` rows (the largest bucket caps
    it: callers split bigger batches across dispatches)."""
    if n < 1:
        raise ValueError(f"{n=} must be positive")
    fitting = [b for b in buckets if b >= n]
    return min(fitting) if fitting else max(buckets)


@dataclasses.dataclass(frozen=True)
class SearchPlan:
    """Static description of one search execution (hashable).

    ``impl``: ``"xla"`` and ``"pallas"`` both run the per-tile scan through
    ``l2topk.ops.l2_topk`` (``adcscan.ops.adc_topk`` for ``scan_codes``;
    K1/K4 on the card, the plain versions on the CPU); ``"fused"`` runs the
    whole-shard scan (``fusedscan.ops.fused_topk``/``fused_adc_topk``,
    K2/K5 on the card; not for ``query_routed``); ``"auto"`` lets
    ``plan()`` price ``"xla"`` against ``"fused"``. ``None`` budgets mean
    "let ``plan()`` pick"; the executors require them resolved.
    """

    layout: str  # "point_major" | "query_routed" | "scan_codes"
    k: int
    probes: int = 1  # multi-probe width T: leaves visited per query
    impl: str = "xla"
    wire_dtype: Any = torch.float32  # routed-shuffle payload dtype
    # point-major budgets (scan_codes shares them: its code scan is a
    # point-major wave sweep over uint8 code slabs)
    block_rows: int | None = None  # index rows per wave tile
    q_cap: int | None = None  # query-slab rows per tile
    # query-routed budgets
    q_tile: int | None = None  # queries per wave tile
    p_cap: int | None = None  # point-slab rows per query tile
    query_capacity_factor: float = 4.0  # routing headroom for hot shards
    # scan_codes (compressed-tier) parameters
    rerank: int | None = None  # ADC survivors fetched for exact rerank
    code_m: int | None = None  # PQ subvectors (code bytes per row)
    code_bits: int | None = None  # bits per subvector (2**bits centroids)

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(f"unknown layout {self.layout!r}; want {LAYOUTS}")
        if self.impl not in IMPLS:
            raise ValueError(f"unknown impl {self.impl!r}; want {IMPLS}")
        if self.impl == "fused" and self.layout == "query_routed":
            raise ValueError(
                "impl='fused' is not supported for layout 'query_routed' "
                "(the fused scan is a point-major sweep)")
        if self.k < 1:
            raise ValueError(f"{self.k=} must be >= 1")
        if self.probes < 1:
            raise ValueError(f"{self.probes=} must be >= 1")
        if self.rerank is not None and self.rerank < self.k:
            raise ValueError(f"{self.rerank=} must be >= {self.k=}")

    def resolved(self) -> "SearchPlan":
        """Check the budgets this layout needs are set."""
        if self.layout == "query_routed":
            need = ("q_tile", "p_cap")
        elif self.layout == "scan_codes":
            need = ("block_rows", "q_cap", "rerank", "code_m", "code_bits")
        else:
            need = ("block_rows", "q_cap")
        for f in need:
            if getattr(self, f) is None:
                raise ValueError(f"plan field {f!r} unresolved for {self.layout}")
        return self

    def observe(self, ms_per_image: float, *,
                store: CalibrationStore | None = None,
                shapes: PlanShapes | None = None) -> None:
        """Record one measured ms/image for this plan into ``store`` (an
        index's ``Index.calibration``, durable at its next commit), or the
        module default when ``None``; ``shapes`` (the shapes measured at)
        let the observation feed the fitted model."""
        target = (store if store is not None
                  else costmodel_lib.default_calibration())
        target.record(self, ms_per_image, shapes)


def _point_major_budgets(
    p: SearchPlan, *, shard_rows: int, n_leaves: int, q_rows: int,
    n_shards: int
) -> SearchPlan:
    block_rows = p.block_rows or 1024
    block_rows = largest_divisor_leq(shard_rows, block_rows)
    q_cap = p.q_cap
    if q_cap is None:
        # slab must cover the probe-expanded queries of every leaf a block
        # tile spans: expected rows = q_rows * block_rows / global rows,
        # floored by the per-leaf mean; 4x headroom for skew
        expected = max(
            q_rows * block_rows // max(1, shard_rows * n_shards),
            q_rows // max(1, n_leaves),
        )
        q_cap = min(q_rows, max(256, round_up(4 * expected, 8)))
    return dataclasses.replace(p, block_rows=block_rows, q_cap=q_cap)


def default_rerank(k: int, rows: int) -> int:
    """Default exact-rerank depth for the codes layout: generous relative
    to ``k`` (8x, floored at 64) so recall survives the lossy ADC scan,
    capped at 128 (the reference's cap: the K4/K5 lists' capacity; a
    larger depth, as k > 128 gives, runs on the wide kernel) and at the
    corpus itself."""
    return max(k, min(rows, max(8 * k, 64), 128))


def _scan_codes_budgets(
    p: SearchPlan, *, shard_rows: int, n_leaves: int, q_rows: int,
    n_shards: int
) -> SearchPlan:
    """The codes scan is a point-major sweep over uint8 code slabs -- it
    reuses the point-major block/slab derivation, plus a rerank depth."""
    p = _point_major_budgets(
        p, shard_rows=shard_rows, n_leaves=n_leaves, q_rows=q_rows,
        n_shards=n_shards,
    )
    rerank = p.rerank or default_rerank(p.k, shard_rows * n_shards)
    # the running candidate table needs rerank <= block_rows (same bound
    # as k <= block_rows on the dense scan)
    rerank = max(p.k, min(rerank, p.block_rows))
    return dataclasses.replace(p, rerank=rerank)


def _query_routed_budgets(
    p: SearchPlan, *, shard_rows: int, n_leaves: int, q_rows: int,
    n_shards: int
) -> SearchPlan:
    q_tile = p.q_tile or 128
    p_cap = p.p_cap
    if p_cap is None:
        # rows per owned leaf is the global rows per leaf
        avg_leaf = max(1, shard_rows * n_shards // max(1, n_leaves))
        # a q_tile of consecutive sorted queries covers about
        # q_tile / local_rows of the shard's leaf range: when queries are
        # sparse against the leaves the point span grows (and the cost
        # model then prefers point-major); 2x headroom for skew
        local_rows = max(q_tile, q_rows // max(1, n_shards))
        span = shard_rows * q_tile // local_rows
        p_cap = min(
            shard_rows, round_up(max(4096, 16 * avg_leaf, 2 * span), 8))
    return dataclasses.replace(p, q_tile=q_tile, p_cap=p_cap)


def plan(
    *,
    rows: int,
    n_leaves: int,
    n_queries: int,
    n_shards: int,
    k: int,
    probes: int = 1,
    layout: str = "point_major",
    impl: str = "xla",
    block_rows: int | None = None,
    q_cap: int | None = None,
    q_tile: int | None = None,
    p_cap: int | None = None,
    dim: int = 0,
    rerank: int | None = None,
    code_m: int | None = None,
    code_bits: int | None = None,
    model: Any = "auto",
    calibration: CalibrationStore | None = None,
) -> SearchPlan:
    """Resolve a full :class:`SearchPlan` from shapes.

    Args:
      rows: padded index rows (``DistributedIndex.rows``) of the index or
        segment view the plan will scan.
      n_leaves: vocabulary-tree leaf count.
      n_queries: query rows per batch (pre-probe-expansion).
      n_shards: row shards (1 on one GPU).
      k: neighbours returned per query; ``probes``: multi-probe width.
      layout: ``"point_major"`` (the default here, as the port's
        ``batch_search`` has always run), ``"query_routed"``,
        ``"scan_codes"`` (needs ``code_m``/``code_bits``), or ``"auto"``
        (the cost model ranks point-major, query-routed and, with codes,
        scan_codes candidates).
      impl: ``"xla"``, ``"pallas"``, ``"fused"``, or ``"auto"`` (the cost
        model prices ``"xla"`` against ``"fused"`` per candidate layout;
        query-routed only runs ``"xla"``). Fused candidates take the
        tuned block size of the calibration store, if it has one of its
        own backend, unless ``block_rows`` is pinned.
      block_rows/q_cap/q_tile/p_cap: pin a budget instead of deriving it
        (the query-routed shuffle's wire dtype and routing headroom keep
        the reference's defaults, :class:`SearchPlan`'s).
      dim: descriptor dimension (0 = unknown), for the codes pricing.
      rerank: ADC survivors per query for ``scan_codes`` (default
        :func:`default_rerank`); code_m/code_bits: the PQ codes' shape.
      model: ``"auto"`` (fitted > observed > heuristic), ``"heuristic"``,
        ``"observed"``, ``"fitted"``, or a built ``CostModel``.
      calibration: the :class:`CalibrationStore` the calibrated models
        read (``Index.calibration``); ``None``: the module default.

    Raises:
      ValueError: ``probes > n_leaves``; an unknown ``layout``, ``impl``
        or ``model``; ``scan_codes`` without ``code_m``/``code_bits``;
        ``query_routed`` when ``n_leaves`` does not divide over the shards.

    Ties go to the point-major ``"xla"`` baseline under every model, and
    with no calibration every model falls back to the heuristic.
    """
    if probes > n_leaves:
        raise ValueError(f"{probes=} must be <= {n_leaves=}")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; want {IMPLS}")
    shard_rows = max(1, rows // max(1, n_shards))
    q_rows = max(1, n_queries * probes)  # probe-expanded lookup rows
    base = dict(k=k, probes=probes, block_rows=block_rows, q_cap=q_cap,
                q_tile=q_tile, p_cap=p_cap)
    shapes = dict(shard_rows=shard_rows, n_leaves=n_leaves, q_rows=q_rows,
                  n_shards=n_shards)
    store = (calibration if calibration is not None
             else costmodel_lib.default_calibration())

    def impls_for(lay: str) -> tuple[str, ...]:
        if impl != "auto":
            return (impl,)
        # only the point-major sweeps have a fused variant; the xla
        # baseline comes first so ties keep it
        return ("xla", "fused") if lay != "query_routed" else ("xla",)

    def variants(p: SearchPlan) -> list[SearchPlan]:
        """One resolved candidate per impl; fused candidates take the
        store's tuned tile config."""
        out = []
        for i in impls_for(p.layout):
            v = dataclasses.replace(p, impl=i)
            if i == "fused" and block_rows is None:
                cfg = store.tile_config(p.layout, dim, dtype_name(p.wire_dtype))
                if cfg:
                    v = dataclasses.replace(v, block_rows=largest_divisor_leq(
                        shard_rows, int(cfg["block_rows"])))
            out.append(v.resolved())
        return out

    has_codes = code_m is not None and code_bits is not None
    if layout == "scan_codes" and not has_codes:
        raise ValueError(
            "layout='scan_codes' needs code_m/code_bits (the shape of the "
            "index's PQ codes)")
    candidates: list[SearchPlan] = []
    if has_codes:
        sc = _scan_codes_budgets(
            SearchPlan(layout="scan_codes", rerank=rerank, code_m=code_m,
                       code_bits=code_bits, **base), **shapes)
        if layout == "scan_codes":
            candidates = variants(sc)
    pm = _point_major_budgets(SearchPlan(layout="point_major", **base),
                              **shapes)
    if layout == "point_major":
        candidates = variants(pm)
    routable = n_leaves % n_shards == 0
    if layout == "query_routed":
        if not routable:
            raise ValueError(f"{n_leaves=} must divide over {n_shards} shards "
                             "for layout='query_routed'")
        candidates = variants(_query_routed_budgets(
            SearchPlan(layout="query_routed", **base), **shapes))
    elif layout == "auto":
        # baseline first: every model breaks ties toward point-major xla
        candidates = variants(pm)
        if routable and impl != "fused":
            candidates += variants(_query_routed_budgets(
                SearchPlan(layout="query_routed", **base), **shapes))
        if has_codes:
            candidates += variants(sc)
    if not candidates:
        raise ValueError(f"unknown layout {layout!r}")
    if len(candidates) == 1:
        return candidates[0]
    ctx = PlanShapes(rows=rows, n_queries=n_queries, n_shards=n_shards,
                     n_leaves=n_leaves, dim=dim)
    return costmodel_lib.resolve_model(model, calibration).choose(
        tuple(candidates), ctx)
