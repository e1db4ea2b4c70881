"""Declarative search plans: the point-major and codes layouts.

A :class:`SearchPlan` is the static description an executor is built from.
``plan()`` resolves unset budgets from the index and query shapes. The port
runs the point-major and ``scan_codes`` layouts with a fixed ``impl``: the
one-candidate branches of the JAX package's ``plan()``, so no cost model is
involved. The query-routed layout (ROADMAP M7) and
``impl="auto"``/``layout="auto"`` (the cost model, M10) raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math

LAYOUTS = ("point_major", "query_routed", "scan_codes")
IMPLS = ("xla", "pallas", "fused", "auto")

_NOT_PORTED = {
    "query_routed": "the query-routed layout is ROADMAP M7",
    "auto": "layout='auto' needs the cost model, ROADMAP M10",
}


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


def _check_ported(layout: str, impl: str) -> None:
    if layout in _NOT_PORTED:
        raise NotImplementedError(f"layout={layout!r}: {_NOT_PORTED[layout]}")
    if impl == "auto":
        raise NotImplementedError(
            "impl='auto' needs the cost model, ROADMAP M10")


@dataclasses.dataclass(frozen=True)
class SearchPlan:
    """Static description of one search execution (hashable).

    ``impl``: ``"xla"`` and ``"pallas"`` both run the per-wave sweep through
    ``l2topk.ops.l2_topk`` (``adcscan.ops.adc_topk`` for ``scan_codes``;
    K1/K4 on the card, the plain versions on the CPU); ``"fused"`` runs the
    whole-shard scan (``fusedscan.ops.fused_topk``/``fused_adc_topk``,
    K2/K5 on the card). ``None`` budgets mean "let ``plan()`` pick"; the
    executors require them resolved.
    """

    layout: str  # "point_major" | "scan_codes" (others: module docstring)
    k: int
    probes: int = 1  # multi-probe width T: leaves visited per query
    impl: str = "xla"
    # point-major budgets (scan_codes shares them: its code scan is a
    # point-major wave sweep over uint8 code slabs)
    block_rows: int | None = None  # index rows per wave tile
    q_cap: int | None = None  # query-slab rows per tile
    # scan_codes (compressed-tier) parameters
    rerank: int | None = None  # ADC survivors fetched for exact rerank
    code_m: int | None = None  # PQ subvectors (code bytes per row)
    code_bits: int | None = None  # bits per subvector (2**bits centroids)

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(f"unknown layout {self.layout!r}; want {LAYOUTS}")
        if self.impl not in IMPLS:
            raise ValueError(f"unknown impl {self.impl!r}; want {IMPLS}")
        _check_ported(self.layout, self.impl)
        if self.k < 1:
            raise ValueError(f"{self.k=} must be >= 1")
        if self.probes < 1:
            raise ValueError(f"{self.probes=} must be >= 1")
        if self.rerank is not None and self.rerank < self.k:
            raise ValueError(f"{self.rerank=} must be >= {self.k=}")

    def resolved(self) -> "SearchPlan":
        """Check the budgets this layout needs are set."""
        need = ("block_rows", "q_cap")
        if self.layout == "scan_codes":
            need += ("rerank", "code_m", "code_bits")
        for f in need:
            if getattr(self, f) is None:
                raise ValueError(f"plan field {f!r} unresolved for {self.layout}")
        return self


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
    rerank: int | None = None,
    code_m: int | None = None,
    code_bits: int | None = None,
) -> SearchPlan:
    """Resolve a full :class:`SearchPlan` from shapes.

    Args:
      rows: padded index rows (``DistributedIndex.rows``).
      n_leaves: vocabulary-tree leaf count.
      n_queries: query rows per batch (pre-probe-expansion).
      n_shards: row shards (1 on one GPU).
      k: neighbours returned per query; ``probes``: multi-probe width.
      layout: ``"point_major"`` or ``"scan_codes"``; the others raise
        ``NotImplementedError``.
      impl: ``"xla"``, ``"pallas"`` or ``"fused"``; ``"auto"`` raises
        ``NotImplementedError``.
      block_rows/q_cap: pin a budget instead of deriving it.
      rerank: ADC survivors per query for ``scan_codes`` (default
        :func:`default_rerank`); code_m/code_bits: the PQ codes' shape,
        required for ``scan_codes``.

    Raises:
      ValueError: ``probes > n_leaves``; an unknown ``layout`` or ``impl``;
        ``scan_codes`` without ``code_m``/``code_bits``.
    """
    if probes > n_leaves:
        raise ValueError(f"{probes=} must be <= {n_leaves=}")
    if layout not in LAYOUTS + ("auto",):
        raise ValueError(f"unknown layout {layout!r}")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; want {IMPLS}")
    _check_ported(layout, impl)
    shard_rows = max(1, rows // max(1, n_shards))
    q_rows = max(1, n_queries * probes)  # probe-expanded lookup rows
    base = dict(k=k, probes=probes, impl=impl, block_rows=block_rows,
                q_cap=q_cap)
    shapes = dict(shard_rows=shard_rows, n_leaves=n_leaves, q_rows=q_rows,
                  n_shards=n_shards)
    if layout == "scan_codes":
        if code_m is None or code_bits is None:
            raise ValueError(
                "layout='scan_codes' needs code_m/code_bits (the shape of "
                "the index's PQ codes)")
        return _scan_codes_budgets(
            SearchPlan(layout="scan_codes", rerank=rerank, code_m=code_m,
                       code_bits=code_bits, **base), **shapes).resolved()
    return _point_major_budgets(
        SearchPlan(layout="point_major", **base), **shapes).resolved()
