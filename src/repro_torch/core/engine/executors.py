"""Search executors (paper section 2.4) on one GPU.

Point-major: the shard sweeps its cluster-sorted index rows in waves of
``block_rows`` against the lookup table; the slab of queries colliding with
a tile is contiguous (both sides leaf-sorted), and a running ``(rows, k)``
best table is folded per wave, then merged with one top-k. The JAX
package runs the wave loop as ``fori_loop`` inside ``shard_map``; here it
is a Python loop whose steps stay on the device (no host sync per wave).

Fused (``plan.impl="fused"``): the whole shard meets the whole lookup
table in one ``fusedscan.fused_topk`` call (K2 on the card, the plain
version on the CPU). Both paths return the k smallest by (distance, shard
row), so their ids and distances agree.

Query-routed (``plan.layout="query_routed"``): the lookup rows go to the
shard owning their leaf (``route.route_by_leaf``, the exchange the index
build uses; the identity on one shard) and are cluster-sorted; then each
tile of ``q_tile`` rows reads the one ``p_cap``-row point slab that starts
at its first leaf, in place, through ``l2topk.l2_topk`` (K1 with the
slab's start on the device), and the rows are scattered back to their
slots. No running table and no cross-shard merge.

Codes (``plan.layout="scan_codes"``): the same two shapes over uint8 PQ
code rows under the asymmetric distance -- a wave sweep through
``adcscan.adc_topk`` (K4), or one ``fusedscan.fused_adc_topk`` call (K5)
-- keeping ``plan.rerank`` approximate candidates per query for the
caller's exact rerank (``codes.rerank_exact``).

Multi-probe: ``build_lookup(tree, queries, probes=T)`` expands each query
into ``T`` rows whose ``qids`` are flat slots ``query_id * T + probe_rank``;
the final ``merge_probe_groups`` folds them back to one ``k``-row.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import route as route_lib
from repro_torch.core.distance import sq_norms, topk_lex
from repro_torch.core.engine import tilescan
from repro_torch.core.engine.plan import SearchPlan, round_up
from repro_torch.core.lookup import LookupTable
from repro_torch.core.sentinels import (
    INVALID_ID,
    LEAF_SENTINEL,
    PAD_QUERY_LEAF,
    PAD_TILE_POINT_LEAF,
)
from repro_torch.kernels.adcscan import ops as adc_ops
from repro_torch.kernels.fusedscan import ops as fused_ops
from repro_torch.kernels.fusedscan.ref import map_ids
from repro_torch.kernels.l2topk import ops as l2topk_ops


@dataclasses.dataclass
class SearchResult:
    ids: torch.Tensor  # (Q, k) int32 global descriptor ids, -1 where fewer than k
    dists: torch.Tensor  # (Q, k) true squared L2 distances (inf where id=-1)
    pairs: torch.Tensor  # () float32 (point, query) distance pairs computed
    q_cap_overflow: torch.Tensor  # () int32 slab-budget misses (0 == exact)


def _leaf_pair_count(p_leaves, q_leaves, n_leaves: int) -> torch.Tensor:
    """Exact (int64) same-leaf (point, query) pair count of a whole-shard
    scan: the product of the two leaf histograms. Equals the wave sweep's
    summed ``count_pairs`` whenever q_cap never overflowed."""
    def hist(lv):
        ok = (lv >= 0) & (lv != LEAF_SENTINEL) & (lv < n_leaves)
        return torch.bincount(lv[ok].long(), minlength=n_leaves)

    return (hist(p_leaves) * hist(q_leaves)).sum()


def pad_lookup(lookup: LookupTable, q_total: int) -> LookupTable:
    """Pad the lookup table to ``q_total`` rows; padding never matches.

    Pad rows get fresh flat slot ids past the real ones so every scatter
    target stays a permutation of ``arange(q_total)``.
    """
    q = lookup.vecs.shape[0]
    if q_total < q:
        raise ValueError(f"{q_total=} < {q}")
    if q_total == q:
        return lookup
    pad = q_total - q
    dev = lookup.vecs.device
    return LookupTable(
        vecs=torch.cat([lookup.vecs, lookup.vecs.new_zeros((pad, lookup.vecs.shape[1]))]),
        qids=torch.cat([lookup.qids, torch.arange(q, q_total, dtype=torch.int32,
                                                  device=dev)]),
        leaves=torch.cat([lookup.leaves, torch.full((pad,), PAD_QUERY_LEAF,
                                                    dtype=torch.int32, device=dev)]),
        offsets=lookup.offsets,
    )


def _merge_shard_tables(plan, lookup, best_d, best_i, pairs, overflow, *,
                        q_total, n_shards, width, add_q_norms):
    """Merge per-shard ``(S, Q, width)`` k-NN tables into a SearchResult:
    one per-row top-k over the shards' candidates, the deferred ``||q||^2``
    added back, rows scattered to their flat slots by ``qids``, and probe
    groups merged. Shared by both executors, so the merge is op for op the
    same across impls."""
    all_d = best_d.permute(1, 0, 2).reshape(q_total, n_shards * width)
    all_i = best_i.permute(1, 0, 2).reshape(q_total, n_shards * width)
    merged_d, sel = topk_lex(all_d, width)
    if add_q_norms:
        merged_d = merged_d + sq_norms(lookup.vecs)[:, None]
    merged_i = torch.gather(all_i, 1, sel)
    merged_d = torch.where(merged_i >= 0, merged_d, torch.inf)
    # unsort to flat slot order, then merge probe groups
    slots = lookup.qids.long()
    out_d = torch.full_like(merged_d, torch.inf)
    out_d[slots] = merged_d
    out_i = torch.full_like(merged_i, INVALID_ID)
    out_i[slots] = merged_i
    out_d, out_i = tilescan.merge_probe_groups(out_d, out_i, plan.probes)
    return SearchResult(ids=out_i, dists=out_d, pairs=pairs.float(),
                        q_cap_overflow=overflow.to(torch.int32))


def _check_budgets(plan: SearchPlan, shard_rows: int, q_total: int) -> None:
    if shard_rows % plan.block_rows != 0:
        raise ValueError(f"{shard_rows=} not divisible by {plan.block_rows=}")
    width = plan.rerank if plan.layout == "scan_codes" else plan.k
    if width > plan.block_rows:
        raise ValueError(f"k or rerank {width} must be <= {plan.block_rows=}")
    if plan.q_cap > q_total:
        raise ValueError(f"{plan.q_cap=} must be <= padded query count {q_total=}")


def _wave_sweep(plan: SearchPlan, tile_fn, leaves, lookup, *, n_leaves,
                q_total, width, pair_leaves=None):
    """The point-major wave sweep both layouts share.

    Each wave of ``block_rows`` shard rows meets the ``q_cap``-row slab of
    lookup rows that starts at its first point leaf (located on the device,
    no host sync); ``tile_fn(wave, start, slab)`` -- the wave's row slice,
    its slab start as a one-element int64 tensor, and the slab's lookup
    rows -- returns the wave's ``(q_cap, width)`` candidates, which are
    folded into a running per-lookup-row table. ``pair_leaves`` are the
    leaves the tiles match on, for the pair count (default ``leaves``).
    Returns ``(best_d, best_i, pairs, overflow)``.
    """
    block_rows, q_cap = plan.block_rows, plan.q_cap
    dev = leaves.device
    slab_starts = tilescan.leaf_slab(
        lookup.offsets, leaves[::block_rows], n_entries=n_leaves,
        total_rows=q_total, cap=q_cap).start
    rows = torch.arange(q_cap, device=dev)
    best_d = torch.full((q_total, width), torch.inf, device=dev)
    best_i = torch.full((q_total, width), INVALID_ID, dtype=torch.int32, device=dev)
    for i in range(leaves.shape[0] // block_rows):
        start = slab_starts[i:i + 1]
        slab = start + rows
        cand_d, cand_i = tile_fn(slice(i * block_rows, (i + 1) * block_rows),
                                 start, slab)
        # fold into the running per-query k-NN table
        new_d, new_i = tilescan.fold_topk(
            best_d.index_select(0, slab), best_i.index_select(0, slab),
            cand_d, cand_i)
        best_d.index_copy_(0, slab, new_d)
        best_i.index_copy_(0, slab, new_i)
    pairs, overflow = tilescan.sweep_accounting(
        leaves, slab_starts, lookup.offsets, block_rows=block_rows,
        q_cap=q_cap, n_leaves=n_leaves, pair_leaves=pair_leaves)
    return best_d, best_i, pairs, overflow


def _point_major_fn(plan: SearchPlan, *, n_leaves, shard_rows, q_total):
    _check_budgets(plan, shard_rows, q_total)

    def shard_fn(index, lookup):
        vecs, leaves, ids = index.vecs, index.leaves, index.ids

        def tile(wave, start, slab):
            return tilescan.scan_tile(
                vecs[wave], leaves[wave], ids[wave],
                lookup.vecs.index_select(0, slab),
                lookup.leaves.index_select(0, slab), k=plan.k)

        return _wave_sweep(plan, tile, leaves, lookup, n_leaves=n_leaves,
                           q_total=q_total, width=plan.k)

    return _dense_pipeline(plan, shard_fn, q_total=q_total)


def routed_capacity(plan: SearchPlan, q_total: int, n_shards: int = 1) -> int:
    """Routed lookup rows a shard holds: ``query_capacity_factor`` times
    its share of ``q_total``, on the ``q_tile`` grid (the JAX package's
    ``q_cap_shard``)."""
    return round_up(
        max(plan.q_tile, int(q_total / n_shards * plan.query_capacity_factor)),
        plan.q_tile)


def routed_accounting(offsets, qleaves, starts, *, q_tile: int, p_cap: int,
                      n_entries: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(pairs, overflow) of a query-routed sweep, exact int64, for every
    tile at once: a lookup row of local leaf ``L`` meets the point rows
    ``[offsets[L], offsets[L+1])`` inside its tile's slab ``[start, start
    + p_cap)``, which is what ``count_pairs`` counts on the slab; the
    overflow is ``slab_overflow`` of each tile's last real leaf."""
    lv = qleaves.long()
    ok = (lv >= 0) & (lv < n_entries)
    lc = lv.clamp(0, n_entries - 1)
    s = starts.repeat_interleave(q_tile)
    lo = torch.maximum(offsets[lc].long(), s)
    hi = torch.minimum(offsets[lc + 1].long(), s + p_cap)
    pairs = torch.where(ok, (hi - lo).clamp(min=0), 0).sum()
    last = tilescan.last_valid_leaf(qleaves.reshape(-1, q_tile))
    overflow = tilescan.slab_overflow(
        offsets, last, tilescan.Slab(starts, p_cap), n_entries=n_entries).sum()
    return pairs, overflow


def _query_routed_fn(plan: SearchPlan, *, n_leaves, shard_rows, q_total):
    """Query-routed executor: route the lookup rows to the shard owning
    their leaf, cluster-sort them, and answer each ``q_tile`` tile from
    its ``p_cap``-row point slab (K1 reading the slab in place).

    Only the tiles holding real rows are scanned -- one host sync for
    their count; the others (routing padding, ``LEAF_SENTINEL``) match no
    point and would add nothing to the ids, distances, pairs or overflow.
    """
    q_tile, p_cap, k = plan.q_tile, plan.p_cap, plan.k
    lps = n_leaves  # one shard owns every leaf
    q_cap_shard = routed_capacity(plan, q_total)
    if p_cap > shard_rows:
        raise ValueError(f"{p_cap=} must be <= {shard_rows=}")
    if k > p_cap:
        raise ValueError(f"{k=} must be <= {p_cap=}")

    def pipeline(index, lookup: LookupTable) -> SearchResult:
        vecs, leaves, ids = index.vecs, index.leaves, index.ids
        offsets = index.offsets[0]
        dev = vecs.device
        routed = route_lib.route_by_leaf(
            lookup.vecs, lookup.qids, lookup.leaves, n_shards=1,
            leaves_per_shard=lps, capacity=q_cap_shard,
            wire_dtype=plan.wire_dtype)
        qv_all, qids_all, qlf_all, _, n_valid = route_lib.cluster_sort(
            routed, leaf_base=0, leaves_per_shard=lps)
        # each tile's point slab starts at its first leaf's run, on the device
        starts = tilescan.leaf_slab(
            offsets, qlf_all[::q_tile], n_entries=lps, total_rows=shard_rows,
            cap=p_cap).start
        n_real = -(-int(n_valid) // q_tile) * q_tile  # real rows sort first
        cand_d = torch.empty((n_real, k), dtype=torch.float32, device=dev)
        cand_i = torch.empty((n_real, k), dtype=torch.int32, device=dev)
        for w, qs in enumerate(range(0, n_real, q_tile)):
            cand_d[qs:qs + q_tile], cand_i[qs:qs + q_tile] = l2topk_ops.l2_topk(
                vecs, leaves, qv_all[qs:qs + q_tile], qlf_all[qs:qs + q_tile],
                k=k, p_start=starts[w:w + 1], p_rows=p_cap)
        # slab rows to ids, then the true squared distances (dead and
        # absent rows: inf), once over every tile
        rows = starts[:n_real // q_tile].repeat_interleave(q_tile)[:, None]
        cand_i = torch.where(cand_i >= 0, ids[(rows + cand_i.clamp(min=0)).long()],
                             INVALID_ID)
        cand_d = (torch.where(cand_i >= 0, cand_d, torch.inf)
                  + sq_norms(qv_all[:n_real])[:, None])
        pairs, overflow = routed_accounting(
            offsets, qlf_all, starts, q_tile=q_tile, p_cap=p_cap, n_entries=lps)
        # one scatter back to flat slot order (each lookup row was answered
        # by exactly one tile), then merge each query's probe rows
        slots = qids_all[:n_real].long()
        real = slots >= 0
        out_d = torch.full((q_total, k), torch.inf, device=dev)
        out_i = torch.full((q_total, k), INVALID_ID, dtype=torch.int32, device=dev)
        out_d[slots[real]] = cand_d[real]
        out_i[slots[real]] = cand_i[real]
        out_d, out_i = tilescan.merge_probe_groups(out_d, out_i, plan.probes)
        return SearchResult(ids=out_i, dists=out_d, pairs=pairs.float(),
                            q_cap_overflow=(overflow + routed.overflow).to(torch.int32))

    return pipeline


def _point_major_fused_fn(plan: SearchPlan, *, n_leaves, shard_rows, q_total):
    """Fused point-major executor: the whole shard goes through one
    ``fusedscan.fused_topk`` call, with the per-query top-k kept on chip
    across point tiles, so no per-wave candidate table reaches memory."""
    _check_budgets(plan, shard_rows, q_total)

    def shard_fn(index, lookup):
        best_d, best_i = fused_ops.fused_topk(
            index.vecs, index.leaves, index.ids, lookup.vecs, lookup.leaves,
            k=plan.k)
        pairs = _leaf_pair_count(index.leaves, lookup.leaves, n_leaves)
        # whole-shard scan: every leaf-matching query row is visible to
        # every point tile -- the q_cap slab budget cannot be exceeded
        overflow = torch.zeros((), dtype=torch.int64, device=best_d.device)
        return best_d, best_i, pairs, overflow

    return _dense_pipeline(plan, shard_fn, q_total=q_total)


def _run_shard(plan, shard_fn, index, lookup, *args, q_total, width,
               add_q_norms) -> SearchResult:
    """One shard: its rows are the whole index. ``shard_fn(index, lookup,
    *args)`` gives its ``(q_total, width)`` tables, which keep a leading
    shard axis for the merge."""
    best_d, best_i, pairs, overflow = shard_fn(index, lookup, *args)
    return _merge_shard_tables(
        plan, lookup, best_d[None], best_i[None], pairs, overflow,
        q_total=q_total, n_shards=1, width=width, add_q_norms=add_q_norms)


def _dense_pipeline(plan, shard_fn, *, q_total):
    """``(index, lookup) -> SearchResult`` around a dense ``shard_fn``: the
    merge adds back the deferred ``||q||^2``."""

    def pipeline(index, lookup: LookupTable) -> SearchResult:
        return _run_shard(plan, shard_fn, index, lookup, q_total=q_total,
                          width=plan.k, add_q_norms=True)

    return pipeline


def _build_adc_lut(lookup_vecs, codebooks, *, q_total: int, m: int,
                   n_centers: int):
    """Per-lookup-row ADC tables, flattened to (Q, m * n_centers):
    ``lut[q, j, c] = ||q_j - codebook[j, c]||^2``, by the expansion
    ``||sub||^2 - 2 sub.c + ||c||^2`` in that order, as the JAX package
    builds them (fp32; TF32 stays off)."""
    dsub = codebooks.shape[-1]
    sub = lookup_vecs.float().reshape(q_total, m, dsub)
    cb = codebooks.float()
    cross = torch.einsum("qmd,mcd->qmc", sub, cb)
    return ((sub * sub).sum(-1)[:, :, None] - 2.0 * cross
            + (cb * cb).sum(-1)[None]).reshape(q_total, m * n_centers)


def _live_leaves(leaves, ids):
    """Leaves with tombstoned rows (id < 0) masked so they never match:
    codes cannot carry the huge-vector mask a dense tombstone carries."""
    return torch.where(ids >= 0, leaves, PAD_TILE_POINT_LEAF)


def _scan_codes_fn(plan: SearchPlan, *, n_leaves, shard_rows, q_total):
    """Compressed-tier scan: the point-major wave sweep over uint8 PQ code
    slabs under the asymmetric distance, one adcscan call a wave, which
    reads its slab's LUTs in place. The result carries *approximate* ADC
    distances over ``plan.rerank`` survivors per query -- callers fetch
    those rows and rerank exactly (:func:`repro_torch.codes.rerank_exact`)."""
    _check_budgets(plan, shard_rows, q_total)

    def shard_fn(index, lookup, codes, lut):
        leaves, ids = index.leaves, index.ids

        def tile(wave, start, slab):
            # the wave's sorted leaves with its ids: tombstones keep their
            # leaf, so the order holds, and the kernel skips them (P6)
            return map_ids(*adc_ops.adc_topk(
                codes[wave], leaves[wave], lut, lookup.leaves, k=plan.rerank,
                point_ids=ids[wave], q_start=start, q_rows=plan.q_cap),
                ids[wave])

        return _wave_sweep(plan, tile, leaves, lookup, n_leaves=n_leaves,
                           q_total=q_total, width=plan.rerank,
                           pair_leaves=_live_leaves(leaves, ids))

    return _codes_pipeline(plan, shard_fn, q_total=q_total)


def _scan_codes_fused_fn(plan: SearchPlan, *, n_leaves, shard_rows, q_total):
    """Fused compressed-tier executor: the whole shard's codes go through
    one ``fusedscan.fused_adc_topk`` call. The kernel takes the sorted
    leaves as they are and skips tombstoned rows itself (masking their
    leaves would break the order its binary search relies on)."""
    _check_budgets(plan, shard_rows, q_total)

    def shard_fn(index, lookup, codes, lut):
        best_d, best_i = fused_ops.fused_adc_topk(
            codes, index.leaves, index.ids, lut, lookup.leaves, k=plan.rerank)
        pairs = _leaf_pair_count(_live_leaves(index.leaves, index.ids),
                                 lookup.leaves, n_leaves)
        overflow = torch.zeros((), dtype=torch.int64, device=codes.device)
        return best_d, best_i, pairs, overflow

    return _codes_pipeline(plan, shard_fn, q_total=q_total)


def _codes_pipeline(plan, shard_fn, *, q_total):
    """``(index, lookup, codes, codebooks) -> SearchResult`` around a codes
    ``shard_fn``: the per-row LUTs are built once, and the merge adds no
    ``||q||^2`` (ADC distances are full squared estimates)."""
    m, n_centers = plan.code_m, 1 << plan.code_bits

    def pipeline(index, lookup: LookupTable, codes, codebooks) -> SearchResult:
        if codes.shape != (index.rows, m) or codes.dtype != torch.uint8:
            raise ValueError(f"codes must be ({index.rows}, {m}) uint8, got "
                             f"{tuple(codes.shape)} {codes.dtype}")
        lut = _build_adc_lut(lookup.vecs, codebooks, q_total=q_total, m=m,
                             n_centers=n_centers)
        return _run_shard(plan, shard_fn, index, lookup, codes,
                          lut.view(q_total, m, n_centers), q_total=q_total,
                          width=plan.rerank, add_q_norms=False)

    return pipeline


_LAYOUT_BUILDERS = {"point_major": _point_major_fn,
                    "query_routed": _query_routed_fn,
                    "scan_codes": _scan_codes_fn}
_FUSED_BUILDERS = {"point_major": _point_major_fused_fn,
                   "scan_codes": _scan_codes_fused_fn}


def make_executor(plan: SearchPlan, *, n_leaves: int, shard_rows: int,
                  q_total: int, n_shards: int = 1):
    """Build the ``(index, lookup) -> SearchResult`` pipeline.

    ``q_total`` is the *padded lookup row* count (``n_queries * probes``
    rounded up); it must be a multiple of ``plan.probes``. Output tables
    have ``q_total // plan.probes`` rows.

    The ``scan_codes`` pipeline takes two more arguments --
    ``(index, lookup, codes, codebooks)``, the index's ``(rows, m)`` uint8
    codes and the ``(m, C, dsub)`` codebooks on its device -- and its rows
    hold ``plan.rerank`` *approximate* ADC candidates per query, which the
    caller reranks exactly.
    """
    plan = plan.resolved()
    if n_shards != 1:
        raise NotImplementedError(
            "the executors run on one shard; multiple GPUs are ROADMAP M13")
    if q_total % plan.probes:
        raise ValueError(f"{q_total=} must be a multiple of {plan.probes=}")
    builders = _FUSED_BUILDERS if plan.impl == "fused" else _LAYOUT_BUILDERS
    if plan.layout not in builders:
        raise ValueError(f"impl={plan.impl!r} is not supported for layout "
                         f"{plan.layout!r}")
    return builders[plan.layout](plan, n_leaves=n_leaves,
                                 shard_rows=shard_rows, q_total=q_total)
