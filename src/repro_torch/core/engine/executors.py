"""Point-major search executors (paper section 2.4) on one GPU.

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

Multi-probe: ``build_lookup(tree, queries, probes=T)`` expands each query
into ``T`` rows whose ``qids`` are flat slots ``query_id * T + probe_rank``;
the final ``merge_probe_groups`` folds them back to one ``k``-row.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.distance import sq_norms, topk_lex
from repro_torch.core.engine import tilescan
from repro_torch.core.engine.plan import SearchPlan
from repro_torch.core.lookup import LookupTable
from repro_torch.core.sentinels import INVALID_ID, LEAF_SENTINEL, PAD_QUERY_LEAF
from repro_torch.kernels.fusedscan import ops as fused_ops


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
    if plan.k > plan.block_rows:
        raise ValueError(f"{plan.k=} must be <= {plan.block_rows=}")
    if plan.q_cap > q_total:
        raise ValueError(f"{plan.q_cap=} must be <= padded query count {q_total=}")


def _point_major_fn(plan: SearchPlan, *, n_leaves, shard_rows, q_total):
    block_rows, q_cap, k = plan.block_rows, plan.q_cap, plan.k
    _check_budgets(plan, shard_rows, q_total)
    n_waves = shard_rows // block_rows

    def shard_fn(vecs, leaves, ids, lookup):
        dev = vecs.device
        lk_vecs, lk_leaves, lk_offsets = lookup.vecs, lookup.leaves, lookup.offsets
        # every wave's slab start, from its first point leaf (no host sync)
        slab_starts = tilescan.leaf_slab(
            lk_offsets, leaves[::block_rows], n_entries=n_leaves,
            total_rows=q_total, cap=q_cap).start
        rows = torch.arange(q_cap, device=dev)
        best_d = torch.full((q_total, k), torch.inf, device=dev)
        best_i = torch.full((q_total, k), INVALID_ID, dtype=torch.int32, device=dev)
        for i in range(n_waves):
            wave = slice(i * block_rows, (i + 1) * block_rows)
            slab = slab_starts[i] + rows
            cand_d, cand_i = tilescan.scan_tile(
                vecs[wave], leaves[wave], ids[wave],
                lk_vecs.index_select(0, slab), lk_leaves.index_select(0, slab),
                k=k)
            # fold into the running per-query k-NN table
            new_d, new_i = tilescan.fold_topk(
                best_d.index_select(0, slab), best_i.index_select(0, slab),
                cand_d, cand_i)
            best_d.index_copy_(0, slab, new_d)
            best_i.index_copy_(0, slab, new_i)
        pairs, overflow = tilescan.sweep_accounting(
            leaves, slab_starts, lk_offsets, block_rows=block_rows,
            q_cap=q_cap, n_leaves=n_leaves)
        return best_d, best_i, pairs, overflow

    def pipeline(index, lookup: LookupTable) -> SearchResult:
        return _run_shard(plan, shard_fn, index, lookup, q_total=q_total)

    return pipeline


def _point_major_fused_fn(plan: SearchPlan, *, n_leaves, shard_rows, q_total):
    """Fused point-major executor: the whole shard goes through one
    ``fusedscan.fused_topk`` call, with the per-query top-k kept on chip
    across point tiles, so no per-wave candidate table reaches memory."""
    _check_budgets(plan, shard_rows, q_total)

    def shard_fn(vecs, leaves, ids, lookup):
        best_d, best_i = fused_ops.fused_topk(
            vecs, leaves, ids, lookup.vecs, lookup.leaves, k=plan.k)
        pairs = _leaf_pair_count(leaves, lookup.leaves, n_leaves)
        # whole-shard scan: every leaf-matching query row is visible to
        # every point tile -- the q_cap slab budget cannot be exceeded
        overflow = torch.zeros((), dtype=torch.int64, device=vecs.device)
        return best_d, best_i, pairs, overflow

    def pipeline(index, lookup: LookupTable) -> SearchResult:
        return _run_shard(plan, shard_fn, index, lookup, q_total=q_total)

    return pipeline


def _run_shard(plan, shard_fn, index, lookup, *, q_total) -> SearchResult:
    """One shard: its rows are the whole index. The per-shard tables keep
    their leading shard axis for the merge."""
    best_d, best_i, pairs, overflow = shard_fn(index.vecs, index.leaves,
                                               index.ids, lookup)
    return _merge_shard_tables(
        plan, lookup, best_d[None], best_i[None], pairs, overflow,
        q_total=q_total, n_shards=1, width=plan.k, add_q_norms=True)


_BUILDERS = {"xla": _point_major_fn, "pallas": _point_major_fn,
             "fused": _point_major_fused_fn}


def make_executor(plan: SearchPlan, *, n_leaves: int, shard_rows: int,
                  q_total: int, n_shards: int = 1):
    """Build the ``(index, lookup) -> SearchResult`` pipeline.

    ``q_total`` is the *padded lookup row* count (``n_queries * probes``
    rounded up); it must be a multiple of ``plan.probes``. Output tables
    have ``q_total // plan.probes`` rows.
    """
    plan = plan.resolved()
    if n_shards != 1:
        raise NotImplementedError(
            "the executors run on one shard; multiple GPUs are ROADMAP M13")
    if q_total % plan.probes:
        raise ValueError(f"{q_total=} must be a multiple of {plan.probes=}")
    return _BUILDERS[plan.impl](plan, n_leaves=n_leaves, shard_rows=shard_rows,
                                q_total=q_total)
