"""Shared tile-scan core of the point-major search.

An *anchor* tile of index rows (sliced by wave index) meets a *slab* (a
contiguous run of the cluster-sorted lookup table, located through CSR
offsets); one fused distance+top-k produces per-query candidates, and
pairs/overflow are accounted exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.distance import topk_lex
from repro_torch.core.sentinels import INVALID_ID, LEAF_SENTINEL
from repro_torch.kernels.l2topk import ops as l2topk_ops


class Slab(NamedTuple):
    """A contiguous slab start for one tile, plus its budget."""

    start: torch.Tensor  # () int64 row offset into the sorted table
    cap: int  # static slab row budget


def leaf_slab(offsets: torch.Tensor, first_leaf: torch.Tensor, *,
              n_entries: int, total_rows: int, cap: int) -> Slab:
    """Locate the slab covering ``first_leaf`` in a CSR-sorted table.

    ``offsets`` has ``n_entries + 1`` entries. The start is clipped so a
    full ``cap``-row slice stays in bounds -- the clamp the JAX package gets
    from ``dynamic_slice`` (padding rows at the tail never match a leaf).
    """
    l0 = first_leaf.clamp(0, n_entries - 1).long()
    start = offsets[l0].long().clamp(0, max(0, total_rows - cap))
    return Slab(start=start, cap=cap)


def slab_overflow(offsets: torch.Tensor, last_leaf: torch.Tensor, slab: Slab,
                  *, n_entries: int) -> torch.Tensor:
    """Rows of the tile's leaf span that did not fit in the slab budget.

    ``last_leaf`` is the highest *valid local* leaf id of the anchor tile
    (``-1`` when the tile is all padding).
    """
    need_end = torch.where(
        last_leaf >= 0,
        offsets[(last_leaf.clamp(0, n_entries - 1) + 1).long()].long(),
        slab.start,
    )
    return (need_end - slab.start - slab.cap).clamp(min=0)


def last_valid_leaf(leaves: torch.Tensor, *, base=0) -> torch.Tensor:
    """Highest real leaf id in a tile (along the last axis), shifted by
    ``base``; -1 if none."""
    valid = leaves != LEAF_SENTINEL
    return torch.where(valid, leaves.long() - base, -1).amax(dim=-1)


def scan_tile(pv, plf, pid, qv, qlf, *, k: int):
    """Fused distance + per-query top-k over one (points, queries) tile.

    Returns ``(cand_d, cand_i)`` of shape ``(Q, k)``: partial squared
    distances (no ``||q||^2`` term) with ``inf``/``INVALID_ID`` where fewer
    than ``k`` same-leaf points exist. ``cand_i`` holds *global* descriptor
    ids (mapped through ``pid``), not tile-row indices.
    """
    cand_d, cand_sel = l2topk_ops.l2_topk(pv, plf, qv, qlf, k=k)
    cand_i = torch.where(cand_sel >= 0, pid[cand_sel.clamp(min=0).long()],
                         INVALID_ID)
    cand_d = torch.where(cand_i >= 0, cand_d, torch.inf)
    return cand_d, cand_i


def count_pairs(plf: torch.Tensor, qlf: torch.Tensor) -> torch.Tensor:
    """Exact (int64) number of same-leaf (point, query) pairs in a tile.

    Padding leaves on either side never match a real leaf, but two padded
    rows of the *same* kind would match each other -- mask both sides.
    """
    p_ok = (plf >= 0) & (plf != LEAF_SENTINEL)
    q_ok = (qlf >= 0) & (qlf != LEAF_SENTINEL)
    match = (plf[:, None] == qlf[None, :]) & p_ok[:, None] & q_ok[None, :]
    return match.sum()


def sweep_accounting(leaves: torch.Tensor, slab_starts: torch.Tensor,
                     lk_offsets: torch.Tensor, *, block_rows: int, q_cap: int,
                     n_leaves: int, pair_leaves: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(pairs, overflow) of a whole wave sweep, exact int64, computed for
    all waves at once and with no host sync.

    Equals the sums of :func:`count_pairs` and :func:`slab_overflow` over
    the waves: a point of valid leaf ``L`` meets exactly the lookup rows
    ``[offsets[L], offsets[L+1])`` that fall inside its wave's slab
    (lookup padding lies outside every CSR span). ``pair_leaves`` (default
    ``leaves``) are the leaves the scan matched on -- the codes scan masks
    tombstones there -- while the slab budget follows ``leaves``.
    """
    n_waves = slab_starts.shape[0]
    lv = (leaves if pair_leaves is None else pair_leaves).long()
    ok = (lv >= 0) & (lv < n_leaves)
    lc = lv.clamp(0, n_leaves - 1)
    s = slab_starts.repeat_interleave(block_rows)
    lo = torch.maximum(lk_offsets[lc].long(), s)
    hi = torch.minimum(lk_offsets[lc + 1].long(), s + q_cap)
    pairs = torch.where(ok, (hi - lo).clamp(min=0), 0).sum()
    last = last_valid_leaf(leaves.reshape(n_waves, block_rows))
    overflow = slab_overflow(lk_offsets, last, Slab(slab_starts, q_cap),
                             n_entries=n_leaves).sum()
    return pairs, overflow


def fold_topk(cur_d, cur_i, cand_d, cand_i):
    """Merge a candidate table into a running best-k table (row-wise);
    running entries win distance ties (they are the earlier rows)."""
    k = cur_d.shape[-1]
    all_d = torch.cat([cur_d, cand_d], dim=-1)
    all_i = torch.cat([cur_i, cand_i], dim=-1)
    vals, sel = topk_lex(all_d, k)
    return vals, torch.gather(all_i, -1, sel)


def merge_probe_groups(d: torch.Tensor, i: torch.Tensor, probes: int):
    """Merge the ``probes`` candidate rows of each original query.

    ``d``/``i`` are ``(rows, k)`` tables indexed by flat lookup-row slot
    (``query_id * probes + probe_rank``). Each query's probe rows target
    distinct leaves and every point lives in exactly one leaf, so the id
    sets are disjoint and merging is a plain per-group top-k.
    """
    if probes == 1:
        return d, i
    rows, k = d.shape
    if rows % probes:
        raise ValueError(f"{rows=} not a multiple of {probes=}")
    gd = d.reshape(rows // probes, probes * k)
    gi = i.reshape(rows // probes, probes * k)
    vals, sel = topk_lex(gd, k)
    return vals, torch.gather(gi, 1, sel)
