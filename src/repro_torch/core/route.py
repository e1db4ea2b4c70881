"""Cluster routing: the paper's shuffle phase, on one GPU.

Hadoop's copy-merge-sort shuffle (map outputs keyed by cluster id, delivered
to the reducer owning that key) becomes, per shard:

  1. destination = owner shard of the row's leaf  (contiguous leaf ranges)
  2. capacity-padded counting sort into per-destination send buffers
  3. the exchange (the wire) -- the identity on one shard; the leading
     shard axis is kept so a multi-GPU port swaps in ``all_to_all_single``
  4. local sort of received rows by leaf  (the reduce-side merge-sort)

A shard can send at most ``capacity`` rows to any destination; rows beyond
that are dropped and *counted*. Payload vectors cross the wire in
``wire_dtype`` (bf16 halves the bytes) and are rounded back to float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.sentinels import LEAF_SENTINEL


class CountingLayout(NamedTuple):
    """Scatter layout of local rows into (n_dest, capacity) send slots."""

    slot_of_row: torch.Tensor  # (n,) flat slot id dest*capacity+pos, or -1
    fits: torch.Tensor  # (n,) bool -- row made it into its destination bucket
    overflow: torch.Tensor  # () int32 -- rows dropped (capacity exceeded)


def counting_layout(dest: torch.Tensor, n_dest: int, capacity: int) -> CountingLayout:
    """Stable counting sort of rows by destination with per-dest capacity."""
    n = dest.shape[0]
    dev = dest.device
    order = torch.argsort(dest, stable=True)
    sorted_dest = dest[order]
    # start offset of each destination's segment in the sorted order
    starts = torch.searchsorted(
        sorted_dest, torch.arange(n_dest, dtype=dest.dtype, device=dev))
    # position of each row within its destination segment; out-of-range
    # destinations never fit, so their (clamped) position is irrelevant
    pos_sorted = (torch.arange(n, device=dev)
                  - starts[sorted_dest.clamp(0, n_dest - 1).long()])
    pos = torch.empty((n,), dtype=torch.int64, device=dev)
    pos[order] = pos_sorted
    in_range = (dest >= 0) & (dest < n_dest)
    fits = (pos < capacity) & in_range
    slot = torch.where(fits, dest.long() * capacity + pos, -1)
    # only in-range rows count as dropped (negative dest = padding rows)
    overflow = (~fits & in_range).sum().to(torch.int32)
    return CountingLayout(slot_of_row=slot, fits=fits, overflow=overflow)


def scatter_to_slots(layout: CountingLayout, x: torch.Tensor, n_dest: int,
                     capacity: int, fill=0) -> torch.Tensor:
    """Place rows into their (n_dest*capacity, ...) send slots; rows that
    do not fit are dropped."""
    buf = torch.full((n_dest * capacity,) + tuple(x.shape[1:]), fill,
                     dtype=x.dtype, device=x.device)
    buf[layout.slot_of_row[layout.fits]] = x[layout.fits]
    return buf


class Routed(NamedTuple):
    """Per-shard received rows after the exchange (padded, mask via leaf)."""

    vecs: torch.Tensor  # (n_dest*capacity, d) float32
    ids: torch.Tensor  # (n_dest*capacity,) global row ids; -1 invalid
    leaves: torch.Tensor  # (n_dest*capacity,) leaf ids; LEAF_SENTINEL invalid
    overflow: torch.Tensor  # () rows dropped on the send side


def route_by_leaf(
    vecs: torch.Tensor,
    ids: torch.Tensor,
    leaves: torch.Tensor,
    *,
    n_shards: int,
    leaves_per_shard: int,
    capacity: int,
    wire_dtype=torch.bfloat16,
) -> Routed:
    """Shuffle rows to the shard owning their leaf. One shard only: the
    exchange is the identity (a multi-GPU port replaces it with
    ``torch.distributed.all_to_all_single``)."""
    if n_shards != 1:
        raise NotImplementedError(
            "route_by_leaf runs on one shard; multiple GPUs are ROADMAP M13")
    dest = torch.div(leaves, leaves_per_shard, rounding_mode="floor").to(torch.int32)
    layout = counting_layout(dest, n_shards, capacity)

    send_vecs = scatter_to_slots(layout, vecs.to(wire_dtype), n_shards, capacity)
    send_ids = scatter_to_slots(layout, ids.to(torch.int32), n_shards, capacity,
                                fill=-1)
    send_leaves = scatter_to_slots(layout, leaves.to(torch.int32), n_shards,
                                   capacity, fill=LEAF_SENTINEL)
    # mark empty slots invalid (fill of vecs/ids alone is ambiguous)
    slot_used = scatter_to_slots(
        layout, torch.ones(leaves.shape, dtype=torch.int8, device=leaves.device),
        n_shards, capacity)
    send_leaves = torch.where(slot_used > 0, send_leaves, LEAF_SENTINEL)
    send_ids = torch.where(slot_used > 0, send_ids, -1)
    # the wire: identity on one shard
    return Routed(
        vecs=send_vecs.to(vecs.dtype),
        ids=send_ids,
        leaves=send_leaves,
        overflow=layout.overflow,
    )


def cluster_sort(routed: Routed, *, leaf_base: int, leaves_per_shard: int):
    """Reduce-side merge: sort received rows by leaf, build CSR offsets.

    Returns (vecs, ids, leaves, offsets, n_valid) where offsets has length
    ``leaves_per_shard + 1`` over *local* leaf ids.
    """
    order = torch.argsort(routed.leaves, stable=True)
    vecs = routed.vecs[order]
    ids = routed.ids[order]
    leaves = routed.leaves[order]
    n_valid = (leaves != LEAF_SENTINEL).sum().to(torch.int32)
    local_leaf = torch.where(
        leaves == LEAF_SENTINEL, leaves_per_shard, leaves - leaf_base
    ).to(torch.int32)
    offsets = torch.searchsorted(
        local_leaf,
        torch.arange(leaves_per_shard + 1, dtype=torch.int32, device=leaves.device),
    ).to(torch.int32)
    return vecs, ids, leaves, offsets, n_valid
