"""Cluster routing: the paper's shuffle phase, across the shards of a mesh.

Hadoop's copy-merge-sort shuffle (map outputs keyed by cluster id, delivered
to the reducer owning that key) becomes, per shard:

  1. destination = owner shard of the row's leaf  (contiguous leaf ranges)
  2. capacity-padded counting sort into per-destination send buffers
  3. the exchange (the wire): ``collectives.all_to_all`` between the
     shards' devices -- the identity on one shard
  4. local sort of received rows by leaf  (the reduce-side merge-sort)

A shard can send at most ``capacity`` rows to any destination; rows beyond
that are dropped and *counted*. Payload vectors cross the wire in
``wire_dtype`` (bf16 halves the bytes) and are rounded back to float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.sentinels import LEAF_SENTINEL
from repro_torch.distributed import collectives
from repro_torch.distributed.meshutil import DeviceMesh


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

    vecs: torch.Tensor  # (n_dest*capacity, d) in the wire dtype
    ids: torch.Tensor  # (n_dest*capacity,) global row ids; -1 invalid
    leaves: torch.Tensor  # (n_dest*capacity,) leaf ids; LEAF_SENTINEL invalid
    overflow: torch.Tensor  # () rows dropped on the send side


def _send_buffers(vecs, ids, leaves, *, n_shards, leaves_per_shard, capacity,
                  wire_dtype):
    """One source shard's capacity-padded send buffers ``(vecs, ids,
    leaves)``, each ``(n_shards * capacity, ...)``, and its drop count."""
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
    return send_vecs, send_ids, send_leaves, layout.overflow


def route_by_leaf(
    vecs,
    ids,
    leaves,
    *,
    n_shards: int,
    leaves_per_shard: int,
    capacity: int,
    mesh: DeviceMesh,
    wire_dtype=torch.bfloat16,
):
    """Shuffle rows to the shard owning their leaf, over the ``n_shards``
    shards of ``mesh``.

    ``vecs``, ``ids`` and ``leaves`` are sequences of one tensor per shard,
    shard ``s``'s on ``mesh.devices[s]``, and the result is one
    :class:`Routed` per shard, on its device: the ``n_shards * capacity``
    rows it received, source shard by source shard, their vectors still in
    ``wire_dtype`` (``cluster_sort(..., dtype=)`` widens a shard's rows as
    it sorts them, so S shards never hold every row widened at once). Each
    one's ``overflow`` is the drop count summed over the sources, on the
    mesh's first device. On one shard the exchange is the identity.
    """
    if mesh.n_shards != n_shards:
        raise ValueError(f"{n_shards=} on a mesh of {mesh.n_shards}")
    sends = [_send_buffers(v, i, lf, n_shards=n_shards,
                           leaves_per_shard=leaves_per_shard,
                           capacity=capacity, wire_dtype=wire_dtype)
             for v, i, lf in zip(vecs, ids, leaves)]
    overflow = collectives.psum([snd[3] for snd in sends], mesh)
    # the wire; each field's send buffers are freed once it has crossed
    recv = []
    for j in range(3):
        recv.append(collectives.all_to_all([snd[j] for snd in sends], mesh))
        sends = [snd[:j] + (None,) + snd[j + 1:] for snd in sends]
    return [Routed(vecs=rv, ids=ri, leaves=rl, overflow=overflow)
            for rv, ri, rl in zip(*recv)]


def cluster_sort(routed: Routed, *, leaf_base: int, leaves_per_shard: int,
                 dtype: torch.dtype | None = None):
    """Reduce-side merge: sort received rows by leaf, build CSR offsets.

    Returns (vecs, ids, leaves, offsets, n_valid) where offsets has length
    ``leaves_per_shard + 1`` over *local* leaf ids; ``vecs`` in ``dtype``
    when it is given (the payload widened after the sort: the same values).
    """
    order = torch.argsort(routed.leaves, stable=True)
    vecs = routed.vecs[order]
    if dtype is not None:
        vecs = vecs.to(dtype)
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
