"""Index creation (paper section 2.3) on one GPU.

Map: the descriptor rows are assigned to tree leaves in *waves*
(microbatches -- the map-wave analog). Shuffle: rows are routed to the shard
owning their leaf range via capacity-padded counting sort (the exchange is
the identity on one shard). Reduce: the shard sorts its received rows by
leaf and builds CSR offsets -- the "index files which contain clustered
high-dimensional descriptors".
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import route as route_lib
from repro_torch.core.engine.plan import round_up
from repro_torch.core.tree import VocabTree, tree_assign
from repro_torch.device import resolve


@dataclasses.dataclass
class DistributedIndex:
    """Cluster-sorted descriptor shards + per-shard CSR offsets."""

    vecs: torch.Tensor  # (S*R, d) float32 rows, leaf-sorted per shard
    ids: torch.Tensor  # (S*R,) int32 global descriptor ids (-1 padding)
    leaves: torch.Tensor  # (S*R,) int32 leaf ids (LEAF_SENTINEL padding)
    offsets: torch.Tensor  # (S, leaves_per_shard+1) int32 CSR per shard
    n_valid: torch.Tensor  # (S,) int32 valid rows per shard
    overflow: torch.Tensor  # () int32 rows dropped in routing (0 when healthy)
    n_leaves: int = 0

    @property
    def rows(self) -> int:
        return self.vecs.shape[0]

    @property
    def leaves_per_shard(self) -> int:
        return self.offsets.shape[1] - 1

    @property
    def n_shards(self) -> int:
        return self.offsets.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vecs.device


def routing_capacity(rows_per_shard: int, n_shards: int,
                     capacity_factor: float) -> int:
    """Send capacity per (source shard, destination shard) pair."""
    expected = rows_per_shard / n_shards
    return round_up(max(8, int(math.ceil(expected * capacity_factor))), 8)


def _assign_in_waves(tree: VocabTree, vecs: torch.Tensor, wave_rows: int) -> torch.Tensor:
    """Map phase: leaf assignment microbatched into waves of ``wave_rows``
    rows, the last one ragged (it holds the remainder); waves bound the
    gather working set of deep tree levels. Assignment is row by row, so
    the wave size does not change the leaves."""
    if wave_rows < 1:
        raise ValueError(f"wave_rows must be positive; got {wave_rows}")
    return torch.cat([tree_assign(tree, vecs[s:s + wave_rows])
                      for s in range(0, vecs.shape[0], wave_rows)])


def build_index(
    vecs,
    tree: VocabTree,
    *,
    ids=None,
    wave_rows: int | None = None,
    capacity_factor: float = 2.0,
    wire_dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device | None = "cuda",
) -> DistributedIndex:
    """Build the leaf-sorted index of ``vecs`` (n, d) on one shard.

    ``tree`` must live on ``device``. With one shard the send capacity is
    ``capacity_factor`` times the rows, so the index holds that many rows,
    the surplus ``LEAF_SENTINEL`` padding at the tail -- the reference's
    shape. Rows are assigned in waves of ``wave_rows`` (default 4096) and
    a ragged last wave of the remainder, so a row count off the wave grid
    still runs ceil(n / wave_rows) waves; every wave size gives the same
    index, bit for bit.
    """
    dev = resolve(device)
    vecs = torch.as_tensor(vecs, device=dev)
    n, d = vecs.shape
    n_shards = 1
    if ids is None:
        ids = torch.arange(n, dtype=torch.int32, device=dev)
    ids = torch.as_tensor(ids, dtype=torch.int32, device=dev)
    if tree.device != dev:
        raise ValueError(f"tree on {tree.device}, build on {dev}")
    n_leaves = tree.n_leaves
    wave_rows = wave_rows or 4096
    capacity = routing_capacity(n, n_shards, capacity_factor)
    leaves_per_shard = n_leaves // n_shards
    # --- map: assignment in waves ------------------------------------------
    leaves = _assign_in_waves(tree, vecs, wave_rows)
    # --- shuffle: route to the owner shard ---------------------------------
    routed = route_lib.route_by_leaf(
        vecs, ids, leaves, n_shards=n_shards, leaves_per_shard=leaves_per_shard,
        capacity=capacity, wire_dtype=wire_dtype)
    # --- reduce: cluster sort + CSR ----------------------------------------
    svecs, sids, sleaves, offsets, n_valid = route_lib.cluster_sort(
        routed, leaf_base=0, leaves_per_shard=leaves_per_shard)
    return DistributedIndex(
        vecs=svecs, ids=sids, leaves=sleaves, offsets=offsets[None],
        n_valid=n_valid[None], overflow=routed.overflow, n_leaves=n_leaves)
