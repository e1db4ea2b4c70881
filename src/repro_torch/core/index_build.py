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
from repro_torch.core.tree import VocabTree, tree_assign, tree_on
from repro_torch.distributed import collectives
from repro_torch.distributed.meshutil import DeviceMesh, as_mesh, round_up


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
    leaf_base: int = 0  # the first leaf this shard owns (a part of a MeshIndex)

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

    @property
    def parts(self) -> tuple["DistributedIndex", ...]:
        """The one-shard parts, as :attr:`MeshIndex.parts`: itself."""
        return (self,)

    @property
    def mesh(self) -> DeviceMesh:
        return DeviceMesh((self.device,))


@dataclasses.dataclass
class MeshIndex:
    """An index of S shards over a mesh: shard ``s`` is ``parts[s]``, a
    one-shard :class:`DistributedIndex` on ``mesh.devices[s]`` whose
    ``leaf_base`` is ``s * leaves_per_shard``. Every part has the same
    row count. A shard's rows stay on its device; only the scans' k-NN
    tables and counts travel, to the first device."""

    parts: tuple[DistributedIndex, ...]
    mesh: DeviceMesh
    overflow: torch.Tensor  # () int32 rows dropped in routing, on mesh.first
    n_leaves: int = 0

    def __post_init__(self):
        if len(self.parts) != self.mesh.n_shards:
            raise ValueError(f"{len(self.parts)} parts on a mesh of "
                             f"{self.mesh.n_shards}")
        lps = self.parts[0].leaves_per_shard
        for s, (p, dev) in enumerate(zip(self.parts, self.mesh.devices)):
            if (p.device != dev or p.n_shards != 1 or p.rows != self.parts[0].rows
                    or p.leaves_per_shard != lps or p.leaf_base != s * lps):
                raise ValueError(f"part {s} is not shard {s} of this mesh")

    @property
    def rows(self) -> int:
        return sum(p.rows for p in self.parts)

    @property
    def leaves_per_shard(self) -> int:
        return self.parts[0].leaves_per_shard

    @property
    def n_shards(self) -> int:
        return len(self.parts)

    @property
    def device(self) -> torch.device:
        """The first shard's device, where searches merge and answer."""
        return self.mesh.first

    @property
    def n_valid(self) -> torch.Tensor:
        """(S,) valid rows per shard, on the first device."""
        return collectives.gather([p.n_valid[0] for p in self.parts], self.mesh)


#: a DistributedIndex's arrays, in the order the JAX package's pytree
#: flattens it (and its segments store them)
INDEX_FIELDS = ("vecs", "ids", "leaves", "offsets", "n_valid", "overflow")


def from_global(fields: dict, *, n_leaves: int,
                mesh: DeviceMesh) -> DistributedIndex | MeshIndex:
    """An index from the JAX package's global arrays (tensors or numpy,
    anywhere; ``vecs (S*R, d)``, ``offsets (S, L/S+1)``, ...): shard
    ``s``'s block of rows, its offsets row and its ``n_valid`` on
    ``mesh.devices[s]``; one shard gives a ``DistributedIndex``."""
    offsets = torch.as_tensor(fields["offsets"])
    n_shards = offsets.shape[0]
    if mesh.n_shards != n_shards:
        raise ValueError(f"arrays of {n_shards} shards, mesh of {mesh.n_shards}")
    vecs, ids, leaves, n_valid, overflow = (
        torch.as_tensor(fields[f]) for f in ("vecs", "ids", "leaves", "n_valid",
                                             "overflow"))
    rows = vecs.shape[0] // n_shards
    lps = offsets.shape[1] - 1
    parts = []
    for s, dev in enumerate(mesh.devices):
        blk = slice(s * rows, (s + 1) * rows)
        parts.append(DistributedIndex(
            vecs=vecs[blk].to(dev, torch.float32).contiguous(),
            ids=ids[blk].to(dev, torch.int32), leaves=leaves[blk].to(dev, torch.int32),
            offsets=offsets[s:s + 1].to(dev, torch.int32),
            n_valid=n_valid.reshape(-1)[s:s + 1].to(dev, torch.int32),
            overflow=overflow.to(dev, torch.int32), n_leaves=int(n_leaves),
            leaf_base=s * lps))
    if n_shards == 1:
        return parts[0]
    return MeshIndex(parts=tuple(parts), mesh=mesh, overflow=parts[0].overflow,
                     n_leaves=int(n_leaves))


def to_global(index: DistributedIndex | MeshIndex) -> dict:
    """The JAX package's global arrays of an index (its
    :data:`INDEX_FIELDS`): a one-shard index's own tensors, a MeshIndex's
    parts concatenated on the host."""
    if index.n_shards == 1:
        return {f: getattr(index.parts[0], f) for f in INDEX_FIELDS}
    out = {f: torch.cat([getattr(p, f).cpu() for p in index.parts])
           for f in INDEX_FIELDS[:-1]}
    out["overflow"] = index.overflow.cpu()
    return out


def place(index: DistributedIndex | MeshIndex,
          mesh: DeviceMesh) -> DistributedIndex | MeshIndex:
    """``index`` with its S shards on the devices of ``mesh`` (of ``m``
    devices, ``m`` dividing S): consecutive groups of S / m shards a
    device, each shard's rows, leaves and leaf range as they were -- the
    placement of a scatter leg's segments on its submesh. The shards of a
    group then run in turn on their device."""
    parts = index.parts
    n, m = len(parts), mesh.n_shards
    if n % m:
        raise ValueError(f"{n} shards do not split over {m} devices")
    devs = tuple(mesh.devices[s * m // n] for s in range(n))
    if devs == index.mesh.devices:
        return index
    moved = tuple(dataclasses.replace(
        p, **{f: getattr(p, f).to(dev) for f in INDEX_FIELDS})
        for p, dev in zip(parts, devs))
    if n == 1:
        return moved[0]
    return MeshIndex(parts=moved, mesh=DeviceMesh(devs),
                     overflow=index.overflow.to(devs[0]),
                     n_leaves=index.n_leaves)


def index_ids(index: DistributedIndex | MeshIndex) -> torch.Tensor:
    """The ids of every row, in global row order, on the first device."""
    if index.n_shards == 1:
        return index.parts[0].ids
    return torch.cat([p.ids.to(index.device) for p in index.parts])


def index_rows(index: DistributedIndex | MeshIndex,
               rows: torch.Tensor) -> torch.Tensor:
    """The vectors of global ``rows`` (int64 on the first device), gathered
    on the first device: each shard sends only the rows asked of it."""
    if index.n_shards == 1:
        return index.parts[0].vecs[rows]
    r = index.parts[0].rows
    out = torch.empty((rows.numel(), index.parts[0].vecs.shape[1]),
                      dtype=torch.float32, device=index.device)
    shard = torch.div(rows, r, rounding_mode="floor")
    for s, part in enumerate(index.parts):
        sel = torch.nonzero(shard == s)[:, 0]
        local = (rows[sel] - s * r).to(part.device)
        out[sel] = part.vecs[local].to(index.device)
    return out


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
    mesh: DeviceMesh | None = None,
) -> DistributedIndex | MeshIndex:
    """Build the leaf-sorted index of ``vecs`` (n, d), on ``device`` or
    over the shards of ``mesh``.

    With one shard ``tree`` must live on ``device``, and the send capacity
    is ``capacity_factor`` times the rows, so the index holds that many
    rows, the surplus ``LEAF_SENTINEL`` padding at the tail -- the
    reference's shape. Rows are assigned in waves of ``wave_rows``
    (default 4096) and a ragged last wave of the remainder, so a row count
    off the wave grid still runs ceil(n / wave_rows) waves; every wave
    size gives the same index, bit for bit.

    Over a mesh of S shards (the JAX package's ``build_index`` on a mesh):
    ``n_leaves`` must divide over S; the rows are padded to a multiple of
    S with id -1 and split into S contiguous blocks, block ``s`` assigned
    on ``mesh.devices[s]`` against its copy of the tree, routed with the
    capacity ``routing_capacity(rows / S, S, capacity_factor)`` per (source,
    destination) pair, and cluster-sorted there. A mesh of one shard gives
    the one-shard build.
    """
    mesh = as_mesh(mesh, device)
    n_shards = mesh.n_shards
    if n_shards == 1 and tree.device != mesh.first:
        raise ValueError(f"tree on {tree.device}, build on {mesh.first}")
    n_leaves = tree.n_leaves
    if n_leaves % n_shards:
        raise ValueError(f"n_leaves {n_leaves} must divide over {n_shards} shards")
    leaves_per_shard = n_leaves // n_shards
    vecs = torch.as_tensor(vecs)
    if n_shards == 1:
        vecs = vecs.to(mesh.first)
    n, d = vecs.shape
    if ids is None:
        ids = torch.arange(n, dtype=torch.int32, device=vecs.device)
    ids = torch.as_tensor(ids, dtype=torch.int32, device=vecs.device)
    rows = round_up(n, n_shards) // n_shards
    wave_rows = wave_rows or 4096
    capacity = routing_capacity(rows, n_shards, capacity_factor)
    trees = {dev: tree_on(tree, dev) for dev in mesh.distinct}
    # --- map: each shard assigns its block in waves ------------------------
    blocks, id_blocks, leaves = [], [], []
    for s, dev in enumerate(mesh.devices):
        v = vecs[s * rows:(s + 1) * rows].to(dev)
        i = ids[s * rows:(s + 1) * rows].to(dev)
        if v.shape[0] < rows:  # padding rows: id -1, routed, never matched
            short = rows - v.shape[0]
            v = torch.cat([v, v.new_zeros((short, d))])
            i = torch.cat([i, i.new_full((short,), -1)])
        blocks.append(v)
        id_blocks.append(i)
        leaves.append(_assign_in_waves(trees[dev], v, wave_rows))
    # --- shuffle: route to the owner shards --------------------------------
    routed = route_lib.route_by_leaf(
        blocks, id_blocks, leaves, n_shards=n_shards,
        leaves_per_shard=leaves_per_shard, capacity=capacity,
        wire_dtype=wire_dtype, mesh=mesh)
    del blocks, id_blocks, leaves
    overflow = routed[0].overflow
    # --- reduce: each shard's cluster sort + CSR, its received rows freed
    # once sorted ----------------------------------------------------------
    parts = []
    for s, dev in enumerate(mesh.devices):
        r, routed[s] = routed[s], None
        base = s * leaves_per_shard
        svecs, sids, sleaves, offsets, n_valid = route_lib.cluster_sort(
            r, leaf_base=base, leaves_per_shard=leaves_per_shard,
            dtype=vecs.dtype)
        del r
        parts.append(DistributedIndex(
            vecs=svecs, ids=sids, leaves=sleaves, offsets=offsets[None],
            n_valid=n_valid[None], overflow=overflow.to(dev),
            n_leaves=n_leaves, leaf_base=base))
    if n_shards == 1:
        return parts[0]
    return MeshIndex(parts=tuple(parts), mesh=mesh, overflow=overflow,
                     n_leaves=n_leaves)
