"""The collectives of the two jobs, across the shards of a mesh.

Stand-ins for the ``jax.lax`` collectives that the JAX package calls
inside ``shard_map``, for one process driving every device of a
:class:`~repro_torch.distributed.meshutil.DeviceMesh`. Each takes one
tensor per shard, shard ``s``'s on ``mesh.devices[s]``. A copy between
two cards is a peer copy (NVLink where the cards have it) that PyTorch
orders after the source's and before the destination's current streams;
a copy to the same device is none at all.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.distributed.meshutil import DeviceMesh


def _check(parts: Sequence[torch.Tensor], mesh: DeviceMesh) -> None:
    if len(parts) != mesh.n_shards:
        raise ValueError(f"{len(parts)} tensors for {mesh.n_shards} shards")
    for s, (t, dev) in enumerate(zip(parts, mesh.devices)):
        if t.device != dev:
            raise ValueError(f"shard {s}'s tensor on {t.device}, mesh says {dev}")


def all_to_all(sends: Sequence[torch.Tensor], mesh: DeviceMesh
               ) -> list[torch.Tensor]:
    """``jax.lax.all_to_all(x, axis, 0, 0, tiled=True)``: each send buffer
    is S blocks along dim 0; shard ``d`` receives block ``d`` of every
    shard's buffer, in shard order, on its own device. One shard receives
    its own send buffer, not a copy."""
    _check(sends, mesh)
    n = mesh.n_shards
    if n == 1:
        return list(sends)
    if sends[0].shape[0] % n:
        raise ValueError(f"dim 0 ({sends[0].shape[0]}) does not split over {n}")
    c = sends[0].shape[0] // n
    return [torch.cat([src[d * c:(d + 1) * c].to(dev, non_blocking=True)
                       for src in sends])
            for d, dev in enumerate(mesh.devices)]


def gather(parts: Sequence[torch.Tensor], mesh: DeviceMesh) -> torch.Tensor:
    """The shards' tensors stacked on a new leading axis, on the first
    device."""
    _check(parts, mesh)
    return torch.stack([t.to(mesh.first, non_blocking=True) for t in parts])


def psum(parts: Sequence[torch.Tensor], mesh: DeviceMesh) -> torch.Tensor:
    """The sum of the shards' scalars, in shard order, on the first device,
    in their dtype (as ``jax.lax.psum``: int32 counts stay int32)."""
    return gather(parts, mesh).sum(0, dtype=parts[0].dtype)


def broadcast(t: torch.Tensor, mesh: DeviceMesh) -> list[torch.Tensor]:
    """``t`` on every shard's device (one copy per distinct device)."""
    on = {dev: t.to(dev, non_blocking=True) for dev in mesh.distinct}
    return [on[dev] for dev in mesh.devices]
