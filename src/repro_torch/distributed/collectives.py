"""The collectives of the two jobs, across the shards of a mesh.

Stand-ins for the ``jax.lax`` collectives that the JAX package calls
inside ``shard_map``, for one process driving every device of a
:class:`~repro_torch.distributed.meshutil.DeviceMesh`. Each takes one
tensor per shard, shard ``s``'s on ``mesh.devices[s]``. A copy between
two cards is a peer copy (NVLink where the cards have it) that PyTorch
orders after the source's and before the destination's current streams;
a copy to the same device is none at all.

``wire_bytes`` counts, by collective, the bytes each call moved between
two distinct devices (a copy within one device counts 0); the dry-run's
roofline reads it (``launch/roofline.py``) and ``reset_wire_bytes``
zeroes it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.distributed.meshutil import DeviceMesh

wire_bytes = {"all_to_all": 0, "gather": 0, "psum": 0, "broadcast": 0}


def reset_wire_bytes() -> None:
    for op in wire_bytes:
        wire_bytes[op] = 0


def _moved(op: str, t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``, its bytes counted under ``op`` when that is
    another device."""
    if t.device != dev:
        wire_bytes[op] += t.numel() * t.element_size()
    return t.to(dev, non_blocking=True)


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
    return [torch.cat([_moved("all_to_all", src[d * c:(d + 1) * c], dev)
                       for src in sends])
            for d, dev in enumerate(mesh.devices)]


def gather(parts: Sequence[torch.Tensor], mesh: DeviceMesh, *, op: str = "gather"
           ) -> torch.Tensor:
    """The shards' tensors stacked on a new leading axis, on the first
    device (their bytes counted under ``op``)."""
    _check(parts, mesh)
    return torch.stack([_moved(op, t, mesh.first) for t in parts])


def psum(parts: Sequence[torch.Tensor], mesh: DeviceMesh) -> torch.Tensor:
    """The sum of the shards' scalars, in shard order, on the first device,
    in their dtype (as ``jax.lax.psum``: int32 counts stay int32)."""
    return gather(parts, mesh, op="psum").sum(0, dtype=parts[0].dtype)


def broadcast(t: torch.Tensor, mesh: DeviceMesh) -> list[torch.Tensor]:
    """``t`` on every shard's device (one copy per distinct device)."""
    on = {dev: _moved("broadcast", t, dev) for dev in mesh.distinct}
    return [on[dev] for dev in mesh.devices]
