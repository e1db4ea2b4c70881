"""Meshes of devices: one process drives every shard.

The JAX package runs its two jobs under ``shard_map`` over a mesh: one
program, one shard per device. The port's counterpart is one process
driving a tuple of devices, as FAISS's ``IndexShards`` drives several
GPUs: shard ``s`` keeps its rows on ``mesh.devices[s]``, its scans launch
there, and the exchange between shards is device-to-device copies
(:mod:`repro_torch.distributed.collectives`).

A device may repeat. Its shards then run in turn on it, with the numerics
of separate devices -- the JAX package's "sequential-but-isolated" regime
-- which is how the CPU tests, and a machine with one card, run S > 1.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """One ``torch.device`` per data shard, in shard order."""

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        devs = tuple(resolve(d) for d in self.devices)
        for d in devs:
            if d.type == "cuda" and d.index >= torch.cuda.device_count():
                raise RuntimeError(
                    f"mesh names {d}, but this machine has "
                    f"{torch.cuda.device_count()} CUDA device(s)")
        object.__setattr__(self, "devices", devs)

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        """Where the tables of a search are merged and its result lives."""
        return self.devices[0]

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """Each device once, in order of first appearance."""
        return tuple(dict.fromkeys(self.devices))


def local_mesh(device: str | torch.device | None = "cuda") -> DeviceMesh:
    """One shard per visible card (``device="cuda"``), or one shard on the
    device named (``"cuda:N"``, ``"cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        resolve(dev)  # raises without a card
        return DeviceMesh(tuple(torch.device("cuda", i)
                                for i in range(torch.cuda.device_count())))
    return DeviceMesh((resolve(dev),))


def as_mesh(mesh: DeviceMesh | None, device) -> DeviceMesh:
    """``mesh``, or the one-shard mesh of ``device``."""
    return mesh if mesh is not None else DeviceMesh((resolve(device),))


def round_up(x: int, m: int) -> int:
    """``x`` rounded up to a multiple of ``m``."""
    return ((x + m - 1) // m) * m


def data_axis_size(mesh: DeviceMesh) -> int:
    """Total number of row shards."""
    return mesh.n_shards


def shard_submeshes(mesh: DeviceMesh, n_shards: int) -> tuple[DeviceMesh, ...]:
    """Per-shard meshes for scatter-gather serving, by the JAX package's
    rule: when the mesh's devices split evenly over ``n_shards`` (and there
    is more than one), each shard gets its own contiguous group, so shard
    scans run on separate devices; otherwise every shard shares ``mesh``
    and the scans run one after another with identical numerics."""
    if n_shards < 1:
        raise ValueError(f"{n_shards=} must be >= 1")
    if n_shards == 1:
        return (mesh,)
    rows = mesh.n_shards
    per = rows // n_shards
    if per < 1 or rows % n_shards or rows == 1:
        return (mesh,) * n_shards
    return tuple(DeviceMesh(mesh.devices[s * per:(s + 1) * per])
                 for s in range(n_shards))
