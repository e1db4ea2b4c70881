"""Layouts of the dry-run: the JAX package's ``launch/mesh.py``.

The reference builds its production meshes over TPU chips,
``(data=16, model=16)`` = 256 chips of a pod and ``(pod=2, data=16,
model=16)`` = 512 chips. The port keeps them as layouts, ordered
``{axis: size}`` mappings (``distributed.partitioning``), which need no
device: the dry-run's abstract mode reads per-device bytes from them.
The card's own layout is a ``DeviceMesh``'s shards on the data axis.
Importing this module touches no device.
"""

from __future__ import annotations

from repro_torch.distributed.meshutil import DeviceMesh


def make_production_layout(*, multi_pod: bool = False) -> dict:
    """``{"data": 16, "model": 16}``, or ``{"pod": 2, "data": 16,
    "model": 16}`` with ``multi_pod``."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def card_layout(mesh: DeviceMesh | None = None) -> dict:
    """``{"data": S, "model": 1}`` for a ``DeviceMesh`` of S shards (one
    card when ``mesh`` is None)."""
    return {"data": 1 if mesh is None else mesh.n_shards, "model": 1}


def layout_name(layout: dict) -> str:
    """``"16x16"``, ``"2x16x16"``; ``"card"`` for the one-card layout."""
    if layout == card_layout():
        return "card"
    return "x".join(str(n) for n in layout.values())
