"""Cell/ArchDef machinery shared by every architecture config: the JAX
package's ``configs/base.py``.

A *cell* = (architecture x input shape). The reference's cell lowers its
step for a TPU mesh and reads XLA's cost of it. A port cell says

* what its arguments are at full shape (:meth:`Cell.abstract`: a tree of
  :class:`~repro_torch.distributed.shardutil.Arg`, whose bytes one device
  of a layout holds follow from ``distributed.partitioning``);
* how many bytes one card needs at a batch: its arguments as the card
  holds them, plus the step's working set (its activation estimate,
  ``work_fn``, stated by each family);
* the cut it runs at on one card (:meth:`Cell.card_cut`): the largest
  batch whose bytes fit the card, decided before the run. A cell is cut
  only along its batch axis (sequences, samples, queries, rows of the
  sift100m corpus), never in width or depth;
* how to build itself on a device (:meth:`Cell.build`): the step
  function and its arguments, data and weights drawn from the seed
  through ``torch.Generator``s on that device.

Nothing here imports a family module: ``configs/__init__.py`` imports
them, and each registers its ``ArchDef``s.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from repro_torch.device import resolve
from repro_torch.distributed.partitioning import DEFAULT_RULES, AxisRules
from repro_torch.distributed.shardutil import device_bytes, total_bytes
from repro_torch.launch.mesh import card_layout, layout_name, make_production_layout

REGISTRY: Dict[str, "ArchDef"] = {}

#: the bytes a cut must fit on one H100 80GB: the 79.2 GiB its allocator
#: can reach, less room for the CUDA context, the kernels' workspaces and
#: the allocator's fragmentation
CARD_CAPACITY = 70 * 2**30

#: layouts offered, smallest first, for a cell that does not fit one card:
#: model-parallel over the cards of one host, then the reference's pods
HOLDING_LAYOUTS = ({"data": 1, "model": 2}, {"data": 1, "model": 4},
                   {"data": 1, "model": 8}, make_production_layout(),
                   make_production_layout(multi_pod=True))


def register(arch: "ArchDef") -> "ArchDef":
    REGISTRY[arch.name] = arch
    return arch


def get_arch(name: str) -> "ArchDef":
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def halvings(n: int) -> list[int]:
    """``n``, ``n / 2``, ... while ``n`` halves evenly, then 1: the batches
    a cut may take."""
    out = [n]
    while out[-1] % 2 == 0 and out[-1] > 1:
        out.append(out[-1] // 2)
    if out[-1] != 1:
        out.append(1)
    return out


@dataclasses.dataclass(frozen=True)
class CardCut:
    """The batch a cell runs at on one card and why."""

    axis: Optional[str]  # what the batch counts (sequences, rows, ...)
    full: int
    batch: int  # 0 when the cell does not fit even at batch 1
    need_bytes: int  # its arguments on the card plus the working set
    reason: str

    @property
    def fits(self) -> bool:
        return self.batch > 0


@dataclasses.dataclass
class Cell:
    """One (arch x shape) unit.

    ``args_fn(batch, layout, on_card)`` gives the tree of its arguments
    (``on_card``: as the card build holds them, e.g. an inference cell's
    weights in the compute dtype); ``flops_fn(batch)`` its useful FLOPs
    (6ND train / 2ND inference); ``work_fn(batch)`` the bytes its step
    needs beyond its arguments on the card (its activation estimate, which
    the family states); ``build_fn(device, batch, seed)`` returns ``(fn,
    args)`` with ``fn(*args)`` one step. ``batch = (axis, size)`` names
    what the cell may be cut along (``None``: it is never cut).
    """

    arch: str
    shape: str
    kind: str  # train | prefill | decode | serve
    args_fn: Callable
    flops_fn: Callable[[int], float]
    work_fn: Callable[[int], float]
    build_fn: Callable
    batch: Optional[tuple] = None
    donate: tuple = ()  # arguments the step updates in place
    skip: Optional[str] = None  # reason if this cell is a documented skip
    config: object = None
    rules: AxisRules = DEFAULT_RULES
    compute_dtype: torch.dtype = torch.float32  # whose peak its mfu reads
    # the FLOPs one step does at a batch, where they differ from
    # ``flops_fn``'s (the reference's model FLOPs, kept as they are)
    step_flops_fn: Optional[Callable[[int], float]] = None

    @property
    def full_batch(self) -> int:
        return self.batch[1] if self.batch else 1

    @property
    def model_flops(self) -> float:
        return self.flops_fn(self.full_batch)

    def step_flops(self, batch: int) -> float:
        """The useful FLOPs of one step at ``batch``, which ``mfu`` reads."""
        return (self.step_flops_fn or self.flops_fn)(batch)

    def abstract(self, layout=None):
        """The tree of its arguments at full shape on ``layout`` (the card
        when None), in the reference's dtypes."""
        return self.args_fn(self.full_batch, layout or card_layout(), False)

    def argument_bytes(self, layout) -> int:
        """Bytes of its arguments one device of ``layout`` holds."""
        return device_bytes(self.abstract(layout), layout, self.rules)

    def card_bytes(self, batch: int) -> int:
        """Its arguments as the card build holds them at ``batch``, plus
        the step's working set."""
        args = self.args_fn(batch, card_layout(), True)
        return int(total_bytes(args) + self.work_fn(batch))

    def card_cut(self, capacity: int = CARD_CAPACITY) -> CardCut:
        """The largest batch (a halving of the full one) whose bytes fit
        ``capacity``, or batch 0 with the bytes it needs at batch 1 and the
        smallest layout that would hold the whole cell."""
        axis, full = self.batch if self.batch else (None, 1)
        sizes = halvings(full) if self.batch else [1]
        for b in sizes:
            need = self.card_bytes(b)
            if need <= capacity:
                why = ("fits whole" if b == full else
                       f"{axis} cut {full} -> {b}: {self.card_bytes(full)} B "
                       f"at full size over {capacity} B")
                return CardCut(axis, full, b, need, why)
        need = self.card_bytes(sizes[-1])
        at = f"{axis} {sizes[-1]}" if self.batch else "its only size"
        holding, per = self.holding_layout(capacity)
        where = (f"smallest layout holding it: {holding} ({per} B a device)" if holding
                 else "no layout offered holds it")
        return CardCut(axis, full, 0, need,
                       f"needs {need} B at {at}, over one card's {capacity} B; {where}")

    def holding_layout(self, capacity: int) -> tuple[Optional[str], int]:
        """The smallest layout of :data:`HOLDING_LAYOUTS` whose devices each
        hold the whole cell within ``capacity``, by name, with the bytes a
        device holds there (``(None, 0)`` when none does)."""
        on_card = self.args_fn(self.full_batch, card_layout(), True)
        work = self.work_fn(self.full_batch)
        for layout in HOLDING_LAYOUTS:
            per = int(device_bytes(on_card, layout, self.rules)
                      + work / layout_devices(layout))
            if per <= capacity:
                return layout_name(layout), per
        return None, 0

    def build(self, device="cuda", batch: int | None = None, seed: int = 0):
        """``(fn, args)`` on ``device`` (the card unless the caller passes
        ``"cpu"``) at ``batch`` (the card cut's when None)."""
        dev = resolve(device)
        if batch is None:
            cut = self.card_cut()
            if not cut.fits:
                raise ValueError(f"{self.arch} {self.shape}: {cut.reason}")
            batch = cut.batch
        return self.build_fn(dev, batch, seed)


def layout_devices(layout) -> int:
    return math.prod(layout.values())


@dataclasses.dataclass
class ArchDef:
    name: str
    family: str  # lm | gnn | recsys | index
    config: object
    cells: Dict[str, Callable[[], Cell]]  # shape name -> cell factory
    smoke: Callable[..., dict]  # tiny end-to-end step; ``smoke(device=...)``

    def cell(self, shape: str) -> Cell:
        if shape not in self.cells:
            raise KeyError(
                f"arch {self.name} has no shape {shape!r}; has {sorted(self.cells)}"
            )
        return self.cells[shape]()
