"""Abstract argument trees and their layouts: the JAX package's
``distributed/shardutil.py``.

An :class:`Arg` is the port's ``jax.ShapeDtypeStruct`` with its logical
axes: what a cell's argument is at full shape, without a byte of it on a
device. :func:`tree_shardings` maps a tree of them to the spec tuple of
each leaf on a layout (``distributed.partitioning``), and
:func:`device_bytes` sums what one device of the layout holds.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed.partitioning import (
    DEFAULT_RULES,
    AxisRules,
    Layout,
    partition_spec,
    shard_shape,
)
from repro_torch.train import tree


@dataclasses.dataclass(frozen=True)
class Arg:
    """One argument at a cell's full shape: its shape, dtype and logical
    axes (``None`` for a replicated dim)."""

    shape: tuple
    dtype: torch.dtype
    axes: tuple = None

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(self.shape))
        if self.axes is None:
            object.__setattr__(self, "axes", (None,) * len(self.shape))
        if len(self.axes) != len(self.shape):
            raise ValueError(f"rank mismatch: {self.shape} vs {self.axes}")

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


def abstract_params(spec_tree, dtype: torch.dtype | None = None):
    """A ``ParamSpec`` tree as :class:`Arg` leaves, in each spec's dtype
    (or ``dtype`` when given: the dtype the card holds the weights in)."""
    return tree.map_(lambda s: Arg(s.shape, dtype or s.dtype, s.axes), spec_tree)


def abstract_opt_state(params_abstract):
    """The AdamW state of a params tree (``train/optimizer.py``): ``m``
    and ``v`` in fp32, each moment with its parameter's axes (so its
    layout), and the replicated int32 step."""
    m = tree.map_(lambda a: Arg(a.shape, torch.float32, a.axes), params_abstract)
    return {"m": m, "v": tree.map_(lambda a: a, m),
            "step": Arg((), torch.int32, ())}


def tree_shardings(abstract_tree, layout: Layout, rules: AxisRules = DEFAULT_RULES):
    """The spec tuple of each :class:`Arg` of ``abstract_tree`` on
    ``layout``, by its logical axes (the reference's ``axes_fn(path)`` is
    each leaf's own ``axes`` here)."""
    specs = [partition_spec(a.shape, a.axes, layout, rules)
             for a in tree.leaves(abstract_tree)]
    return tree.unflatten(abstract_tree, specs)


def device_bytes(abstract_tree, layout: Layout, rules: AxisRules = DEFAULT_RULES
                 ) -> int:
    """Bytes one device of ``layout`` holds of ``abstract_tree``."""
    total = 0
    for a in tree.leaves(abstract_tree):
        spec = partition_spec(a.shape, a.axes, layout, rules)
        total += math.prod(shard_shape(a.shape, spec, layout)) * a.dtype.itemsize
    return total


def total_bytes(abstract_tree) -> int:
    """Bytes of every leaf of ``abstract_tree`` on one device."""
    return sum(a.nbytes for a in tree.leaves(abstract_tree))
