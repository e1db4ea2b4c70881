"""Logical-axis partitioning with divisibility fallback: the JAX package's
``distributed/partitioning.py``, over layouts rather than device meshes.

Every parameter and argument names its dims with *logical* axes
(``("layers", "embed", "ffn")``); a rule table maps logical axes to mesh
axes. A mesh axis is applied only if the dim is divisible by the product
of the mapped mesh axes' sizes; otherwise that dim falls back to
replicated. This is what lets llama3.2's 24 query heads (not divisible by
model = 16) keep the rest of the layer sharded: the head axis replicates,
the fused head * dim projection axis shards.

A *layout* is an ordered ``{mesh axis name: size}`` mapping, such as the
reference's production ``{"data": 16, "model": 16}``
(:func:`repro_torch.launch.mesh.make_production_layout`). No device is
needed to reason about one. A spec is a plain tuple with one entry per
dim: ``None``, a mesh axis name, or a tuple of names.

The reference's ``constrain`` (``with_sharding_constraint`` inside a
traced program) has no counterpart: the port runs eagerly, one process
driving each device of a :class:`~repro_torch.distributed.meshutil.DeviceMesh`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence, Union

MeshAxes = Union[None, str, tuple[str, ...]]
Layout = Mapping[str, int]


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Mapping logical axis name -> mesh axis (or tuple of mesh axes)."""

    rules: Mapping[str, MeshAxes]

    def mesh_axes(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        return self.rules.get(logical, None)

    def extend(self, **updates: MeshAxes) -> "AxisRules":
        merged = dict(self.rules)
        merged.update(updates)
        return AxisRules(merged)


#: Default rules shared by all architectures. ``rows`` is the HDFS-block /
#: batch analog; ``model_dim``-family axes go to the model axis.
DEFAULT_RULES = AxisRules(
    {
        # batch-like / row-like axes -> data parallel (incl. pod axis)
        "batch": ("pod", "data"),
        "rows": ("pod", "data"),
        "edges": ("pod", "data"),
        # KV-cache sequence: context parallelism over whatever axes the
        # batch dim left free (decode_32k -> model; long_500k -> all three)
        "kv_seq": ("pod", "data", "model"),
        # model-parallel axes
        "vocab": "model",
        "ffn": "model",
        "heads": "model",
        "kv_heads": "model",
        "qkv": "model",
        "experts": "model",
        "table_rows": "model",
        "clusters": "model",
        "candidates": "model",
        "nodes": "model",
        # never sharded
        "layers": None,
        "embed": None,
        "head_dim": None,
        "seq": None,
        "feat": None,
    }
)


def partition_spec(
    shape: Sequence[int],
    logical_axes: Sequence[Optional[str]],
    layout: Layout,
    rules: AxisRules = DEFAULT_RULES,
) -> tuple:
    """The spec of ``shape`` on ``layout``, with divisibility fallback.

    A mesh axis may be used at most once across dims (first dim wins);
    only axes the layout has count; non-divisible dims replicate.

    Raises:
      ValueError: ``shape`` and ``logical_axes`` differ in rank.
    """
    if len(shape) != len(logical_axes):
        raise ValueError(
            f"shape {tuple(shape)} and logical axes {tuple(logical_axes)} "
            "must have equal rank"
        )
    used: set[str] = set()
    out: list[MeshAxes] = []
    for dim, logical in zip(shape, logical_axes):
        axes = rules.mesh_axes(logical)
        if axes is None:
            out.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        # only mesh axes that exist on this layout and are still free
        axes = tuple(a for a in axes if a in layout and a not in used)
        total = math.prod(layout[a] for a in axes) if axes else 1
        if axes and dim % total == 0 and total > 1:
            out.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            out.append(None)
    return tuple(out)


def shard_shape(shape: Sequence[int], spec: Sequence[MeshAxes], layout: Layout
                ) -> tuple:
    """The shape one device holds of an array of ``shape`` laid out by
    ``spec`` on ``layout`` (each dim divided by its mesh axes' sizes)."""
    out = []
    for dim, axes in zip(shape, spec):
        if axes is None:
            out.append(dim)
            continue
        names = (axes,) if isinstance(axes, str) else axes
        n = math.prod(layout[a] for a in names)
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {names} ({n})")
        out.append(dim // n)
    return tuple(out)


def shard_specs(spec_tree, layout: Layout, rules: AxisRules = DEFAULT_RULES):
    """A tree of ``ParamSpec`` (``repro_torch.models.module``) mapped to
    the spec tuple of each leaf on ``layout``."""
    from repro_torch.models.module import ParamSpec  # local import, avoid cycle

    if isinstance(spec_tree, ParamSpec):
        return partition_spec(spec_tree.shape, spec_tree.axes, layout, rules)
    if isinstance(spec_tree, dict):
        return {key: shard_specs(v, layout, rules) for key, v in spec_tree.items()}
    raise TypeError(f"expected ParamSpec, got {type(spec_tree)}")
