"""Minimal parameter-spec module system.

A model is (a) a tree (nested dicts) of ``ParamSpec`` leaves describing
every weight's shape, dtype, init and logical axes, and (b) plain functions
over the materialised tree of tensors. The logical axes are kept for
parity with the JAX package's specs; on one card nothing is sharded.

``init_params`` draws from an explicit ``torch.Generator``: its numbers
differ from ``jax.random``'s, so tests that compare the two packages carry
the reference's weights across (``interop.transformer_params_from_numpy``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple  # logical axis names, same rank as shape (None = replicated)
    dtype: torch.dtype = torch.float32
    init: str = "normal"  # normal | zeros | ones | uniform
    scale: float | None = None  # default: 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"rank mismatch: {self.shape} vs {self.axes}")


def _leaves(tree, prefix=()):
    """(path, spec) pairs in sorted-key order (jax.tree's order for dicts)."""
    if isinstance(tree, ParamSpec):
        yield prefix, tree
        return
    for key in sorted(tree):
        yield from _leaves(tree[key], prefix + (key,))


def init_one(spec: ParamSpec, generator: torch.Generator, device: torch.device,
             dtype: torch.dtype | None = None) -> torch.Tensor:
    """One weight: drawn in fp32 on ``device``, then cast to ``dtype``
    (the spec's own unless given)."""
    dtype = dtype or spec.dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(max(1, fan_in))
    if spec.init == "normal":
        x = torch.randn(spec.shape, generator=generator, device=device)
    elif spec.init == "uniform":
        x = torch.rand(spec.shape, generator=generator, device=device).mul_(2.0).sub_(1.0)
    else:
        raise ValueError(f"unknown init {spec.init}")
    return x.mul_(scale).to(dtype)


def init_params(spec_tree, generator: torch.Generator, *,
                device: str | torch.device | None = "cuda",
                dtype: torch.dtype | None = None):
    """Materialise every ParamSpec, in sorted-key order, from one generator
    (which must live on ``device``). ``dtype`` casts every weight once
    after it is drawn: rounding fp32 weights to the compute dtype here
    gives the same bits as rounding them at every use."""
    dev = resolve(device)

    def build(tree):
        if isinstance(tree, ParamSpec):
            return init_one(tree, generator, dev, dtype)
        return {key: build(tree[key]) for key in sorted(tree)}

    return build(spec_tree)


def param_count(spec_tree) -> int:
    return sum(math.prod(s.shape) for _, s in _leaves(spec_tree))
