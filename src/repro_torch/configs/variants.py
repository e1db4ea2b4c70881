"""Named beyond-baseline variants for the hill-climb: the JAX package's
``configs/variants.py``.

``apply(name, arch, shape)`` returns a cell identical to the baseline
except for one change, so before/after rooflines isolate that change.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import lm
from repro_torch.configs.base import Cell


def _lm_cell_with(cfg, arch: str, shape: str, **kw) -> Cell:
    shapes = {
        "train_4k": lambda: lm.make_train_cell(arch, cfg, **lm.TRAIN_4K, **kw),
        "prefill_32k": lambda: lm.make_prefill_cell(arch, cfg, **lm.PREFILL_32K),
        "decode_32k": lambda: lm.make_decode_cell(
            arch, cfg, shape_name="decode_32k", **lm.DECODE_32K),
        "long_500k": lambda: lm.make_decode_cell(
            arch, cfg, shape_name="long_500k", **lm.LONG_500K),
    }
    return shapes[shape]()


def _padded_heads(cfg) -> int:
    return ((cfg.n_heads + 15) // 16) * 16


def routed_moe(arch: str, shape: str) -> Cell:
    """Hillclimb #1: MoE dispatch routed to the experts' owner shards
    (``moe_impl="routed"``; over a ``DeviceMesh`` of S > 1 shards)."""
    cfg = dataclasses.replace(lm.CONFIG_BY_ARCH[arch], moe_impl="routed")
    return _lm_cell_with(cfg, arch, shape)


def head_pad(arch: str, shape: str) -> Cell:
    """Hillclimb #3 (llama3.2): pad 24 query heads -> 32 so the head axis
    divides model=16 and attention shards without replicate-then-partition
    resharding. +33% attention-einsum compute and ~3% params; a production
    deployment zero-initialises and freezes the 8 pad heads (wo rows = 0),
    which is bit-identical to the 24-head model."""
    cfg = lm.CONFIG_BY_ARCH[arch]
    return _lm_cell_with(dataclasses.replace(cfg, n_heads=_padded_heads(cfg)), arch, shape)


def head_pad_chunked(arch: str, shape: str) -> Cell:
    """Hillclimb #3 iteration 2: head padding + chunked (flash-dataflow)
    attention -- bounds the materialised score tile to (Sq, chunk)."""
    cfg = lm.CONFIG_BY_ARCH[arch]
    cfg = dataclasses.replace(cfg, n_heads=_padded_heads(cfg), attn_impl="chunked",
                              attn_chunk=1024)
    return _lm_cell_with(cfg, arch, shape)


def remat_full(arch: str, shape: str) -> Cell:
    """Memory knob: full remat (nothing saved) for train cells."""
    cfg = dataclasses.replace(lm.CONFIG_BY_ARCH[arch], remat="full")
    return _lm_cell_with(cfg, arch, shape)


def microbatch8(arch: str, shape: str) -> Cell:
    """Memory knob: 8-way gradient accumulation (train_4k)."""
    return _lm_cell_with(lm.CONFIG_BY_ARCH[arch], arch, "train_4k", microbatches=8)


VARIANTS = {
    "routed_moe": routed_moe,
    "head_pad": head_pad,
    "head_pad_chunked": head_pad_chunked,
    "remat_full": remat_full,
    "microbatch8": microbatch8,
}


def apply(name: str, arch: str, shape: str) -> Cell:
    if name not in VARIANTS:
        # search/index variants (the sift100m module's)
        from repro_torch.configs import sift_variants

        return sift_variants.apply(name, arch, shape)
    return VARIANTS[name](arch, shape)
