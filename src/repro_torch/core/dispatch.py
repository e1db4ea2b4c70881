"""Capacity-padded dispatch/combine: the lookup table's grouping, reused.

The paper's lookup table "reorders query descriptors by their closest
representative" so per-cluster work becomes dense. MoE token dispatch
(group tokens by expert) is the same primitive. This module is the JAX
package's ``core/dispatch.py`` over the port's :func:`counting_layout`
(a stable counting sort, no one-hot product).

``assign`` maps each of n rows to a bucket in [0, n_buckets); each bucket
accepts up to ``capacity`` rows, in row order; the rest are dropped and
counted (MoE calls this token dropping; the paper calls it a failed task).
Rows assigned outside [0, n_buckets) are neither placed nor counted.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.route import counting_layout


class Dispatch(NamedTuple):
    gather_idx: torch.Tensor  # (n_buckets, capacity) row index (0 if empty)
    slot_valid: torch.Tensor  # (n_buckets, capacity) bool
    slot_of_row: torch.Tensor  # (n,) flat slot per row, -1 if dropped
    fits: torch.Tensor  # (n,) bool
    overflow: torch.Tensor  # () int32 dropped rows


def make_dispatch(assign: torch.Tensor, n_buckets: int, capacity: int) -> Dispatch:
    n = assign.shape[0]
    dev = assign.device
    layout = counting_layout(assign.to(torch.int32), n_buckets, capacity)
    flat = n_buckets * capacity
    # rows that do not fit land in one extra slot, cut off after: no mask,
    # so no wait for the device to size one
    slot = torch.where(layout.fits, layout.slot_of_row, flat)
    gather = torch.zeros((flat + 1,), dtype=torch.int32, device=dev)
    gather[slot] = torch.arange(n, dtype=torch.int32, device=dev)
    valid = torch.zeros((flat + 1,), dtype=torch.bool, device=dev)
    valid[slot] = True
    return Dispatch(
        gather_idx=gather[:flat].reshape(n_buckets, capacity),
        slot_valid=valid[:flat].reshape(n_buckets, capacity),
        slot_of_row=layout.slot_of_row.to(torch.int32),
        fits=layout.fits,
        overflow=layout.overflow,
    )


def dispatch_rows(d: Dispatch, x: torch.Tensor) -> torch.Tensor:
    """(n, ...) -> (n_buckets, capacity, ...), empty slots zeroed."""
    out = x[d.gather_idx.long()]
    mask_shape = d.slot_valid.shape + (1,) * (x.ndim - 1)
    return out * d.slot_valid.reshape(mask_shape).to(out.dtype)


def combine_rows(d: Dispatch, y: torch.Tensor, fill=0) -> torch.Tensor:
    """(n_buckets, capacity, ...) -> (n, ...); dropped rows get ``fill``."""
    nb, cap = d.gather_idx.shape
    flat = y.reshape((nb * cap,) + tuple(y.shape[2:]))
    n = d.slot_of_row.shape[0]
    out = flat[d.slot_of_row.clamp(0, nb * cap - 1).long()]
    keep = d.fits.reshape((n,) + (1,) * (y.ndim - 2))
    return torch.where(keep, out, torch.tensor(fill, dtype=out.dtype, device=out.device))
