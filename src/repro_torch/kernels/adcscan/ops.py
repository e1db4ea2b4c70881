"""Same-leaf ADC top-k tile wrapper: the plain version for a CPU tensor,
the K4 CUDA kernel (``csrc/adcscan.cu``) for a CUDA tensor at ``k <= 128``
(its lists' capacity), the block list kernel (``csrc/widetopk.cu``) past
that, up to the wave's rows (``l2topk.ops.route`` with no wide range: K4
with lists of 256 gained nothing resolved over the block list kernel).

The kernel takes a wave's point leaves in ascending order, as the
leaf-sorted shard holds them, with the wave's ids: one block per lookup
row searches its leaf's run and scans only that run, its warps splitting
it, skipping rows with id < 0 (tombstones keep their leaf, so the order
holds). In the wave sweep it is given the whole LUT and the slab's start
on the device, and reads only the LUTs of the slab rows whose leaf the
wave holds. The sentinels
keep their meaning: a point leaf of ``LEAF_SENTINEL`` (routing padding,
sorted last) and a padded lookup row's ``PAD_QUERY_LEAF`` never equal a
real leaf or each other.
"""

from __future__ import annotations

import torch

from repro_torch.core.sentinels import PAD_TILE_POINT_LEAF
from repro_torch.device import check_kernel_inputs
from repro_torch.kernels import _build
from repro_torch.kernels.adcscan.ref import adc_topk_ref
from repro_torch.kernels.l2topk.ops import (
    WIDE_SMEM_K,
    route,
    route_counters,
    wide_scratch,
)

MAX_K = 128  # csrc/common.cuh ADC_KCAP: the K4/K5 lists' capacity
# the LUT and the lists must fit a block's shared memory (csrc/adcscan.cu,
# csrc/widetopk.cu)
MAX_SMEM = 227 * 1024 - 64
WIDE_STATIC_SMEM = 4096  # csrc/widetopk.cu: the batch's sort arrays


def _smem_bytes(m: int, C: int, k: int, wide: int = MAX_K) -> int:
    """Shared memory a block of the kernel that serves ``k`` needs at the
    least (``wide``: the scan kernel's wide capacity, ``route``'s): the LUT
    and one list (K4 at its capacity, K5 up to 256), or the LUT, the
    batch's arrays and the two list buffers where they fit (the block list
    kernel)."""
    if not route(k, MAX_K, wide).startswith("block_list"):
        return 4 * (m * C + 2 * k)
    return 4 * m * C + WIDE_STATIC_SMEM + (16 * k if k <= WIDE_SMEM_K else 0)


def check_adc_shapes(name: str, codes, point_leaves, lut, query_leaves, k,
                     point_ids=None, wide: int = MAX_K) -> None:
    """Raise unless the shapes and ``k`` are ones the ADC kernels take
    (``wide`` as for :func:`_smem_bytes`)."""
    P, m = codes.shape
    Q, lm, C = lut.shape
    if (lm != m or point_leaves.shape != (P,) or query_leaves.shape != (Q,)
            or (point_ids is not None and point_ids.shape != (P,))):
        raise ValueError(f"{name}: mismatched shapes")
    if m < 1 or C < 1 or Q < 1 or not 1 <= k <= P or P >= 2**31:
        raise ValueError(f"{name}: unsupported {P=} {Q=} {m=} {C=} {k=}")
    if _smem_bytes(m, C, k, wide) > MAX_SMEM:
        raise ValueError(f"{name}: a {m} x {C} LUT does not fit shared memory")


def wide_adc(codes, point_leaves, skip_ids, map_ids, lut, query_leaves, k,
             q_start=None, q_rows=None):
    """Launch the ADC block list kernel (route ``"block_list"``): (dists
    (Q, k), rows or ids (Q, k)).
    Rows whose ``skip_ids`` is < 0 never match; rows leave through
    ``map_ids`` where it is given. Output row q is LUT row
    ``q_start + q`` (``q_rows`` of them) or q."""
    P, m = codes.shape
    n_lut, _, C = lut.shape
    Q = n_lut if q_start is None else q_rows
    out_d = torch.empty((Q, k), dtype=torch.float32, device=codes.device)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=codes.device)
    scratch = wide_scratch(Q, k, codes.device) or (None, None)
    _build.launch(
        "adctopk_wide_launch", codes,
        codes.data_ptr(), point_leaves.data_ptr(), _build.ptr(skip_ids),
        _build.ptr(map_ids), lut.data_ptr(), query_leaves.data_ptr(),
        _build.ptr(q_start), out_d.data_ptr(), out_i.data_ptr(),
        *map(_build.ptr, scratch), P, Q, n_lut, m, C, k)
    return out_d, out_i


def adc_topk(codes: torch.Tensor, point_leaves: torch.Tensor,
             lut: torch.Tensor, query_leaves: torch.Tensor, *, k: int,
             point_ids: torch.Tensor | None = None,
             q_start: torch.Tensor | None = None, q_rows: int | None = None):
    """(dists (Q,k), idx (Q,k)) of same-leaf ADC k-NN; see ref.py.

    ``codes`` (P, m) uint8, ``lut`` (Q, m, C) float32. Rows whose
    ``point_ids`` (P,) int32 is < 0 never match (every row is live without
    them). On the card ``point_leaves`` must be ascending: the kernel
    searches each lookup row's leaf run. With ``q_start``, a
    one-element int64 tensor on the codes' device, and ``q_rows``, the call
    reads only the lookup rows ``q_start .. q_start + q_rows - 1`` of
    ``lut`` and ``query_leaves`` -- a wave's slab, whose start stays on the
    device -- and returns ``(q_rows, k)`` tables; the caller keeps the
    slab inside the table (rows past its end would match nothing).
    """
    if q_start is not None and (q_start.shape != (1,)
                                or q_start.dtype != torch.int64
                                or q_start.device != codes.device
                                or not q_rows or q_rows < 1):
        raise ValueError("adc_topk: q_start must be a (1,) int64 tensor on "
                         "the codes' device, with q_rows >= 1")
    if codes.device.type == "cpu":
        if point_ids is not None:
            point_leaves = torch.where(point_ids >= 0, point_leaves,
                                       PAD_TILE_POINT_LEAF)
        if q_start is not None:
            sel = q_start + torch.arange(q_rows)
            lut, query_leaves = lut.index_select(0, sel), query_leaves.index_select(0, sel)
        return adc_topk_ref(codes, point_leaves, lut, query_leaves, k)
    if codes.device.type != "cuda":
        raise ValueError(f"adc_topk: unsupported device {codes.device}")
    ids = () if point_ids is None else (point_ids,)
    check_kernel_inputs(
        "adc_topk", codes, point_leaves, lut, query_leaves, *ids,
        dtypes=(torch.uint8, torch.int32, torch.float32, torch.int32, torch.int32))
    check_adc_shapes("adc_topk", codes, point_leaves, lut, query_leaves, k,
                     point_ids)
    r = route(k, MAX_K, MAX_K)
    if r.startswith("block_list"):
        out = wide_adc(codes, point_leaves, point_ids, None, lut, query_leaves,
                       k, q_start, q_rows)
    else:
        P, m = codes.shape
        n_lut, _, C = lut.shape
        Q = n_lut if q_start is None else q_rows
        out = (torch.empty((Q, k), dtype=torch.float32, device=codes.device),
               torch.empty((Q, k), dtype=torch.int32, device=codes.device))
        _build.launch(
            "adcscan_launch", codes,
            codes.data_ptr(), point_leaves.data_ptr(), _build.ptr(point_ids),
            lut.data_ptr(), query_leaves.data_ptr(), _build.ptr(q_start),
            out[0].data_ptr(), out[1].data_ptr(), P, Q, n_lut, m, C, k)
    adc_topk.route_launches[r] += 1
    _build.count(adc_topk, codes)
    return out


_build.counters(adc_topk)  # every launch, whatever its route
route_counters(adc_topk)
