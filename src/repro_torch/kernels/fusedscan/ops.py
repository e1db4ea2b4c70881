"""Whole-shard fused scan wrappers: the plain versions for a CPU tensor,
the CUDA kernels for a CUDA tensor -- K2 (``csrc/fusedscan.cu``) for dense
rows, K5 (``csrc/fusedadc.cu``: K4's kernel over the whole shard) for PQ
code rows, each at ``k <= 256`` (their lists' capacity 64 / 128, or 256 in
the wide range past that), and the block list kernel
(``csrc/widetopk.cu``) for a larger ``k``, up to the shard's rows
(``l2topk.ops.route``).

Unlike the per-tile kernel this returns *global descriptor ids* (mapped
through ``point_ids``, -1 where no match or tombstoned), because the whole
shard is scanned in one call.
"""

from __future__ import annotations

import torch

from repro_torch.device import check_kernel_inputs
from repro_torch.kernels import _build
from repro_torch.kernels.adcscan.ops import MAX_K as ADC_MAX_K
from repro_torch.kernels.adcscan.ops import check_adc_shapes, wide_adc
from repro_torch.kernels.fusedscan.ref import fused_adc_topk_ref, fused_topk_ref
from repro_torch.kernels.l2topk.ops import (
    MAX_D,
    WIDE_KCAP,
    route,
    route_counters,
    wide_dense,
)


def fused_topk(points: torch.Tensor, point_leaves: torch.Tensor,
               point_ids: torch.Tensor, queries: torch.Tensor,
               query_leaves: torch.Tensor, *, k: int):
    """(dists (Q,k), ids (Q,k)) whole-shard fused k-NN; see ref.py.

    On the card the point leaves must be sorted ascending (a cluster-sorted
    shard): the kernel searches each leaf group's run. A
    ``DistributedIndex`` is, by construction (``build_index`` sorts,
    ``index_from_numpy`` checks), so nothing is checked here: that would
    cost an O(P) pass and a host round trip on every call.
    """
    if points.device.type == "cpu":
        return fused_topk_ref(points, point_leaves, point_ids, queries,
                              query_leaves, k)
    if points.device.type != "cuda":
        raise ValueError(f"fused_topk: unsupported device {points.device}")
    check_kernel_inputs(
        "fused_topk", points, point_leaves, point_ids, queries, query_leaves,
        dtypes=(torch.float32, torch.int32, torch.int32, torch.float32,
                torch.int32))
    P, d = points.shape
    Q = queries.shape[0]
    if (queries.shape[1] != d or point_leaves.shape != (P,)
            or point_ids.shape != (P,) or query_leaves.shape != (Q,)):
        raise ValueError("fused_topk: mismatched shapes")
    if not 1 <= d <= MAX_D or not 1 <= k <= P or Q < 1 or P >= 2**31:
        raise ValueError(f"fused_topk: unsupported {P=} {Q=} {d=} {k=}")
    r = route(k)
    if r.startswith("block_list"):
        out = wide_dense(points, point_leaves, point_ids, queries,
                         query_leaves, k)
    else:
        out = (torch.empty((Q, k), dtype=torch.float32, device=points.device),
               torch.empty((Q, k), dtype=torch.int32, device=points.device))
        # the long tiles' list: a counter (padded to 16 bytes), 4 ints a tile
        scratch = torch.empty(4 + 4 * Q, dtype=torch.int32, device=points.device)
        _build.launch(
            "fusedscan_launch", points,
            points.data_ptr(), point_leaves.data_ptr(), point_ids.data_ptr(),
            queries.data_ptr(), query_leaves.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), scratch.data_ptr(), P, Q, d, k)
    fused_topk.route_launches[r] += 1
    _build.count(fused_topk, points)
    return out


_build.counters(fused_topk)  # every launch, whatever its route
route_counters(fused_topk)


def fused_adc_topk(codes: torch.Tensor, point_leaves: torch.Tensor,
                   point_ids: torch.Tensor, lut: torch.Tensor,
                   query_leaves: torch.Tensor, *, k: int):
    """(dists (Q,k), ids (Q,k)) whole-shard fused ADC k-NN; see ref.py.

    ``codes`` (P, m) uint8 and ``lut`` (Q, m, C) float32. Rows with id < 0
    (tombstones) never match. On the card the point leaves must be sorted
    ascending, as for :func:`fused_topk`: the K5 kernel (K4's) searches
    each lookup row's leaf run, and skips the tombstones inside it, which
    keep their leaf so that the order holds.
    """
    if codes.device.type == "cpu":
        return fused_adc_topk_ref(codes, point_leaves, point_ids, lut,
                                  query_leaves, k)
    if codes.device.type != "cuda":
        raise ValueError(f"fused_adc_topk: unsupported device {codes.device}")
    check_kernel_inputs(
        "fused_adc_topk", codes, point_leaves, point_ids, lut, query_leaves,
        dtypes=(torch.uint8, torch.int32, torch.int32, torch.float32,
                torch.int32))
    check_adc_shapes("fused_adc_topk", codes, point_leaves, lut, query_leaves,
                     k, point_ids, wide=WIDE_KCAP)
    r = route(k, ADC_MAX_K)
    if r.startswith("block_list"):
        out = wide_adc(codes, point_leaves, point_ids, point_ids, lut,
                       query_leaves, k)
    else:
        P, m = codes.shape
        Q, _, C = lut.shape
        out = (torch.empty((Q, k), dtype=torch.float32, device=codes.device),
               torch.empty((Q, k), dtype=torch.int32, device=codes.device))
        _build.launch(
            "fusedadc_launch", codes,
            codes.data_ptr(), point_leaves.data_ptr(), point_ids.data_ptr(),
            lut.data_ptr(), query_leaves.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), P, Q, m, C, k)
    fused_adc_topk.route_launches[r] += 1
    _build.count(fused_adc_topk, codes)
    return out


_build.counters(fused_adc_topk)  # every launch, whatever its route
route_counters(fused_adc_topk)
