"""Same-leaf distance + top-k tile wrapper: the plain version for a CPU
tensor, the K1 CUDA kernel (``csrc/l2topk.cu``) for a CUDA tensor at
``k <= 64``, the wide kernel (``csrc/widetopk.cu``) past that, up to the
wave's rows (the reference serves any ``k <= block_rows``).

On the card the point leaves must be ascending, as every wave of a
leaf-sorted ``DistributedIndex`` is (``index_from_numpy`` checks arrays
from outside; ``LEAF_SENTINEL`` padding sorts last): the kernel searches
each lookup row's leaf run and scans only that run. Query leaves may come
in any order. Nothing is checked per call (that would cost an O(P) pass).
The sentinels keep their meaning: a padded lookup row's ``PAD_QUERY_LEAF``
and a point's ``LEAF_SENTINEL`` never equal a real leaf.

The query-routed executor scans a tile's point slab in place: given
``p_start`` (a one-element int64 tensor on the points' device) and
``p_rows``, the call reads only the point rows ``p_start .. p_start +
p_rows - 1`` and reports rows relative to ``p_start`` -- the copying
form's answer, with neither a copy nor a host sync for the start.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.device import check_kernel_inputs
from repro_torch.kernels import _build
from repro_torch.kernels.l2topk.ref import l2_topk_ref

MAX_D = 256
MAX_K = 64  # csrc/common.cuh DENSE_KCAP: the K1/K2 lists' capacity
WIDE_SMEM_K = 4096  # csrc/widetopk.cu W_SMEM_K: past it the lists need scratch


def wide_scratch(rows: int, k: int, device) -> tuple:
    """The wide kernels' (rows, k) scratch lists, or None where the lists
    fit shared memory. Freeing them after the launch is safe: the caching
    allocator hands their memory only to later work on the same stream."""
    if k <= WIDE_SMEM_K:
        return None
    return (torch.empty((rows, k), dtype=torch.float32, device=device),
            torch.empty((rows, k), dtype=torch.int32, device=device))


def wide_dense(points, point_leaves, map_ids, queries, query_leaves, k,
               p_start=None, p_rows=None):
    """Launch the dense wide kernel: (dists (Q, k), rows or ids (Q, k)),
    rows mapped through ``map_ids`` where it is given (K2's rule); with
    ``p_start``, over the ``p_rows`` point rows from there."""
    P, d = points.shape
    if p_start is not None:
        P = p_rows
    Q = queries.shape[0]
    out_d = torch.empty((Q, k), dtype=torch.float32, device=points.device)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=points.device)
    scratch = wide_scratch(Q, k, points.device) or (None, None)
    err = _build.lib().l2topk_wide_launch(
        points.data_ptr(), point_leaves.data_ptr(), _build.ptr(map_ids),
        queries.data_ptr(), query_leaves.data_ptr(), _build.ptr(p_start),
        out_d.data_ptr(), out_i.data_ptr(), *map(_build.ptr, scratch), P, Q,
        d, k, _build.stream_ptr(points))
    _build.check(err, "l2topk_wide_launch")
    return out_d, out_i


def l2_topk(points: torch.Tensor, point_leaves: torch.Tensor,
            queries: torch.Tensor, query_leaves: torch.Tensor, *, k: int,
            p_start: torch.Tensor | None = None, p_rows: int | None = None):
    """(dists (Q,k), idx (Q,k)) of same-leaf k-NN; see ref.py.

    With ``p_start`` (a (1,) int64 tensor on the points' device) and
    ``p_rows``, the points are the slab ``points[p_start:p_start +
    p_rows]`` (and its leaves), read in place; the caller keeps the slab
    inside the arrays. ``idx`` counts rows from the slab's start."""
    if p_start is not None:
        if (p_start.shape != (1,) or p_start.dtype != torch.int64
                or p_start.device != points.device or not p_rows
                or not 1 <= p_rows <= points.shape[0]):
            raise ValueError("l2_topk: p_start must be a (1,) int64 tensor on "
                             "the points' device, with 1 <= p_rows <= rows")
        if points.device.type == "cpu":
            sel = p_start + torch.arange(p_rows)
            points = points.index_select(0, sel)
            point_leaves = point_leaves.index_select(0, sel)
            p_start = None
    if points.device.type == "cpu":
        return l2_topk_ref(points, point_leaves, queries, query_leaves, k)
    if points.device.type != "cuda":
        raise ValueError(f"l2_topk: unsupported device {points.device}")
    check_kernel_inputs(
        "l2_topk", points, point_leaves, queries, query_leaves,
        dtypes=(torch.float32, torch.int32, torch.float32, torch.int32))
    P, d = points.shape
    Q = queries.shape[0]
    if (queries.shape[1] != d or point_leaves.shape != (P,)
            or query_leaves.shape != (Q,)):
        raise ValueError("l2_topk: mismatched shapes")
    if p_start is not None:
        P = p_rows
    if not 1 <= d <= MAX_D or not 1 <= k <= P or Q < 1:
        raise ValueError(f"l2_topk: unsupported {P=} {Q=} {d=} {k=}")
    if k > MAX_K:
        out = wide_dense(points, point_leaves, None, queries, query_leaves, k,
                         p_start, p_rows)
        l2_topk.wide_launches += 1
    else:
        out = (torch.empty((Q, k), dtype=torch.float32, device=points.device),
               torch.empty((Q, k), dtype=torch.int32, device=points.device))
        err = _build.lib().l2topk_launch(
            points.data_ptr(), point_leaves.data_ptr(), queries.data_ptr(),
            query_leaves.data_ptr(), _build.ptr(p_start), out[0].data_ptr(),
            out[1].data_ptr(), P, Q, d, k, _build.stream_ptr(points))
        _build.check(err, "l2topk_launch")
    l2_topk.launches += 1
    return out


l2_topk.launches = 0  # every launch: K1's and the wide kernel's
l2_topk.wide_launches = 0  # the wide kernel's (k > MAX_K)


def resident_clusters() -> int:
    """The thread block clusters (4 blocks, one an SM) the card holds at
    once, which K1's grid launches: ``cudaOccupancyMaxActiveClusters``,
    read once on the current device."""
    n = ctypes.c_int(0)
    _build.check(_build.lib().l2topk_clusters(ctypes.addressof(n)),
                 "l2topk_clusters")
    return n.value
