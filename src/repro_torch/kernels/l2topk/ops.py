"""Same-leaf distance + top-k tile wrapper: the plain version for a CPU
tensor, the K1 CUDA kernel (``csrc/l2topk.cu``) for a CUDA tensor.

The kernel handles ragged tiles itself: point rows past ``P`` carry
``PAD_TILE_POINT_LEAF`` and query rows past ``Q`` carry
``PAD_TILE_QUERY_LEAF`` inside the kernel, so padding never matches a real
leaf, a padded lookup row, or other padding -- and no padded copy of the
inputs is made.
"""

from __future__ import annotations

import torch

from repro_torch.device import check_kernel_inputs
from repro_torch.kernels import _build
from repro_torch.kernels.l2topk.ref import l2_topk_ref

TILE = 64  # csrc/common.cuh TQ == TP
MAX_D = 256
MAX_K = 64
TARGET_BLOCKS = 2 * 132  # two blocks on each of the H100's SMs


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_layout(P: int, Q: int) -> tuple[int, int]:
    """(n_splits, split_rows): point splits per query tile, so the grid
    fills the card even when a wave has few query tiles."""
    want = max(1, min(_cdiv(P, TILE), _cdiv(TARGET_BLOCKS, _cdiv(Q, TILE))))
    split_rows = _cdiv(_cdiv(P, want), TILE) * TILE
    return _cdiv(P, split_rows), split_rows


def l2_topk(points: torch.Tensor, point_leaves: torch.Tensor,
            queries: torch.Tensor, query_leaves: torch.Tensor, *, k: int):
    """(dists (Q,k), idx (Q,k)) of same-leaf k-NN; see ref.py."""
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
    if not 1 <= d <= MAX_D or not 1 <= k <= min(MAX_K, P) or Q < 1:
        raise ValueError(f"l2_topk: unsupported {P=} {Q=} {d=} {k=}")
    n_splits, split_rows = split_layout(P, Q)
    dev = points.device
    part_d = torch.empty((Q, n_splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((Q, n_splits, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    err = _build.lib().l2topk_launch(
        points.data_ptr(), point_leaves.data_ptr(), queries.data_ptr(),
        query_leaves.data_ptr(), part_d.data_ptr(), part_i.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(), P, Q, d, k, n_splits, split_rows,
        _build.stream_ptr(points))
    _build.check(err, "l2topk_launch")
    l2_topk.launches += 1
    return out_d, out_i


l2_topk.launches = 0
