"""Nearest-centroid wrapper: the plain version for a CPU tensor, the K3
CUDA kernel (``csrc/l2nn.cu``) for a CUDA tensor."""

from __future__ import annotations

import torch

from repro_torch.device import check_kernel_inputs
from repro_torch.kernels import _build
from repro_torch.kernels.l2nn.ref import l2_nearest_ref

MAX_D = 256  # csrc/common.cuh MAX_D


def l2_nearest(x: torch.Tensor, centroids: torch.Tensor):
    """(idx (N,) int32, dist (N,) f32) nearest centroid per row; see ref.py."""
    if x.device.type == "cpu":
        return l2_nearest_ref(x, centroids)
    if x.device.type != "cuda":
        raise ValueError(f"l2_nearest: unsupported device {x.device}")
    check_kernel_inputs("l2_nearest", x, centroids,
                        dtypes=(torch.float32, torch.float32))
    n, d = x.shape
    c = centroids.shape[0]
    if centroids.shape[1] != d or not 1 <= d <= MAX_D or c < 1:
        raise ValueError(f"l2_nearest: shapes {tuple(x.shape)} {tuple(centroids.shape)}")
    out_i = torch.empty((n,), dtype=torch.int32, device=x.device)
    out_d = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return out_i, out_d
    _build.launch("l2nn_launch", x,
                  x.data_ptr(), centroids.data_ptr(), out_i.data_ptr(),
                  out_d.data_ptr(), n, c, d)
    _build.count(l2_nearest, x)
    return out_i, out_d


_build.counters(l2_nearest)
