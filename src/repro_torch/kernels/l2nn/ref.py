"""Plain PyTorch version of fused L2 nearest-centroid assignment.

Given x (N, d) and centroids (C, d), return
  idx  (N,) int32   -- argmin_c ||x - c||^2 (first index on ties)
  dist (N,) float32 -- the true squared distance at the argmin

Float32 products stay in full float32 here: TF32 is switched off for
matmuls and for cuDNN, so this version is a fair oracle for the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.core.distance import nearest

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def l2_nearest_ref(x: torch.Tensor, centroids: torch.Tensor):
    idx, dist = nearest(x, centroids)
    return idx.to(torch.int32), dist.float()
