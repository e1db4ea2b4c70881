"""Plain PyTorch version of the fused distance + top-k search tile.

Semantics (shared by the kernel and this version):

  given points (P, d) with leaf ids (P,), queries (Q, d) with leaf ids (Q,),
  return for every query the k nearest points *within the same leaf*:
    dists (Q, k) fp32  -- partial squared distance ||p||^2 - 2 p.q
                          (the ||q||^2 term is a per-query constant and is
                          added back by the caller), +inf where no match
    idx   (Q, k) int32 -- row index into the point tile, -1 where no match

Ordering contract: ascending by (distance, row), ties to the lower row.

Float32 products stay in full float32 here: TF32 is switched off for
matmuls and for cuDNN, so this version is a fair oracle for the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.core.distance import topk_lex

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def l2_topk_ref(points, point_leaves, queries, query_leaves, k: int):
    pf = points.float()
    qf = queries.float()
    pn = (pf * pf).sum(-1)
    d2 = pn[:, None] - 2.0 * (pf @ qf.T)
    match = point_leaves[:, None] == query_leaves[None, :]
    d2 = torch.where(match, d2, torch.inf)
    dists, sel = topk_lex(d2.T, k)  # (Q, k) over point rows
    idx = torch.where(torch.isfinite(dists), sel, -1).to(torch.int32)
    return dists, idx
