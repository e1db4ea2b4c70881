"""Plain PyTorch version of the fused ADC (asymmetric-distance) code scan.

Semantics (shared by the kernel and this version):

  given uint8 codes (P, m) with leaf ids (P,), and per-query distance
  lookup tables lut (Q, m, C) f32 with query leaf ids (Q,), return for
  every query the k approximately-nearest code rows *within the same
  leaf* under the asymmetric distance

      d2[q, p] = sum_j lut[q, j, codes[p, j]]

  added in fp32 in the order j = 0..m-1, starting from 0
  (``lut[q, j, c] = ||q_j - codebook[j, c]||^2``, so d2 is a full squared
  distance estimate -- there is no deferred ``||q||^2`` term):
    dists (Q, k) fp32  -- ascending ADC squared distance, +inf no match
    idx   (Q, k) int32 -- row index into the code tile, -1 where no match

Ordering contract: ascending by (distance, row), ties to the lower row.
The sums are gathers and adds only, so the kernel equals this version bit
for bit on any LUT.
"""

from __future__ import annotations

import torch

from repro_torch.core.distance import topk_lex


def adc_topk_ref(codes, point_leaves, lut, query_leaves, k: int):
    c = codes.long()
    d2 = torch.zeros((lut.shape[0], c.shape[0]), dtype=torch.float32,
                     device=lut.device)
    for j in range(c.shape[1]):
        d2 = d2 + lut[:, j, :].float()[:, c[:, j]]  # (Q, P)
    match = query_leaves[:, None] == point_leaves[None, :]
    d2 = torch.where(match, d2, torch.inf)
    dists, sel = topk_lex(d2, k)  # (Q, k) over code rows
    idx = torch.where(torch.isfinite(dists), sel, -1).to(torch.int32)
    return dists, idx
