"""Plain PyTorch version of the segment sum over a CSR of edges.

Given h (n_src, d), a row pointer ``indptr`` (n_rows + 1,) and the sorted
edges' ``cols`` (E,) and weights ``w`` (E,), return

  out (n_rows, d) float32 -- out[r] = sum over e in [indptr[r], indptr[r+1])
                             of w[e] * h[cols[e]]

each product rounded, then added from 0 in edge order by ``index_add_``
(on the CPU one after another, so in that order; on the card with atomics,
in no fixed order). The edges go through in chunks of at most
``CHUNK_FLOATS / d`` rows, so the gathered messages never exceed about
1 GiB; the adds keep their order across chunks.
"""

from __future__ import annotations

import torch

CHUNK_FLOATS = 2**28


def segsum_ref(h: torch.Tensor, indptr: torch.Tensor, cols: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    n_rows = indptr.shape[0] - 1
    d = h.shape[1]
    out = torch.zeros((n_rows, d), dtype=h.dtype, device=h.device)
    counts = (indptr[1:] - indptr[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(n_rows, device=h.device), counts)
    step = max(1, CHUNK_FLOATS // max(1, d))
    for s in range(0, cols.shape[0], step):
        e = s + step
        msg = h.index_select(0, cols[s:e].long()) * w[s:e, None].to(h.dtype)
        out.index_add_(0, rows[s:e], msg)
    return out
