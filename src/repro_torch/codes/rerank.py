"""Exact rerank over codes-scan survivors.

The ADC scan returns approximate per-query candidate ids; this stage
fetches the survivors' raw rows (one batched ``read_rows`` call) and
re-scores them with exact squared L2, so the final (ids, dists) ordering
is exact over the candidate set: ascending (distance, id), fp32 sums of
squared differences. It runs in torch on the candidates' device: at a
whole batch's size the fetched rows are gigabytes, and the index they
come from lives on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.index_build import (
    DistributedIndex,
    MeshIndex,
    index_ids,
    index_rows,
)
from repro_torch.core.sentinels import INVALID_ID

#: query rows per chunk of the distance pass: bounds the (rows, R, d)
#: gathered block to 2^10 x 128 x 128 x 4 B = 64 MiB at the main path's R, d
RERANK_CHUNK = 1 << 10


class IndexRowReader:
    """``read_rows`` over a :class:`DistributedIndex` or a
    :class:`MeshIndex`: descriptor ids -> their rows, by an id -> row map
    built once on the index's (first) device (ids are unique; padding and
    tombstones carry id -1 and are not in it). A MeshIndex's shards each
    send the rows asked of them to the first device.
    """

    def __init__(self, index: DistributedIndex | MeshIndex):
        ids = index_ids(index).long()
        live = torch.nonzero(ids >= 0)[:, 0]
        n = int(ids.max()) + 1 if live.numel() else 0
        self.index = index
        # one spare slot at the end, where every id outside [0, n) looks
        self.row_of = torch.full((n + 1,), -1, dtype=torch.long,
                                 device=ids.device)
        self.row_of[ids[live]] = live

    def __call__(self, ids: torch.Tensor) -> torch.Tensor:
        """``(n,)`` ids -> ``(n, d)`` rows.

        Raises:
          IndexError: an id is negative or not in the index.
        """
        ids = ids.to(self.row_of.device).long()
        n = self.row_of.shape[0] - 1
        rows = self.row_of[torch.where((ids >= 0) & (ids < n), ids, n)]
        if bool((rows < 0).any()):
            raise IndexError("read_rows: an id is not in the index")
        return index_rows(self.index, rows)


def rerank_exact(read_rows, queries, cand_ids, k: int):
    """Exact-L2 rerank of per-query candidate ids.

    Args:
      read_rows: ``ids (n,) -> rows (n, dim)`` raw-row fetch, called once
        with the sorted union of all surviving ids (an
        :class:`IndexRowReader`).
      queries: ``(Q, dim)`` original full-precision queries.
      cand_ids: ``(Q, R)`` candidate ids from the codes scan,
        ``INVALID_ID`` (-1) where a slot is empty. Per-row duplicates are
        dropped (keeps the rerank well-defined under any upstream merge).
      k: neighbours to keep per query.

    Returns:
      ``(ids (Q, k) int32, dists (Q, k) float32)`` on ``cand_ids``'
      device -- exact squared L2, ascending, ties broken by ascending id;
      ``-1``/``inf`` padding where fewer than ``k`` valid candidates
      survived.
    """
    cand = torch.as_tensor(cand_ids).long()
    if cand.ndim != 2:
        raise ValueError(f"cand_ids must be (Q, R), got {tuple(cand.shape)}")
    dev = cand.device
    q = torch.as_tensor(queries, device=dev).float()
    # canonical per-row order: ascending id (so distance ties break by id),
    # duplicates masked out
    cand = torch.sort(cand, dim=1).values
    dup = torch.zeros_like(cand, dtype=torch.bool)
    dup[:, 1:] = cand[:, 1:] == cand[:, :-1]
    valid = (cand >= 0) & ~dup
    uniq = torch.unique(cand[valid])  # sorted
    d = torch.full(cand.shape, torch.inf, dtype=torch.float32, device=dev)
    if uniq.numel():
        vecs = torch.as_tensor(read_rows(uniq), device=dev).float()
        pos = torch.searchsorted(uniq, torch.where(valid, cand, uniq[0]))
        for s in range(0, cand.shape[0], RERANK_CHUNK):
            e = s + RERANK_CHUNK
            diff = vecs[pos[s:e]] - q[s:e, None, :]
            d[s:e] = torch.where(valid[s:e], (diff * diff).sum(-1), torch.inf)
    order = torch.sort(d, dim=1, stable=True).indices[:, :k]
    out_d = torch.gather(d, 1, order)
    out_i = torch.where(torch.isfinite(out_d), torch.gather(cand, 1, order),
                        INVALID_ID).to(torch.int32)
    if out_d.shape[1] < k:
        pad = k - out_d.shape[1]
        out_d = torch.nn.functional.pad(out_d, (0, pad), value=torch.inf)
        out_i = torch.nn.functional.pad(out_i, (0, pad), value=INVALID_ID)
    return out_i, out_d
