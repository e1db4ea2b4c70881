"""Plain PyTorch version of the whole-shard fused scan + k-selection.

Semantics (shared by the kernel and this version):

  given a shard's cluster-sorted points (P, d) with leaf ids (P,) and
  global descriptor ids (P,), and a probe-expanded lookup table
  queries (Q, d) with leaf ids (Q,), return for every lookup row the k
  nearest same-leaf points across the *whole shard* in one pass:
    dists (Q, k) fp32  -- partial squared distance ||p||^2 - 2 p.q, +inf
                          where no match
    ids   (Q, k) int32 -- global descriptor ids, -1 where no match (or
                          where the row is tombstoned: id < 0)

Selection contract: the k smallest by ``(distance, shard row)``, which is
what the wave-folded executor produces, so the fused path equals it.
``fused_adc_topk_ref`` is the same scan over PQ codes under the asymmetric
distance (``kernels/adcscan/ref.py``).

This version forms the full (P, Q) matrix, so it is for small inputs.
At a whole shard's size the kernel is held against it on sampled lookup
rows, the shard scanned in point chunks (``chip_smoke.py``): each output
row depends on its own lookup row only. TF32 is off (see l2topk/ref.py).
"""

from __future__ import annotations

import torch

from repro_torch.core.sentinels import INVALID_ID, PAD_TILE_POINT_LEAF
from repro_torch.kernels.adcscan.ref import adc_topk_ref
from repro_torch.kernels.l2topk.ref import l2_topk_ref


def map_ids(dists, sel, point_ids):
    """Tile rows -> global ids; -1/inf where no match or tombstoned."""
    ids = torch.where(sel >= 0, point_ids[sel.clamp(min=0).long()],
                      INVALID_ID).to(torch.int32)
    return torch.where(ids >= 0, dists, torch.inf), ids


def fused_topk_ref(points, point_leaves, point_ids, queries, query_leaves,
                   k: int):
    dists, sel = l2_topk_ref(points, point_leaves, queries, query_leaves, k)
    return map_ids(dists, sel, point_ids)


def fused_adc_topk_ref(codes, point_leaves, point_ids, lut, query_leaves,
                       k: int):
    """ADC variant over PQ code rows (``lut`` is (Q, m, C) f32); distances
    are *full* squared estimates -- no deferred ``||q||^2`` term.

    Tombstoned rows (id < 0) never match: their leaves are masked to
    ``PAD_TILE_POINT_LEAF`` here, as the JAX package's executor masks them
    before its fused ADC call. The kernel takes the unmasked (sorted)
    leaves and skips those rows itself.
    """
    live = torch.where(point_ids >= 0, point_leaves, PAD_TILE_POINT_LEAF)
    dists, sel = adc_topk_ref(codes, live, lut, query_leaves, k)
    return map_ids(dists, sel, point_ids)
