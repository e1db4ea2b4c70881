"""Padding/sentinel constants shared across the core, kernels, and engine.

The same values as the JAX package's ``core/sentinels.py``, so index and
lookup arrays carried across by :mod:`repro_torch.interop` mean the same
thing on both sides:

  * all real leaf ids are ``>= 0``;
  * every sentinel below is distinct and negative **or** larger than any
    real leaf, so no sentinel ever equals a real leaf and no two different
    kinds of padding ever match each other inside the leaf-equality mask of
    the distance kernels.
"""

from __future__ import annotations

# Invalid/padded rows in the routed exchange. Sorts *after* every real leaf
# so cluster_sort pushes padding to the tail of each shard.
LEAF_SENTINEL = 2**31 - 1

# Padded lookup-table rows (pad_lookup). Negative: never matches a real
# leaf, and distinct from the tile padding below.
PAD_QUERY_LEAF = -2

# Tile padding inside the fusedscan kernel (and masked tombstones):
# point-side and query-side padding use *different* values so padded
# points never match padded queries.
PAD_TILE_POINT_LEAF = -9
PAD_TILE_QUERY_LEAF = -8

# Invalid descriptor/query ids (dropped or padding rows).
INVALID_ID = -1
