"""Segment-based index lifecycle: create / open / append / commit / delete /
compact / search, in the JAX package's on-disk format, plus scatter-gather
sharding over segments."""

from repro_torch.index.lifecycle import (  # noqa: F401
    CompactionPolicy,
    Index,
    IndexSnapshot,
    has_index,
    has_legacy_index,
)
from repro_torch.index.manifest import Manifest  # noqa: F401
from repro_torch.index.segment import Segment  # noqa: F401
from repro_torch.index.sharding import ShardedIndex, ShardPlan  # noqa: F401
