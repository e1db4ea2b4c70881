"""Search engine: plans, the shared tile-scan core, and the executors."""

from repro_torch.core.engine.executors import (  # noqa: F401
    SearchResult,
    make_executor,
    pad_lookup,
)
from repro_torch.core.engine.plan import IMPLS, SearchPlan, plan  # noqa: F401
