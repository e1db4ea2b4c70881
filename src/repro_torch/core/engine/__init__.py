"""Search engine: plans, the cost models, the shared tile-scan core, and
the executors."""

from repro_torch.core.engine.costmodel import (  # noqa: F401
    CalibrationStore,
    PlanShapes,
    backend_name,
    resolve_model,
)

from repro_torch.core.engine.executors import (  # noqa: F401
    SearchResult,
    make_executor,
    pad_lookup,
)
from repro_torch.core.engine.plan import IMPLS, SearchPlan, plan  # noqa: F401
