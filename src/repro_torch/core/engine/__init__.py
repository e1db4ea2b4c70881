"""Search engine: plans, the cost models, the shared tile-scan core, and
the executors."""

from repro_torch.core.engine.costmodel import (  # noqa: F401
    FIT_FORM,
    LAYOUTS,
    MODEL_KINDS,
    CalibrationStore,
    CostModel,
    FittedModel,
    HeuristicModel,
    ModelChain,
    ObservedModel,
    PlanShapes,
    backend_name,
    default_calibration,
    fitted_component,
    observations,
    plan_signature,
    record_observation,
    reset_default_calibration,
    reset_observations,
    resolve_model,
    scale_slab_budget,
    shard_slab_scales,
)
from repro_torch.core.engine.executors import (  # noqa: F401
    SearchResult,
    make_executor,
    pad_lookup,
)
from repro_torch.core.engine.plan import (  # noqa: F401
    IMPLS,
    SearchPlan,
    bucket_ladder,
    default_rerank,
    largest_divisor_leq,
    plan,
    snap_to_bucket,
)
