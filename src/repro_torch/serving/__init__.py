"""Online search serving: the batch search as a service, on one device.

``SearchSession`` (bucketed pipelines built once, hot-leaf cache,
metrics, calibration recording), ``ShardedSearchSession`` (scatter-gather
over a ``repro_torch.index.ShardPlan``: the same surface, bit-identical
results), ``MicroBatcher`` (deadline-aware EDF or arrival-order FIFO
coalescing with backpressure and fitted-cost admission control),
``SLOPolicy`` + ``tune_ladder`` (per-class deadlines, shedding depth and
bucket-ladder tuning for a target p95), ``TraceLoadGenerator``
(uniform/Zipf replayable workloads and multi-tenant bursty class mixes via
``TenantClass``), and ``persist`` (corpus store helpers + deprecated index
shims). The JAX package's serving layer, with the same public names.
"""

from repro_torch.serving.batching import Completion, MicroBatcher  # noqa: F401
from repro_torch.serving.cache import HotLeafCache  # noqa: F401
from repro_torch.serving.metrics import LatencyStats, ServingMetrics  # noqa: F401
from repro_torch.serving.session import SearchSession  # noqa: F401
from repro_torch.serving.sharded import ShardedSearchSession  # noqa: F401
from repro_torch.serving.slo import (  # noqa: F401
    LadderDecision,
    SLOPolicy,
    tune_ladder,
)
from repro_torch.serving.trace import (  # noqa: F401
    Request,
    TenantClass,
    TraceLoadGenerator,
    default_tenant_mix,
)
