"""Serving metrics: latency percentiles, throughput, queue/cache counters.

The paper's Exp #5 reports one number (ms/image at a fixed batch size); an
online service needs the full latency distribution (p50/p95/p99 — queueing
delay included), the throughput it was achieved at, and the health counters
that explain it (queue depth, recompiles, cache hit rate, rejects). Since
nearly all tail latency in a loaded service is *queueing*, every completion
also splits into wait-ms (arrival -> dispatch) vs compute-ms (the engine /
cache work itself), and everything is kept per priority class so SLO
attainment can be reported per tenant. All accounting is plain
Python/numpy — nothing here touches a device.

Every :class:`ServingMetrics` also registers itself as a *source* in the
process-wide :class:`~repro_torch.obs.registry.MetricsRegistry` (held weakly —
a dead session's series vanish), so one registry dump carries the serving
counters next to the cache/index/calibration ones under the unified
naming scheme. ``to_dict()`` keeps its historical
shape byte-for-byte: the registry view is additive, never a rewrite.

Memory: collectors are *exact* by default (every sample kept — the
historical behavior, and what the percentile-asserting tests pin).
For long replays pass ``max_samples=N``: percentiles cut over to a
deterministic reservoir (Algorithm R, seeded) of N samples while count /
mean / max / histogram buckets stay exact — O(N) memory however many
requests complete.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.obs import get_registry

# histogram bucket upper bounds for exported latency distributions (ms)
HIST_BOUNDS_MS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
                  1000.0, 2000.0, 5000.0)


class LatencyStats:
    """Streaming latency collector.

    Args:
      max_samples: ``None`` (default) keeps every sample — report-time
        percentiles are exact. With ``max_samples=N``, a deterministic
        reservoir (Algorithm R under ``seed``) bounds memory at N
        samples; percentiles become reservoir estimates while ``count``,
        ``mean_ms``, ``max_ms``, and :meth:`histogram` buckets stay
        exact.
      seed: reservoir rng seed (same seed + same add sequence = same
        reservoir, so bounded replays stay reproducible).

    Raises:
      ValueError: a non-positive ``max_samples``.
    """

    def __init__(self, max_samples: int | None = None, *, seed: int = 0):
        if max_samples is not None and max_samples < 1:
            raise ValueError(f"max_samples={max_samples} must be >= 1")
        self._ms: list[float] = []
        self.max_samples = max_samples
        self._rng = (np.random.default_rng(seed)
                     if max_samples is not None else None)
        # exact running stats (bounded mode keeps these exact even when
        # the sample reservoir is lossy)
        self._count = 0
        self._total = 0.0
        self._max = float("-inf")
        self._hist = [0] * (len(HIST_BOUNDS_MS) + 1)  # + overflow bucket

    def add(self, ms: float) -> None:
        ms = float(ms)
        self._count += 1
        self._total += ms
        self._max = max(self._max, ms)
        i = 0
        for b in HIST_BOUNDS_MS:
            if ms <= b:
                break
            i += 1
        self._hist[i] += 1
        if self.max_samples is None or len(self._ms) < self.max_samples:
            self._ms.append(ms)
        else:
            # Algorithm R: keep each of the n samples seen so far with
            # probability max_samples/n
            j = int(self._rng.integers(0, self._count))
            if j < self.max_samples:
                self._ms[j] = ms

    def __len__(self) -> int:
        """Samples *observed* (not retained — bounded mode retains
        ``max_samples``)."""
        return self._count

    def percentile(self, p: float) -> float:
        if not self._ms:
            return float("nan")
        return float(np.percentile(np.asarray(self._ms), p))

    def histogram(self) -> dict:
        """Exact fixed-bucket counts for export (registry / artifacts):
        ``{"bounds_ms": [...], "counts": [...]}`` where ``counts`` has
        one overflow bucket past the last bound. Exact in both modes —
        this is the bounded-memory distribution long replays export."""
        return {"bounds_ms": list(HIST_BOUNDS_MS),
                "counts": list(self._hist)}

    def summary(self) -> dict:
        if not self._count:
            return {"count": 0}
        a = np.asarray(self._ms)
        return {
            "count": self._count,
            "mean_ms": self._total / self._count,
            "p50_ms": float(np.percentile(a, 50)),
            "p95_ms": float(np.percentile(a, 95)),
            "p99_ms": float(np.percentile(a, 99)),
            "max_ms": self._max,
        }


@dataclasses.dataclass
class ClassMetrics:
    """Per-priority-class accounting: the SLO view of one tenant class."""

    latency: LatencyStats = dataclasses.field(default_factory=LatencyStats)
    wait: LatencyStats = dataclasses.field(default_factory=LatencyStats)
    compute: LatencyStats = dataclasses.field(default_factory=LatencyStats)
    completed: int = 0
    attained: int = 0  # completions within the class deadline
    shed: int = 0  # admission-control drops
    rejected: int = 0  # hard max_queue drops
    deadline_ms: float | None = None

    @classmethod
    def make(cls, max_samples: int | None = None) -> "ClassMetrics":
        """A ClassMetrics whose collectors share the owner's bound."""
        return cls(latency=LatencyStats(max_samples),
                   wait=LatencyStats(max_samples),
                   compute=LatencyStats(max_samples))

    @property
    def slo_attainment(self) -> float:
        """Fraction of *offered* requests that completed within the class
        deadline — shed and rejected requests count as misses (1.0 for an
        idle class: no offered request missed)."""
        offered = self.completed + self.shed + self.rejected
        if not offered:
            return 1.0
        return self.attained / offered

    def to_dict(self) -> dict:
        return {
            "completed": self.completed,
            "shed": self.shed,
            "rejected": self.rejected,
            "attained": self.attained,
            "slo_attainment": self.slo_attainment,
            "deadline_ms": self.deadline_ms,
            "latency": self.latency.summary(),
            "wait": self.wait.summary(),
            "compute": self.compute.summary(),
        }


@dataclasses.dataclass
class ServingMetrics:
    """Counters + distributions for one serving session/replay.

    ``max_samples`` bounds every latency collector and the queue-depth
    sample list for long replays (exact when ``None``, the default — see
    :class:`LatencyStats`).
    """

    latency: LatencyStats = dataclasses.field(default_factory=LatencyStats)
    wait: LatencyStats = dataclasses.field(default_factory=LatencyStats)
    compute: LatencyStats = dataclasses.field(default_factory=LatencyStats)
    requests: int = 0  # completed requests (images)
    rejected: int = 0  # backpressure rejects (hard max_queue cap)
    shed: int = 0  # admission-control drops (batch-class overload)
    downgraded: int = 0  # batch requests deadline-downgraded at admission
    query_rows: int = 0  # query descriptor rows served via the engine
    engine_batches: int = 0  # micro-batches dispatched to the engine
    engine_ms: float = 0.0  # wall-clock busy time inside the engine
    engine_images: int = 0  # images served by engine micro-batches
    cache_images: int = 0  # images served from the hot-leaf cache
    q_cap_overflow: int = 0  # slab-budget misses (counted, never silent)
    warmup_ms: float = 0.0
    recompiles_after_warmup: int = 0  # steady-state recompiles (want: 0)
    queue_depth: list = dataclasses.field(default_factory=list)  # samples
    per_class: dict = dataclasses.field(default_factory=dict)
    max_samples: int | None = None  # bound per-collector memory (None=exact)

    def __post_init__(self):
        if self.max_samples is not None:
            self.latency = LatencyStats(self.max_samples)
            self.wait = LatencyStats(self.max_samples)
            self.compute = LatencyStats(self.max_samples)
            self._qd_rng = np.random.default_rng(1)
        self._qd_seen = len(self.queue_depth)
        # unified-registry source: held weakly, so a dropped session's
        # series disappear from later snapshots instead of leaking
        get_registry().register_source(
            f"serving_metrics@{id(self):x}", self,
            ServingMetrics.registry_series,
        )

    def observe_queue_depth(self, depth: int) -> None:
        self._qd_seen += 1
        if (self.max_samples is None
                or len(self.queue_depth) < self.max_samples):
            self.queue_depth.append(int(depth))
        else:
            j = int(self._qd_rng.integers(0, self._qd_seen))
            if j < self.max_samples:
                self.queue_depth[j] = int(depth)

    def _class(self, priority: str) -> ClassMetrics:
        cm = self.per_class.get(priority)
        if cm is None:
            cm = self.per_class[priority] = ClassMetrics.make(
                self.max_samples
            )
        return cm

    def observe_latency(self, priority: str, *, wait_ms: float,
                        compute_ms: float,
                        deadline_ms: float | None = None) -> None:
        """Record one completion's wait/compute split (latency = sum),
        globally and under its priority class; with a ``deadline_ms``,
        also scores the class's SLO attainment."""
        lat = float(wait_ms) + float(compute_ms)
        self.latency.add(lat)
        self.wait.add(wait_ms)
        self.compute.add(compute_ms)
        cm = self._class(priority)
        cm.latency.add(lat)
        cm.wait.add(wait_ms)
        cm.compute.add(compute_ms)
        cm.completed += 1
        if deadline_ms is not None:
            cm.deadline_ms = float(deadline_ms)
            if lat <= deadline_ms:
                cm.attained += 1

    def observe_drop(self, priority: str, kind: str) -> None:
        """Count one dropped request: ``kind`` is ``"shed"`` (admission
        control) or ``"rejected"`` (hard queue cap)."""
        cm = self._class(priority)
        if kind == "shed":
            self.shed += 1
            cm.shed += 1
        elif kind == "rejected":
            self.rejected += 1
            cm.rejected += 1
        else:
            raise ValueError(f"unknown drop kind {kind!r}")

    @property
    def ms_per_image(self) -> float:
        """Engine busy time per engine-served image — the paper's Exp #5
        metric (cache-served images excluded: they cost ~0 engine time)."""
        if not self.engine_images:
            return float("nan")
        return self.engine_ms / self.engine_images

    def queue_summary(self) -> dict:
        """Queue-depth distribution at dispatch time (p50/p95/max/mean).
        ``count`` is depths *observed* (bounded mode retains at most
        ``max_samples`` of them for the percentiles)."""
        if not self.queue_depth:
            return {"count": 0, "mean": 0.0, "p50": 0, "p95": 0, "max": 0}
        qd = np.asarray(self.queue_depth)
        return {
            "count": self._qd_seen,
            "mean": float(qd.mean()),
            "p50": int(np.percentile(qd, 50)),
            "p95": int(np.percentile(qd, 95)),
            "max": int(qd.max()),
        }

    def registry_series(self) -> dict:
        """The unified-registry view: flat ``{series: value}`` under the
        ``serving.*`` namespace (labeled per class), histograms from the
        exact bucket counts. Additive — ``to_dict()`` is unchanged."""
        q = self.queue_summary()
        out = {
            "serving.requests": self.requests,
            "serving.rejected": self.rejected,
            "serving.shed": self.shed,
            "serving.downgraded": self.downgraded,
            "serving.query_rows": self.query_rows,
            "serving.engine.batches": self.engine_batches,
            "serving.engine.ms": self.engine_ms,
            "serving.engine.images": self.engine_images,
            "serving.cache.images": self.cache_images,
            "serving.q_cap_overflow": self.q_cap_overflow,
            "serving.warmup_ms": self.warmup_ms,
            "serving.recompiles_after_warmup": self.recompiles_after_warmup,
            "serving.queue_depth.mean": q["mean"],
            "serving.queue_depth.p95": q["p95"],
            "serving.queue_depth.max": q["max"],
            "serving.latency.hist": self.latency.histogram(),
            "serving.wait.hist": self.wait.histogram(),
            "serving.compute.hist": self.compute.histogram(),
        }
        for name, cm in sorted(self.per_class.items()):
            lbl = f"{{class={name}}}"
            out[f"serving.class.completed{lbl}"] = cm.completed
            out[f"serving.class.shed{lbl}"] = cm.shed
            out[f"serving.class.rejected{lbl}"] = cm.rejected
            out[f"serving.class.attained{lbl}"] = cm.attained
            out[f"serving.class.latency.hist{lbl}"] = cm.latency.histogram()
        return out

    def to_dict(self) -> dict:
        q = self.queue_summary()
        return {
            "latency": self.latency.summary(),
            "wait": self.wait.summary(),
            "compute": self.compute.summary(),
            "requests": self.requests,
            "rejected": self.rejected,
            "shed": self.shed,
            "downgraded": self.downgraded,
            "query_rows": self.query_rows,
            "engine_batches": self.engine_batches,
            "engine_ms": self.engine_ms,
            "engine_images": self.engine_images,
            "cache_images": self.cache_images,
            "q_cap_overflow": self.q_cap_overflow,
            "ms_per_image": self.ms_per_image,
            "warmup_ms": self.warmup_ms,
            "recompiles_after_warmup": self.recompiles_after_warmup,
            "queue_depth_mean": q["mean"],
            "queue_depth_max": q["max"],
            "queue_depth_p50": q["p50"],
            "queue_depth_p95": q["p95"],
            "per_class": {
                name: cm.to_dict() for name, cm in sorted(
                    self.per_class.items()
                )
            },
        }
