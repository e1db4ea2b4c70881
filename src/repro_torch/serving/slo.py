"""SLO-grade scheduling policy: priority classes, deadlines, admission
control, and the closed-loop ladder tuner.

The paper's headline number (~210 ms/image over 100M images, Exp #5) is a
*sustained* figure — the system holds it under continuous load. Under load
a service's tail is queueing, not the engine's per-image cost, so this
module attacks the queue with policy rather than kernels (the JAX
package's policy, unchanged):

  * **priority classes** — every :class:`~repro_torch.serving.trace.Request`
    carries one of :data:`PRIORITY_CLASSES` (``interactive`` > ``standard``
    > ``batch``); the micro-batcher dispatches earliest-deadline-first
    within class, higher classes first;
  * **deadline budgets** — each class owns a latency deadline (SLO) and a
    coalescing budget (how long the batcher may hold a request to fill a
    bucket); both live in :class:`SLOPolicy`;
  * **admission control** — when queue depth crosses a fitted-cost-derived
    threshold (the depth at which queued work alone exceeds the ``batch``
    deadline), incoming ``batch`` requests are shed (or deadline-downgraded)
    instead of poisoning every class's tail;
  * **ladder tuning** — :func:`tune_ladder` uses the fitted
    :class:`~repro_torch.core.engine.costmodel.CostModel` to pick the bucket
    ladder whose largest dispatch still fits a target p95
    (``repro_torch.launch.serve --target-p95-ms``).

Scheduling only ever changes *when* a request runs, never *what* it
returns: per-request results are independent of batch composition (the
lookup routes each query row independently), so ``fifo`` and ``edf``
replays of the same trace return bit-identical ids + distances (the tests
and ``chip_smoke.py``'s serving phase hold it).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

#: scheduling classes, highest priority first
PRIORITY_CLASSES = ("interactive", "standard", "batch")

_CLASS_RANK = {name: i for i, name in enumerate(PRIORITY_CLASSES)}

#: per-class completion deadline (the SLO attainment is reported against)
DEFAULT_DEADLINES_MS = {
    "interactive": 50.0,
    "standard": 250.0,
    "batch": 2000.0,
}

#: fraction of a target p95 the tuner budgets for the dispatch itself
#: (the rest absorbs queueing + coalescing wait)
DISPATCH_FRACTION = 0.5


def class_rank(priority: str) -> int:
    """Scheduling rank of a priority class (0 = most urgent).

    Raises:
      ValueError: an unknown class name.
    """
    try:
        return _CLASS_RANK[priority]
    except KeyError:
        raise ValueError(
            f"unknown priority class {priority!r}; "
            f"want one of {PRIORITY_CLASSES}"
        ) from None


def _default_max_waits(base_ms: float) -> dict[str, float]:
    """Per-class coalescing budgets from one base figure: interactive
    requests coalesce briefly (latency is the product), batch requests
    coalesce long (amortisation is the product)."""
    base = float(base_ms)
    return {
        "interactive": max(0.5, base / 4.0),
        "standard": base,
        "batch": base * 10.0,
    }


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """The scheduling contract the micro-batcher enforces.

    Args:
      deadlines_ms: per-class completion deadline (arrival -> finish).
        EDF orders within a class by ``arrival + deadline``.
      max_wait_ms: per-class coalescing budget — how long the batcher may
        hold the head request waiting for more rows.
      shed_depth: queue depth (pending requests) at which admission
        control engages for ``batch`` work; ``None`` disables shedding
        (the only cap left is the hard ``max_queue``).
      on_overload: ``"shed"`` drops incoming batch requests outright
        (completion ``source="shed"``); ``"downgrade"`` keeps them but
        pushes their deadline out by one full batch budget, so they yield
        to everything else instead of being dropped.
    """

    deadlines_ms: Mapping[str, float]
    max_wait_ms: Mapping[str, float]
    shed_depth: int | None = None
    on_overload: str = "shed"

    def __post_init__(self):
        if self.on_overload not in ("shed", "downgrade"):
            raise ValueError(
                f"on_overload={self.on_overload!r}; want shed|downgrade"
            )
        for m in (self.deadlines_ms, self.max_wait_ms):
            missing = [c for c in PRIORITY_CLASSES if c not in m]
            if missing:
                raise ValueError(f"policy missing classes {missing}")

    def deadline_s(self, priority: str) -> float:
        return self.deadlines_ms[priority] / 1e3

    def max_wait_s(self, priority: str) -> float:
        return self.max_wait_ms[priority] / 1e3

    @classmethod
    def default(cls, *, base_max_wait_ms: float = 5.0,
                deadlines_ms: Mapping[str, float] | None = None,
                shed_depth: int | None = None,
                on_overload: str = "shed") -> "SLOPolicy":
        """A policy with the stock class deadlines and derived per-class
        coalescing budgets (no admission control unless ``shed_depth``)."""
        return cls(
            deadlines_ms=dict(DEFAULT_DEADLINES_MS, **(deadlines_ms or {})),
            max_wait_ms=_default_max_waits(base_max_wait_ms),
            shed_depth=shed_depth,
            on_overload=on_overload,
        )

    @classmethod
    def for_session(cls, session, *, base_max_wait_ms: float = 5.0,
                    deadlines_ms: Mapping[str, float] | None = None,
                    shed_depth: int | None = None,
                    on_overload: str = "shed",
                    max_depth: int = 4096) -> "SLOPolicy":
        """Derive the shed threshold from the session's fitted cost.

        The queue depth at which the queued work *alone* already exceeds
        the ``batch`` deadline — ``deadline_ms / predicted ms-per-image``
        — is where admitting more batch work is pointless: it cannot meet
        its SLO and only lengthens every other class's queue. Falls back
        to no shedding (``shed_depth=None``) when the session's index has
        no usable calibration (predicted cost unknown).
        """
        policy = cls.default(
            base_max_wait_ms=base_max_wait_ms, deadlines_ms=deadlines_ms,
            shed_depth=shed_depth, on_overload=on_overload,
        )
        if shed_depth is not None:
            return policy
        ms = session.predicted_ms_per_image()
        if ms is None or ms <= 0:
            return policy
        depth = int(policy.deadlines_ms["batch"] / ms)
        return dataclasses.replace(
            policy, shed_depth=max(4, min(int(max_depth), depth))
        )


# ---------------------------------------------------------------------------
# closed-loop ladder tuning (repro_torch.launch.serve --target-p95-ms)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LadderDecision:
    """What :func:`tune_ladder` decided and why.

    ``decided_by`` is ``"fitted"`` when the fitted cost model priced the
    candidate ladders, ``"default"`` when no usable fit existed and the
    stock ladder was kept. ``predicted_dispatch_ms`` is the modelled wall
    time of one full top-bucket dispatch (``None`` without a fit).
    """

    buckets: tuple
    max_wait_ms: float
    predicted_dispatch_ms: float | None
    decided_by: str


def tune_ladder(
    calibration,
    *,
    target_p95_ms: float,
    rows: int,
    n_leaves: int,
    desc_per_image: int,
    max_batch_rows: int = 4096,
    n_buckets: int = 3,
    n_shards: int = 1,
    k: int = 10,
    probes: int = 1,
    layout: str = "auto",
    impl: str = "xla",
    cost_model: str = "auto",
    base_max_wait_ms: float = 5.0,
) -> LadderDecision:
    """Pick a bucket ladder whose largest dispatch fits a target p95.

    A request's p95 latency is roughly (queue wait) + (coalescing wait) +
    (one dispatch). The tuner bounds the last term: the fitted model
    prices a full dispatch at each candidate top bucket (``ms/image x
    images per bucket``) and the largest bucket whose dispatch stays
    within ``target_p95_ms x DISPATCH_FRACTION`` wins — big enough to
    amortise, small enough that a request arriving behind one dispatch
    still meets the target. The coalescing budget is then the slack
    between target and dispatch cost (capped at ``base_max_wait_ms``).

    Args:
      calibration: the index's :class:`~repro_torch.core.engine.CalibrationStore`.
      target_p95_ms: the latency target the ladder must serve.
      rows/n_leaves/n_shards/k/probes/layout/impl: the serving plan
        shapes (see :func:`repro_torch.core.engine.plan`).
      desc_per_image: query rows per image — converts the fit's ms/image
        into per-dispatch wall time.
      max_batch_rows/n_buckets: the ladder search space (candidates are
        the stock geometric ladder's rungs).

    Returns:
      A :class:`LadderDecision`; without a usable fit the stock ladder is
      returned unchanged (``decided_by="default"``).
    """
    from repro_torch.core.engine import (
        PlanShapes,
        bucket_ladder,
        fitted_component,
        plan as make_plan,
    )

    default = bucket_ladder(max_batch_rows, n_buckets=n_buckets)
    fitted = fitted_component(cost_model, calibration)
    if fitted is None:
        return LadderDecision(
            buckets=default, max_wait_ms=base_max_wait_ms,
            predicted_dispatch_ms=None, decided_by="default",
        )
    budget = float(target_p95_ms) * DISPATCH_FRACTION
    # candidates: the rungs of a finer ladder, largest first
    candidates = sorted(
        set(bucket_ladder(max_batch_rows, n_buckets=max(4, n_buckets + 2))),
        reverse=True,
    )
    chosen, chosen_ms = None, None
    for b in candidates:
        try:
            p = make_plan(
                rows=rows, n_leaves=n_leaves, n_queries=b,
                n_shards=n_shards, k=k, probes=probes, layout=layout,
                impl=impl, model=cost_model, calibration=calibration,
            )
        except ValueError:
            continue  # no usable tiling at this bucket
        per_image = fitted.predict_ms(
            p, PlanShapes(rows=rows, n_queries=b, n_shards=n_shards,
                          n_leaves=n_leaves),
        )
        if per_image is None:
            continue
        dispatch_ms = max(0.0, per_image) * max(1, b // max(1, desc_per_image))
        # largest-first: the first rung whose dispatch fits wins; if none
        # fits, the loop leaves the smallest plannable rung chosen
        chosen, chosen_ms = b, dispatch_ms
        if dispatch_ms <= budget:
            break
    if chosen is None:
        return LadderDecision(
            buckets=default, max_wait_ms=base_max_wait_ms,
            predicted_dispatch_ms=None, decided_by="default",
        )
    slack = max(1.0, float(target_p95_ms) - chosen_ms)
    return LadderDecision(
        buckets=bucket_ladder(chosen, n_buckets=n_buckets),
        max_wait_ms=min(float(base_max_wait_ms), slack),
        predicted_dispatch_ms=float(chosen_ms),
        decided_by="fitted",
    )


def slab_scale_cap(target_p95_ms: float | None,
                   predicted_ms_per_image: float | None,
                   *, default: float = 2.0) -> float:
    """Cap on the sharded session's per-shard slab-headroom multipliers.

    Growing a shard's slab budget grows its scan cost roughly linearly
    (the fitted model's ``rows_scanned`` term); with a p95 target, growth
    is capped so a grown dispatch still fits the target's dispatch
    budget. Without a target or a priced cost, the stock cap applies.
    """
    if not target_p95_ms or not predicted_ms_per_image \
            or predicted_ms_per_image <= 0:
        return float(default)
    cap = (float(target_p95_ms) * DISPATCH_FRACTION
           / float(predicted_ms_per_image))
    return max(1.0, min(float(default), cap))
