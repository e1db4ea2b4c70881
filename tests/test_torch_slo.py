"""repro_torch's SLO scheduling against the JAX package's: class ranks and
policy validation, the ladder tuner's decision from one calibration JSON
(records tagged with the port's backend, as ``tests/test_torch_costmodel.py``
tags them), the slab-scale cap, and on the port's sessions (CPU): EDF and
FIFO replays bit-identical, EDF's class order, and admission control that
sheds only ``batch`` work."""

import numpy as np
import pytest

from repro.core.engine import CalibrationStore as JStore
from repro.core.engine import PlanShapes as JShapes
from repro.core.engine import plan as j_plan
from repro.serving import tune_ladder as j_tune_ladder
from repro.serving.slo import SLOPolicy as JPolicy
from repro.serving.slo import slab_scale_cap as j_slab_scale_cap
from repro_torch import build_tree
from repro_torch.core.engine import CalibrationStore, bucket_ladder
from repro_torch.data import synth
from repro_torch.index import Index
from repro_torch.serving import (
    MicroBatcher,
    SearchSession,
    SLOPolicy,
    TenantClass,
    TraceLoadGenerator,
    tune_ladder,
)
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.slo import (
    DEFAULT_DEADLINES_MS,
    PRIORITY_CLASSES,
    class_rank,
    slab_scale_cap,
)

DIM = 24
DPI = 8
BACKEND = "cpu"


@pytest.fixture(scope="module")
def corpus():
    import torch

    x, _ = synth.sample_descriptors(3000, DIM, seed=0, n_centers=50)
    tree = build_tree(x, (8, 4), generator=torch.Generator().manual_seed(1),
                      device="cpu")
    idx = Index.create(tree, None, device="cpu")
    idx.append(x[:1500])
    idx.append(x[1500:])
    idx.commit()
    return x, idx


def _session(idx):
    # no calibration: the default policy then never sheds (as for the
    # reference's fresh sessions); earlier sessions' records would price it
    idx.calibration.clear()
    s = SearchSession(idx, k=3, layout="point_major", buckets=(64,))
    s.warmup()
    return s


def _mixed_burst(x, n_each: int):
    """``3 * n_each`` requests, all at t=0, classes interleaved by rid."""
    reqs = TraceLoadGenerator(x, DPI, seed=5).requests(
        np.arange(3 * n_each) % 20, np.zeros(3 * n_each))
    for i, r in enumerate(reqs):
        r.priority = PRIORITY_CLASSES[i % 3]
    return reqs


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------


def test_class_rank_order_and_validation():
    assert [class_rank(c) for c in PRIORITY_CLASSES] == [0, 1, 2]
    with pytest.raises(ValueError, match="unknown priority"):
        class_rank("bulk")


def test_slo_policy_validation_and_budgets():
    p = SLOPolicy.default(base_max_wait_ms=8.0)
    jp = JPolicy.default(base_max_wait_ms=8.0)
    assert dict(p.deadlines_ms) == dict(jp.deadlines_ms) == DEFAULT_DEADLINES_MS
    assert dict(p.max_wait_ms) == dict(jp.max_wait_ms)
    assert (p.max_wait_ms["interactive"] < p.max_wait_ms["standard"]
            < p.max_wait_ms["batch"])
    with pytest.raises(ValueError, match="on_overload"):
        SLOPolicy.default(on_overload="panic")
    with pytest.raises(ValueError, match="missing classes"):
        SLOPolicy(deadlines_ms={"interactive": 1.0},
                  max_wait_ms=dict.fromkeys(PRIORITY_CLASSES, 1.0))
    with pytest.raises(ValueError, match="burst_factor"):
        TenantClass("batch", 10, rate=1.0, burst_factor=0.5)


def test_policy_for_session_derives_shed_depth():
    class _Session:
        def __init__(self, ms):
            self._ms = ms

        def predicted_ms_per_image(self):
            return self._ms

    assert SLOPolicy.for_session(_Session(10.0)).shed_depth == 200
    assert SLOPolicy.for_session(_Session(None)).shed_depth is None
    assert SLOPolicy.for_session(_Session(10_000.0)).shed_depth == 4
    assert SLOPolicy.for_session(_Session(0.001), max_depth=64).shed_depth == 64
    assert SLOPolicy.for_session(_Session(10.0), shed_depth=7).shed_depth == 7


# ---------------------------------------------------------------------------
# the ladder tuner and the slab-scale cap
# ---------------------------------------------------------------------------


def _calibration_json(rows=65_536, n_leaves=64):
    """The reference's store after measurements at two buckets of both
    dense layouts, as JSON with this backend's tag on every record."""
    cal = JStore()
    for layout in ("point_major", "query_routed"):
        for b, ms in ((128, 1.5), (1024, 4.0)):
            p = j_plan(rows=rows, n_leaves=n_leaves, n_queries=b, n_shards=1,
                       k=10, layout=layout)
            cal.record(p, ms, JShapes(rows=rows, n_queries=b, n_shards=1,
                                      n_leaves=n_leaves))
    d = cal.to_json()
    for rec in d["records"]:
        rec["backend"] = BACKEND
    return d


@pytest.mark.parametrize("target", [1e6, 40.0, 12.0, 1e-3])
def test_tune_ladder_equals_the_reference_decision(target):
    d = _calibration_json()
    kw = dict(target_p95_ms=target, rows=65_536, n_leaves=64,
              desc_per_image=8, max_batch_rows=1024, n_buckets=3)
    j = j_tune_ladder(JStore.from_json(d), **kw)
    t = tune_ladder(CalibrationStore.from_json(d, backend=BACKEND), **kw)
    assert t.decided_by == j.decided_by == "fitted"
    # the same ladder; the times are a least-squares fit's, equal to
    # rounding (numpy's solver on both sides, over the same records)
    assert t.buckets == j.buckets
    assert t.max_wait_ms == pytest.approx(j.max_wait_ms, rel=1e-9)
    assert t.predicted_dispatch_ms == pytest.approx(j.predicted_dispatch_ms,
                                                    rel=1e-9)
    # another backend's records are carried, not consulted: stock ladder
    other = tune_ladder(CalibrationStore.from_json(d, backend="cuda:X"), **kw)
    assert other.decided_by == "default"
    assert other.buckets == bucket_ladder(1024, n_buckets=3)


def test_slab_scale_cap_equals_the_reference():
    for target in (None, 0.0, 100.0):
        for ms in (None, 0.0, 10.0, 30.0, 100.0, 1000.0):
            assert slab_scale_cap(target, ms) == j_slab_scale_cap(target, ms)
    assert slab_scale_cap(100.0, 30.0) == pytest.approx(100.0 * 0.5 / 30.0)


# ---------------------------------------------------------------------------
# scheduling on the port's sessions
# ---------------------------------------------------------------------------


def test_edf_and_fifo_return_bit_identical_results(corpus):
    x, idx = corpus
    by_sched = {}
    for sched in ("fifo", "edf"):
        s = _session(idx)
        done = MicroBatcher(s, max_wait_ms=5.0, max_queue=256,
                            scheduler=sched).run(_mixed_burst(x, 12))
        assert s.metrics.requests == 36 and s.metrics.shed == 0
        assert s.steady_state_recompiles() == 0
        by_sched[sched] = {c.rid: c for c in done}
    assert set(by_sched["fifo"]) == set(by_sched["edf"])
    for rid, f in by_sched["fifo"].items():
        e = by_sched["edf"][rid]
        np.testing.assert_array_equal(f.ids, e.ids)
        np.testing.assert_array_equal(f.dists, e.dists)


def test_edf_dispatches_interactive_before_batch(corpus):
    x, idx = corpus
    s = _session(idx)
    done = MicroBatcher(s, max_wait_ms=5.0, max_queue=256,
                        scheduler="edf").run(_mixed_burst(x, 12))
    finish = {p: [c.finish for c in done if c.priority == p]
              for p in PRIORITY_CLASSES}
    assert max(finish["interactive"]) <= max(finish["batch"])
    assert np.median(finish["interactive"]) < np.median(finish["batch"])
    for c in done:
        assert c.latency_ms == pytest.approx(c.wait_ms + c.compute_ms,
                                             rel=1e-6, abs=1e-6)


def test_edf_admission_control_sheds_only_batch(corpus):
    x, idx = corpus
    reqs = TraceLoadGenerator(x, DPI, seed=5).requests(np.arange(12) % 20,
                                                       np.zeros(12))
    for i, r in enumerate(reqs):
        r.priority = "batch" if i < 10 else "interactive"
    s = _session(idx)
    done = MicroBatcher(s, max_wait_ms=5.0, max_queue=256, scheduler="edf",
                        policy=SLOPolicy.default(shed_depth=2)).run(reqs)
    shed = [c for c in done if c.source == "shed"]
    assert len(shed) == 8 and s.metrics.shed == 8
    assert all(c.priority == "batch" and c.ids is None for c in shed)
    assert s.metrics.requests == 4
    assert s.metrics.per_class["interactive"].completed == 2
    assert s.metrics.per_class["batch"].slo_attainment < 1.0
    # downgrade keeps every request
    for r in reqs:
        r.priority = "batch"
    s2 = _session(idx)
    done2 = MicroBatcher(s2, max_wait_ms=5.0, max_queue=256, scheduler="edf",
                         policy=SLOPolicy.default(shed_depth=2,
                                                  on_overload="downgrade")
                         ).run(reqs)
    assert s2.metrics.shed == 0 and s2.metrics.downgraded == 10
    assert all(c.source == "engine" for c in done2)


def test_unknown_scheduler_rejected(corpus):
    with pytest.raises(ValueError, match="unknown scheduler"):
        MicroBatcher(SearchSession(corpus[1], k=3, layout="point_major",
                                   buckets=(64,)), scheduler="lifo")


def test_metrics_per_class_attainment_and_breakdown():
    m = ServingMetrics()
    m.observe_latency("interactive", wait_ms=10.0, compute_ms=20.0,
                      deadline_ms=50.0)
    m.observe_latency("interactive", wait_ms=100.0, compute_ms=20.0,
                      deadline_ms=50.0)
    m.observe_drop("interactive", "shed")
    m.observe_drop("standard", "rejected")
    cm = m.per_class["interactive"]
    assert (cm.completed, cm.attained, cm.shed) == (2, 1, 1)
    assert cm.slo_attainment == pytest.approx(1 / 3)
    d = m.to_dict()
    assert d["per_class"]["interactive"]["slo_attainment"] == \
        pytest.approx(1 / 3)
    with pytest.raises(ValueError, match="unknown drop"):
        m.observe_drop("batch", "lost")
    assert ServingMetrics().queue_summary()["p95"] == 0
