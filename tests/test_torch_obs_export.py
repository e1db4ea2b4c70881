"""repro_torch's trace export on a traced serving replay (CPU): span-tree
fan-in under coalesced batches, tracing never changes results (shards 1-3),
the Chrome ``trace_event`` and JSONL round trips, ``summary``, the serving
metrics and the hot-leaf cache in the process registry, and the stdlib-only
``scripts/tracereport.py`` reading the port's files -- as the JAX package's
``tests/test_obs.py`` holds them for its own. The two packages' exporters
write the same document from the same spans."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from repro.obs import export as j_export
from repro_torch import build_tree
from repro_torch.data import synth
from repro_torch.index import Index
from repro_torch.obs import (
    Tracer,
    get_registry,
    summary,
    tracing,
    write_chrome_trace,
    write_jsonl,
)
from repro_torch.obs.export import (
    PID_ENGINE,
    PID_REQUESTS,
    PID_SHARD_BASE,
    chrome_trace_events,
    export_trace,
)
from repro_torch.serving import (
    MicroBatcher,
    SearchSession,
    ShardedSearchSession,
    TraceLoadGenerator,
)

DIM = 16
N = 2000


@pytest.fixture(scope="module")
def corpus():
    x, _ = synth.sample_descriptors(N, DIM, seed=0, n_centers=40)
    tree = build_tree(x, (8, 4), generator=torch.Generator().manual_seed(1),
                      device="cpu")
    idx = Index.create(tree, None, device="cpu")
    for lo, hi in ((0, 500), (500, 1500), (1500, N)):
        idx.append(x[lo:hi])
    idx.commit()
    return x, idx


def _replay(corpus, *, shards, tracer, cache_leaves=0):
    x, idx = corpus
    kw = dict(k=5, layout="point_major", probes=2, buckets=(32, 96),
              cache_leaves=cache_leaves, cache_admit_after=1)
    s = (SearchSession(idx, **kw) if shards is None
         else ShardedSearchSession(idx, shards=shards, **kw))
    s.warmup()
    reqs = TraceLoadGenerator(x, 20, seed=3).from_trace(
        24, N // 20, skew="zipf", rate=2000.0)
    with tracing(tracer):
        done = MicroBatcher(s, max_wait_ms=4.0, max_queue=1024).run(reqs)
    return done, s


@pytest.fixture(scope="module")
def traced2(corpus):
    tracer = Tracer(sample=1.0, seed=0)
    done, _ = _replay(corpus, shards=2, tracer=tracer, cache_leaves=32)
    return tracer, done


def test_fan_in_integrity_under_coalesced_batches(traced2):
    tracer, done = traced2
    spans = tracer.spans
    dispatches = [s for s in spans if s.name == "engine.dispatch"]
    requests = [s for s in spans if s.name == "request"]
    engine_reqs = [s for s in requests if s.attrs.get("source") == "engine"]
    assert dispatches and engine_reqs
    assert max(len(d.attrs["rids"]) for d in dispatches) > 1
    by_dispatch = {}
    for r in engine_reqs:
        by_dispatch.setdefault(r.attrs["dispatch_id"], []).append(r)
    assert sum(len(v) for v in by_dispatch.values()) == len(engine_reqs)
    for d in dispatches:
        assert {r.trace_id for r in by_dispatch.get(d.span_id, [])} == \
            set(d.attrs["rids"])
    for r in requests:
        kids = [s for s in spans if s.parent_id == r.span_id]
        assert sorted(k.name for k in kids if k.name != "cache.lookup") == \
            ["compute", "queue.wait"]
        for k in kids:
            assert k.trace_id == r.trace_id
            assert r.t0 <= k.t0 and k.t1 <= r.t1 + 1e-9
    assert {s.trace_id for s in requests} == {c.rid for c in done}
    assert {s.attrs["shard"] for s in spans if s.name == "shard.scan"} == {0, 1}
    assert any(s.name == "gather.merge" for s in spans)


@pytest.mark.parametrize("shards", [None, 2, 3])
def test_tracing_never_changes_results(corpus, shards):
    base, _ = _replay(corpus, shards=shards, tracer=None)
    tracer = Tracer(sample=1.0, seed=0)
    traced, _ = _replay(corpus, shards=shards, tracer=tracer)
    assert len(tracer) > 0
    ref = {c.rid: c for c in base}
    assert set(ref) == {c.rid for c in traced}
    for c in traced:
        np.testing.assert_array_equal(c.ids, ref[c.rid].ids)
        np.testing.assert_array_equal(c.dists, ref[c.rid].dists)


def test_chrome_export_roundtrip(traced2, tmp_path):
    tracer, _ = traced2
    path = write_chrome_trace(tracer, str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    assert doc["displayTimeUnit"] == "ms"
    assert doc["otherData"]["enabled"] is True
    events = doc["traceEvents"]
    meta = [e for e in events if e["ph"] == "M"]
    body = [e for e in events if e["ph"] != "M"]
    assert len(body) == len(tracer.spans)
    ts = [e["ts"] for e in body]
    assert ts == sorted(ts)
    names = {e["pid"]: e["args"]["name"] for e in meta}
    assert names[PID_SHARD_BASE] == "shard 0"
    assert names[PID_SHARD_BASE + 1] == "shard 1"
    assert names[PID_REQUESTS] == "requests" and names[PID_ENGINE] == "engine"
    for e in body:
        assert e["ph"] in ("X", "i")
        if e["name"] == "shard.scan":
            assert e["pid"] == PID_SHARD_BASE + e["args"]["shard"]
        elif e["name"] in ("engine.dispatch", "engine.execute", "gather.merge"):
            assert e["pid"] == PID_ENGINE
        elif e["name"] == "request":
            assert e["pid"] == PID_REQUESTS
            assert e["tid"] == e["args"]["trace_id"]
        if e["ph"] == "X":
            assert e["dur"] >= 0.0
    # the JAX package's exporter writes the same events from these spans
    assert chrome_trace_events(tracer) == j_export.chrome_trace_events(tracer)
    assert export_trace(tracer, str(tmp_path / "t2.json")).endswith(".json")


def test_jsonl_export_roundtrip(traced2, tmp_path):
    tracer, _ = traced2
    path = write_jsonl(tracer, str(tmp_path / "trace.jsonl"))
    with open(path) as f:
        lines = [json.loads(ln) for ln in f]
    assert lines[0] == {"header": tracer.describe()}
    assert len(lines) - 1 == len(tracer.spans)
    for rec, span in zip(lines[1:], tracer.spans):
        assert rec["name"] == span.name
        assert rec["dur_ms"] == pytest.approx(span.dur_ms)
    assert export_trace(tracer, str(tmp_path / "t.jsonl")).endswith(".jsonl")


def test_summary_and_tracereport_read_both_formats(traced2, tmp_path):
    tracer, _ = traced2
    text = summary(tracer, top=3)
    assert "slowest requests" in text and "shard.scan" in text
    assert text == j_export.summary(tracer, top=3)
    script = os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                          "tracereport.py")
    spec = importlib.util.spec_from_file_location("tracereport", script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for path in (write_chrome_trace(tracer, str(tmp_path / "t.json")),
                 write_jsonl(tracer, str(tmp_path / "t.jsonl"))):
        report = mod.report(mod._load_spans(path), top=3)
        assert "slowest requests" in report
        assert "shard 0" in report and "shard 1" in report


def test_serving_and_cache_register_in_the_process_registry(corpus):
    _, s = _replay(corpus, shards=None, tracer=None, cache_leaves=16)
    snap = get_registry().snapshot()
    flat = json.dumps(snap)
    assert f"serving_metrics@{id(s.metrics):x}" in flat
    assert f"hot_leaf_cache@{id(s.cache):x}" in flat
    assert "serving.requests" in flat and "cache.hits" in flat
