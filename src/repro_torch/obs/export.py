"""Trace exporters: JSONL event log, Chrome ``trace_event`` JSON, and a
human-readable summary.

Three views of one recorded :class:`~repro_torch.obs.tracer.Tracer`, in
the JAX package's formats (``scripts/tracereport.py`` reads either
package's files):

  * :func:`write_jsonl` — one JSON object per span/event line (the
    structured log ``scripts/tracereport.py`` and ad-hoc ``jq`` digest);
  * :func:`write_chrome_trace` — the Chrome ``trace_event`` format
    (open the file in https://ui.perfetto.dev or ``chrome://tracing``):
    request / queue-wait / compute bars per request under the
    ``requests`` process (one lane per request id), engine dispatches
    and the gather merge under ``engine``, and one *process per shard*
    (``shard 0``, ``shard 1``, …) so scatter legs render as parallel
    tracks. Events are sorted by timestamp (monotone ``ts``);
  * :func:`summary` — per-span-name count/total/mean table plus the
    slowest traced requests, for terminal eyes.

:func:`export_trace` picks the format from the extension (``.jsonl`` →
JSONL, anything else → Chrome JSON) — the ``--trace-out`` contract of
``python -m repro_torch.launch.serve``.
"""

from __future__ import annotations

import json
import os

# pid assignment for the Chrome trace (process lanes in Perfetto)
PID_PROCESS = 0  # warmup, index lifecycle, everything unclassified
PID_REQUESTS = 1  # per-request bars, one tid (lane) per request id
PID_ENGINE = 2  # engine dispatches (tid 0) + gather merge (tid 1)
PID_SHARD_BASE = 10  # shard N's scans land on pid PID_SHARD_BASE + N

_REQUEST_SPANS = ("request", "queue.wait", "compute", "cache.lookup")


def _placement(span) -> tuple[int, int]:
    """(pid, tid) for one span — the per-shard/pid mapping contract."""
    if span.name == "shard.scan":
        return PID_SHARD_BASE + int(span.attrs.get("shard", 0)), 0
    if span.name in ("engine.dispatch", "engine.execute"):
        return PID_ENGINE, 0
    if span.name == "gather.merge":
        return PID_ENGINE, 1
    if span.name in _REQUEST_SPANS or span.name.startswith("admission."):
        return PID_REQUESTS, int(span.trace_id or 0)
    return PID_PROCESS, 0


def chrome_trace_events(tracer) -> list[dict]:
    """The ``traceEvents`` list: process/thread-name metadata first, then
    one ``X`` (complete) or ``i`` (instant) event per span, sorted by
    timestamp."""
    events: list[dict] = []
    pids: dict[int, str] = {PID_PROCESS: "process",
                            PID_REQUESTS: "requests",
                            PID_ENGINE: "engine"}
    for span in tracer.spans:
        pid, tid = _placement(span)
        if pid >= PID_SHARD_BASE:
            pids[pid] = f"shard {pid - PID_SHARD_BASE}"
        ev = {
            "name": span.name,
            "cat": span.kind,
            "pid": pid,
            "tid": tid,
            "ts": round(span.t0 * 1e6, 3),  # microseconds
            "args": dict(span.attrs, trace_id=span.trace_id,
                         span_id=span.span_id, parent_id=span.parent_id),
        }
        if span.kind == "event" or span.t1 is None:
            ev["ph"] = "i"
            ev["s"] = "t"  # thread-scoped instant
        else:
            ev["ph"] = "X"
            ev["dur"] = round(max(0.0, span.t1 - span.t0) * 1e6, 3)
        events.append(ev)
    events.sort(key=lambda e: (e["ts"], e["pid"], e["tid"]))
    meta = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": label}}
        for pid, label in sorted(pids.items())
    ]
    return meta + events


def write_chrome_trace(tracer, path: str) -> str:
    """Write the Chrome ``trace_event`` JSON for ``tracer``; returns the
    path (dirs created)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "traceEvents": chrome_trace_events(tracer),
        "displayTimeUnit": "ms",
        "otherData": tracer.describe(),
    }
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def write_jsonl(tracer, path: str) -> str:
    """Write one JSON object per span/event line; returns the path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps({"header": tracer.describe()}) + "\n")
        for span in tracer.spans:
            f.write(json.dumps(span.to_json()) + "\n")
    return path


def export_trace(tracer, path: str) -> str:
    """Format-by-extension exporter: ``.jsonl`` → structured event log,
    anything else → Chrome ``trace_event`` JSON."""
    if path.endswith(".jsonl"):
        return write_jsonl(tracer, path)
    return write_chrome_trace(tracer, path)


def summary(tracer, *, top: int = 5) -> str:
    """Human-readable report: per-name span accounting plus the ``top``
    slowest traced requests (wait vs compute split)."""
    by_name: dict[str, list[float]] = {}
    requests = []
    waits: dict[int, float] = {}
    computes: dict[int, float] = {}
    for s in tracer.spans:
        if s.kind == "event":
            continue
        by_name.setdefault(s.name, []).append(s.dur_ms)
        if s.name == "request":
            requests.append(s)
        elif s.name == "queue.wait" and s.trace_id is not None:
            waits[s.trace_id] = s.dur_ms
        elif s.name == "compute" and s.trace_id is not None:
            computes[s.trace_id] = s.dur_ms
    lines = [f"== trace summary ({len(tracer.spans)} records, "
             f"{tracer.dropped} dropped) =="]
    for name in sorted(by_name):
        ds = by_name[name]
        lines.append(
            f"{name:<16} n={len(ds):<6} total={sum(ds):9.1f} ms  "
            f"mean={sum(ds) / len(ds):7.2f} ms  max={max(ds):7.2f} ms"
        )
    requests.sort(key=lambda s: -s.dur_ms)
    if requests:
        lines.append(f"-- top {min(top, len(requests))} slowest requests --")
        for s in requests[:top]:
            rid = s.trace_id
            lines.append(
                f"rid={rid:<6} class={s.attrs.get('priority', '?'):<12} "
                f"total={s.dur_ms:8.2f} ms  "
                f"wait={waits.get(rid, 0.0):8.2f} ms  "
                f"compute={computes.get(rid, 0.0):8.2f} ms  "
                f"source={s.attrs.get('source', '?')}"
            )
    return "\n".join(lines)
