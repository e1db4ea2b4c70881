"""Unified metrics registry: named counters / gauges / histograms with
labeled series, plus weakly-held *sources* (live objects polled at
snapshot time).

The same registry as the JAX package's ``obs/registry.py``, so the two
packages name their series alike: dotted lowercase paths, subsystem first
(``index.appends``, ``index.commits``, ``calibration.records``), labels for
per-class / per-shard splits. All plain Python -- nothing here touches a
device, and nothing feeds back into planning (observability must never
perturb results).
"""

from __future__ import annotations

import json
import os
import weakref


def _series_key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotone counter (floats allowed: ``engine_ms`` style totals)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def to_json(self):
        v = self.value
        return int(v) if float(v).is_integer() else v


class Gauge:
    """Last-write-wins value; any JSON-able value is allowed (strings
    carry identity facts like the active cost model)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.value = None

    def set(self, value) -> None:
        self.value = value

    def to_json(self):
        return self.value


# default histogram bucket upper bounds (ms-flavoured geometric ladder)
DEFAULT_BOUNDS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
                  1000.0, 2000.0, 5000.0)


class Histogram:
    """Fixed-bound histogram: per-bucket counts plus exact count/sum/
    min/max — O(1) memory however long the replay runs."""

    __slots__ = ("name", "labels", "bounds", "counts", "count", "total",
                 "min", "max")

    def __init__(self, name: str, labels: dict, bounds=DEFAULT_BOUNDS):
        self.name = name
        self.labels = labels
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)  # +overflow bucket
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for b in self.bounds:
            if v <= b:
                break
            i += 1
        self.counts[i] += 1
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def to_json(self) -> dict:
        return {
            "bounds": list(self.bounds),
            "counts": list(self.counts),
            "count": self.count,
            "sum": self.total,
            "mean": self.total / self.count if self.count else None,
            "min": self.min,
            "max": self.max,
        }


class MetricsRegistry:
    """One process-wide namespace of instruments + weakly-held sources."""

    def __init__(self):
        self._instruments: dict[str, object] = {}
        self._sources: dict[str, tuple] = {}  # name -> (weakref, fn)

    # -- instruments ---------------------------------------------------------
    def _get(self, cls, name: str, labels: dict, **kw):
        key = _series_key(name, labels)
        inst = self._instruments.get(key)
        if inst is None:
            inst = self._instruments[key] = cls(name, labels, **kw)
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {key!r} already registered as "
                f"{type(inst).__name__}, not {cls.__name__}"
            )
        return inst

    def counter(self, name: str, **labels) -> Counter:
        """Get-or-create the counter for ``name`` + ``labels``."""
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        """Get-or-create the gauge for ``name`` + ``labels``."""
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, *, bounds=DEFAULT_BOUNDS,
                  **labels) -> Histogram:
        """Get-or-create the histogram for ``name`` + ``labels``.
        ``bounds`` apply only at creation (first caller wins)."""
        return self._get(Histogram, name, labels, bounds=bounds)

    # -- sources -------------------------------------------------------------
    def register_source(self, name: str, obj, fn) -> None:
        """Poll ``fn(obj)`` (returning a flat ``{series: value}`` dict)
        at snapshot time; ``obj`` is held weakly, so a garbage-collected
        owner silently drops out of later snapshots."""
        self._sources[name] = (weakref.ref(obj), fn)

    def unregister_source(self, name: str) -> None:
        self._sources.pop(name, None)

    # -- export --------------------------------------------------------------
    def snapshot(self) -> dict:
        """One JSON-able view of everything: ``{"metrics": {series:
        value-or-histogram}, "sources": {name: {series: value}}}``.
        Dead sources are pruned as a side effect."""
        metrics = {
            key: inst.to_json() for key, inst in sorted(
                self._instruments.items()
            )
        }
        sources = {}
        for name in sorted(self._sources):
            ref, fn = self._sources[name]
            obj = ref()
            if obj is None:
                del self._sources[name]
                continue
            sources[name] = fn(obj)
        return {"metrics": metrics, "sources": sources}

    def dump(self, path: str) -> str:
        """Write :meth:`snapshot` as JSON (dirs created); returns the
        path."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
        return path

    def summary(self) -> str:
        """Human-readable one-line-per-series report."""
        snap = self.snapshot()
        lines = ["== metrics registry =="]
        for key, v in snap["metrics"].items():
            if isinstance(v, dict):  # histogram
                mean = v["mean"]
                lines.append(
                    f"{key}: count={v['count']} mean="
                    + (f"{mean:.2f}" if mean is not None else "-")
                    + (f" max={v['max']:.2f}" if v["max"] is not None else "")
                )
            else:
                lines.append(f"{key}: {v}")
        for name, series in snap["sources"].items():
            lines.append(f"-- source {name} --")
            for k, v in series.items():
                lines.append(f"{k}: {v}")
        return "\n".join(lines)

    def __len__(self) -> int:
        return len(self._instruments)
