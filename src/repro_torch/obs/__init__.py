"""Observability: spans, a metrics registry and trace export, as the JAX
package's ``obs`` has them.

  * :mod:`repro_torch.obs.tracer` -- ``Tracer`` records span trees; the
    process-wide default is the no-op ``NULL_TRACER``, so instrumented
    paths cost an attribute load until a real tracer is installed;
  * :mod:`repro_torch.obs.registry` -- ``MetricsRegistry`` of named
    counters / gauges / histograms (the index lifecycle counts
    ``index.appends``, ``index.commits``, ``index.tombstoned`` ...; the
    serving metrics and the hot-leaf cache register as sources);
  * :mod:`repro_torch.obs.export` -- JSONL event log, Chrome
    ``trace_event`` JSON and a text summary of a recorded tracer.

Process-wide accessors: :func:`get_tracer` / :func:`set_tracer` /
:func:`tracing`, and :func:`get_registry` / :func:`set_registry`.
"""

from __future__ import annotations

import contextlib

from repro_torch.obs.export import (  # noqa: F401
    chrome_trace_events,
    export_trace,
    summary,
    write_chrome_trace,
    write_jsonl,
)
from repro_torch.obs.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.tracer import (  # noqa: F401
    NULL_SPAN,
    NULL_TRACER,
    NullTracer,
    Span,
    Tracer,
)

_tracer = NULL_TRACER
_registry = MetricsRegistry()


def get_tracer():
    """The process-wide active tracer (default: the no-op
    :data:`NULL_TRACER`)."""
    return _tracer


def set_tracer(tracer):
    """Install ``tracer`` (``None`` disables); returns the previous one."""
    global _tracer
    prev = _tracer
    _tracer = tracer if tracer is not None else NULL_TRACER
    return prev


@contextlib.contextmanager
def tracing(tracer):
    """Scoped :func:`set_tracer`: install for the block, restore after."""
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)


def get_registry() -> MetricsRegistry:
    """The process-wide metrics registry (always on)."""
    return _registry


def set_registry(registry: MetricsRegistry | None) -> MetricsRegistry:
    """Install a registry (``None`` = a fresh empty one); returns the
    previous one."""
    global _registry
    prev = _registry
    _registry = registry if registry is not None else MetricsRegistry()
    return prev
