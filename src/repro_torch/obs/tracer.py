"""Per-request span trees: the tracing half of ``repro_torch.obs``.

A *span* is one named, attributed time interval — ``[t0, t1)`` seconds on
the tracer's timeline — optionally tied to a *trace id* (the request it
belongs to) and a *parent span* (the tree). The serving replay runs on a
virtual clock (arrivals come from the trace, compute advances by measured
wall time), so the tracer supports both domains on one timeline:

  * ``tracer.span(name, ...)`` — a context manager measuring wall time
    (re-based through the active :meth:`Tracer.timebase`, so engine work
    nested inside a virtual-time dispatch lands at the dispatch's virtual
    timestamp);
  * ``tracer.add_span(name, t0, t1, ...)`` — an explicit interval in
    caller-supplied (virtual) seconds, used by the micro-batcher for the
    request / queue-wait / compute bars;
  * ``tracer.event(name, ...)`` — a zero-duration instant (admission
    shed/reject decisions and similar).

Two hard requirements shape the design:

  * **near-zero cost when disabled** — the process-wide default is the
    shared :data:`NULL_TRACER` whose every method is a no-op returning
    shared singletons; instrumented hot paths pay one attribute load and
    (at most) one kwargs dict build per dispatch, never per row;
  * **never perturb results** — the tracer only *records*; nothing in it
    feeds back into planning, scheduling, or the engine, so ids and
    distances are bit-identical with tracing on or off (asserted by
    the JAX package's tests, whose tracer this is).

Sampling is deterministic: :meth:`Tracer.sampled` hashes ``(seed,
trace_id)``, so the same seed always traces the same request subset
regardless of replay timing — replays stay comparable, and a high-QPS
trace can be thinned (``sample=0.01``) without losing specific requests
between runs. Unsampled request spans are counted in ``dropped`` (never
silent).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import zlib


@dataclasses.dataclass
class Span:
    """One recorded interval (or instant, for ``kind="event"``)."""

    name: str
    span_id: int
    t0: float  # seconds on the tracer timeline
    t1: float | None = None  # None while open
    trace_id: int | None = None  # owning request (rid), None = process span
    parent_id: int | None = None
    kind: str = "span"  # "span" | "event"
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def dur_ms(self) -> float:
        return 0.0 if self.t1 is None else (self.t1 - self.t0) * 1e3

    def set(self, **attrs) -> "Span":
        """Attach attributes after the span opened (chains)."""
        self.attrs.update(attrs)
        return self

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "trace_id": self.trace_id,
            "parent_id": self.parent_id,
            "kind": self.kind,
            "t0_ms": self.t0 * 1e3,
            "t1_ms": None if self.t1 is None else self.t1 * 1e3,
            "dur_ms": self.dur_ms,
            "attrs": self.attrs,
        }


class _NullSpan:
    """Shared do-nothing span: context manager, ``set()``, the lot."""

    __slots__ = ()
    span_id = None
    attrs: dict = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every operation is a no-op on shared
    singletons, so instrumentation costs ~an attribute load when tracing
    is off. ``enabled`` is ``False`` so hot paths can skip building
    attribute dicts entirely."""

    __slots__ = ()
    enabled = False
    sample_rate = 0.0
    dropped = 0

    def sampled(self, trace_id) -> bool:
        return False

    def span(self, name, **attrs):
        return NULL_SPAN

    def add_span(self, name, t0, t1, **kw):
        return NULL_SPAN

    def event(self, name, t=None, **kw):
        return NULL_SPAN

    def timebase(self, t_virtual):
        return NULL_SPAN  # context manager no-op

    @property
    def spans(self):
        return ()

    def __len__(self) -> int:
        return 0

    def describe(self) -> dict:
        """The ``obs`` header block every benchmark artifact records."""
        return {"enabled": False, "sample": 0.0, "spans": 0, "events": 0,
                "dropped": 0}


NULL_TRACER = NullTracer()


class Tracer:
    """In-memory span recorder for one process/replay.

    Args:
      sample: fraction of *requests* traced (request-scoped spans whose
        trace id fails :meth:`sampled` are the caller's to skip; process
        spans — warmup, lifecycle, engine dispatches — are always kept).
      seed: sampling hash seed — same seed, same traced request subset.
      max_spans: hard in-memory cap; spans past it are dropped and
        counted in ``dropped`` (never silent). ``None`` = unbounded.

    Raises:
      ValueError: a sample rate outside ``[0, 1]``.
    """

    def __init__(self, *, sample: float = 1.0, seed: int = 0,
                 max_spans: int | None = None):
        if not 0.0 <= sample <= 1.0:
            raise ValueError(f"sample={sample} must be in [0, 1]")
        self.enabled = True
        self.sample_rate = float(sample)
        self.seed = int(seed)
        self.max_spans = max_spans
        self.spans: list[Span] = []
        self.dropped = 0  # sampled-out request spans + over-cap spans
        self._next_id = 1
        self._epoch = time.perf_counter()
        self._offset = 0.0  # virtual-timebase correction (see timebase())
        self._stack: list[Span] = []  # open context-manager spans

    # -- clock ---------------------------------------------------------------
    def now(self) -> float:
        """Seconds on the tracer timeline: wall time since construction,
        re-based by the active :meth:`timebase` (virtual replay time)."""
        return time.perf_counter() - self._epoch + self._offset

    @contextlib.contextmanager
    def timebase(self, t_virtual: float):
        """Pin the timeline to virtual time for the enclosed block.

        The micro-batcher replays on a virtual clock; wrapping each engine
        dispatch in ``timebase(dispatch_t)`` makes the session's
        wall-measured nested spans land at the dispatch's *virtual*
        timestamp (advancing with real elapsed time), so one trace file
        holds a single consistent timeline.
        """
        prev = self._offset
        self._offset = t_virtual - (time.perf_counter() - self._epoch)
        try:
            yield self
        finally:
            self._offset = prev

    # -- sampling ------------------------------------------------------------
    def sampled(self, trace_id) -> bool:
        """Deterministic per-request sampling decision: a hash of
        ``(seed, trace_id)`` against the sample rate — independent of
        call order and wall time, so the same seed traces the same
        request subset in every replay. A ``False`` bumps ``dropped``."""
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            self.dropped += 1
            return False
        h = zlib.crc32(f"{self.seed}:{trace_id}".encode()) / 2**32
        if h < self.sample_rate:
            return True
        self.dropped += 1
        return False

    # -- recording -----------------------------------------------------------
    def _admit(self, span: Span) -> Span:
        if self.max_spans is not None and len(self.spans) >= self.max_spans:
            self.dropped += 1
            return NULL_SPAN  # type: ignore[return-value]
        self.spans.append(span)
        return span

    def add_span(self, name: str, t0: float, t1: float, *,
                 trace_id=None, parent=None, **attrs) -> Span:
        """Record one explicit interval (virtual-time path).

        Args:
          name: span name (``index.append``, ``index.commit``, ...).
          t0/t1: interval bounds, seconds on the tracer timeline.
          trace_id: owning request id (``None`` for process spans).
          parent: parent ``Span`` (or its id) for the tree.
          **attrs: span attributes (JSON-able values).
        """
        pid = parent.span_id if isinstance(parent, (Span, _NullSpan)) \
            else parent
        span = Span(name=name, span_id=self._next_id, t0=float(t0),
                    t1=float(t1), trace_id=trace_id, parent_id=pid,
                    attrs=attrs)
        self._next_id += 1
        return self._admit(span)

    def event(self, name: str, t: float | None = None, *,
              trace_id=None, parent=None, **attrs) -> Span:
        """Record one instant (zero-duration ``kind="event"``)."""
        t = self.now() if t is None else float(t)
        pid = parent.span_id if isinstance(parent, (Span, _NullSpan)) \
            else parent
        span = Span(name=name, span_id=self._next_id, t0=t, t1=t,
                    trace_id=trace_id, parent_id=pid, kind="event",
                    attrs=attrs)
        self._next_id += 1
        return self._admit(span)

    @contextlib.contextmanager
    def span(self, name: str, *, trace_id=None, parent=None, **attrs):
        """Measure the enclosed block as one span (wall time, re-based by
        the active :meth:`timebase`). Nested ``span()`` blocks parent
        automatically; explicit ``parent`` overrides."""
        if parent is None and self._stack:
            parent = self._stack[-1]
        pid = parent.span_id if isinstance(parent, (Span, _NullSpan)) \
            else parent
        span = Span(name=name, span_id=self._next_id, t0=self.now(),
                    trace_id=trace_id, parent_id=pid, attrs=attrs)
        self._next_id += 1
        span = self._admit(span)
        real = isinstance(span, Span)
        if real:
            self._stack.append(span)
        try:
            yield span
        finally:
            if real:
                self._stack.pop()
                span.t1 = self.now()

    # -- reporting -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.spans)

    def n_events(self) -> int:
        return sum(1 for s in self.spans if s.kind == "event")

    def describe(self) -> dict:
        """The ``obs`` header block every benchmark artifact records:
        enabled flag, sample rate, span/event counts, drops."""
        n_ev = self.n_events()
        return {
            "enabled": True,
            "sample": self.sample_rate,
            "spans": len(self.spans) - n_ev,
            "events": n_ev,
            "dropped": self.dropped,
        }
