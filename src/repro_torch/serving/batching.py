"""Deadline-aware micro-batching: the request scheduler in front of the
engine.

The paper's throughput headline (~210 ms/image, Exp #5) comes from
batching: the lookup-table broadcast and the scan amortise over a big
batch. Online, nobody sends 12k-image batches — the *batcher* has to
manufacture them by coalescing the queue, trading a bounded wait for
amortisation. Under sustained load the queue, not the kernel, owns the
tail. Two schedulers attack that (the JAX package's, unchanged):

  * ``scheduler="edf"`` (default) — deadline-aware dispatch. Every
    request carries a priority class (``interactive`` / ``standard`` /
    ``batch``, see :mod:`repro_torch.serving.slo`); the pending set is ordered
    earliest-deadline-first within class, higher classes first. Each
    class owns its own coalescing budget (interactive holds briefly,
    batch holds long), and admission control sheds — or
    deadline-downgrades — incoming ``batch`` work once queue depth
    crosses the policy's fitted-cost-derived threshold, so bursts of
    bulk traffic cannot collapse the interactive tail.
  * ``scheduler="fifo"`` — the original arrival-order coalescing,
    kept bit-for-bit for comparison
    (``repro_torch.launch.serve --scheduler fifo``).

Scheduling never changes *what* a request returns: per-request results
are independent of batch composition (each query row routes and scans
independently; padding is masked), so the same trace replayed under
``fifo`` and ``edf`` yields bit-identical ids + distances per request.

Replay is a discrete-event simulation over a trace: *arrival times are
virtual* (from the trace), *compute times are real* (measured wall clock
of each engine dispatch / cache hit, synchronised on the card). That makes
latency percentiles honest about queueing + batching delay while staying
exactly reproducible in shape (same trace -> same batches) regardless of
host speed.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from collections import deque

import numpy as np

from repro_torch.obs import get_tracer
from repro_torch.serving.session import SearchSession
from repro_torch.serving.slo import SLOPolicy, class_rank
from repro_torch.serving.trace import Request


@dataclasses.dataclass
class Completion:
    """Terminal record of one request."""

    rid: int
    image_id: int
    arrival: float  # virtual seconds
    finish: float  # virtual seconds
    source: str  # "engine" | "cache" | "rejected" | "shed"
    ids: np.ndarray | None = None  # (rows, k) or None when dropped
    dists: np.ndarray | None = None
    priority: str = "standard"
    wait_ms: float = 0.0  # arrival -> dispatch (queueing + coalescing)
    compute_ms: float = 0.0  # dispatch -> finish (engine / cache work)

    @property
    def latency_ms(self) -> float:
        return (self.finish - self.arrival) * 1e3


class MicroBatcher:
    """Coalesce a request stream into bucket-sized engine dispatches.

    Args:
      session: the warmed :class:`~repro_torch.serving.SearchSession` (or
        sharded subclass) dispatches run on.
      max_wait_ms: base coalescing budget. FIFO applies it to the oldest
        pending request; EDF derives per-class budgets from it unless
        ``policy`` overrides them.
      max_queue: hard pending-request cap (backpressure) — arrivals
        beyond it are rejected under either scheduler.
      scheduler: ``"edf"`` (deadline-aware, the default) or ``"fifo"``
        (the original arrival-order coalescing, kept for comparability).
      policy: the :class:`~repro_torch.serving.slo.SLOPolicy` EDF enforces;
        defaults to :meth:`SLOPolicy.for_session`, which derives the
        batch-shedding depth from the session's fitted cost model (no
        shedding when the index carries no usable calibration).
      refresh_every: when > 0, call ``session.maybe_refresh()`` after
        every N engine dispatches — the read-during-write hook: a
        background writer's commits are
        adopted *between* batches, after the new snapshot's rungs are
        warmed, so no in-flight or queued request ever observes a
        half-adopted index. 0 (default) never refreshes: the session
        serves its pinned version for the whole trace.

    Raises:
      ValueError: an unknown ``scheduler``.
    """

    def __init__(
        self,
        session: SearchSession,
        *,
        max_wait_ms: float = 5.0,
        max_queue: int = 256,
        scheduler: str = "edf",
        policy: SLOPolicy | None = None,
        refresh_every: int = 0,
    ):
        if scheduler not in ("edf", "fifo"):
            raise ValueError(
                f"unknown scheduler {scheduler!r}; want edf|fifo"
            )
        self.session = session
        self.max_wait = float(max_wait_ms) / 1e3
        self.max_queue = int(max_queue)
        self.scheduler = scheduler
        self.refresh_every = int(refresh_every)
        self._dispatches = 0
        self.policy = policy if policy is not None else SLOPolicy.for_session(
            session, base_max_wait_ms=max_wait_ms,
        )

    def _after_dispatch(self) -> None:
        """Between-batch refresh point. Warmup cost lands in
        ``metrics.warmup_ms`` (not ``engine_ms``), so adopting a new
        index version never distorts the replay's virtual clock."""
        self._dispatches += 1
        if self.refresh_every and self._dispatches % self.refresh_every == 0:
            self.session.maybe_refresh()

    def run(self, requests: list[Request]) -> list[Completion]:
        """Replay a trace to completion; returns one Completion per
        request (in completion order) and fills ``session.metrics``."""
        if self.scheduler == "fifo":
            return self._run_fifo(requests)
        return self._run_edf(requests)

    # -- shared helpers ------------------------------------------------------

    def _try_cache(self, r: Request, now: float, done: list[Completion]
                   ) -> bool:
        """Serve ``r`` from the hot-leaf cache at admission if possible.
        A hit never occupies a queue slot, so it is served even under
        backpressure or shedding."""
        s = self.session
        m = s.metrics
        t0 = time.perf_counter()
        hit = s.cache.try_serve(r.queries, s.k)
        dt = time.perf_counter() - t0
        if hit is None:
            return False
        m.cache_images += 1
        m.requests += 1
        lat_start = max(now, r.arrival)
        wait_ms = (lat_start - r.arrival) * 1e3
        done.append(Completion(
            rid=r.rid, image_id=r.image_id, arrival=r.arrival,
            finish=lat_start + dt, source="cache",
            ids=hit[0], dists=hit[1], priority=r.priority,
            wait_ms=wait_ms, compute_ms=dt * 1e3,
        ))
        m.observe_latency(
            r.priority, wait_ms=wait_ms, compute_ms=dt * 1e3,
            deadline_ms=self.policy.deadlines_ms.get(r.priority),
        )
        tr = get_tracer()
        if tr.enabled and tr.sampled(r.rid):
            finish = lat_start + dt
            req = tr.add_span(
                "request", r.arrival, finish, trace_id=r.rid,
                priority=r.priority, source="cache", rows=r.rows,
                cache_hit=True,
            )
            tr.add_span("queue.wait", r.arrival, lat_start,
                        trace_id=r.rid, parent=req)
            comp = tr.add_span("compute", lat_start, finish,
                               trace_id=r.rid, parent=req, source="cache")
            tr.add_span("cache.lookup", lat_start, finish,
                        trace_id=r.rid, parent=comp, hit=True)
        return True

    def _dispatch(self, batch: list[Request], now: float,
                  done: list[Completion]) -> float:
        """Run one coalesced batch; returns the new virtual ``now``
        (advanced by the measured engine wall time) after appending one
        engine Completion per request."""
        s = self.session
        m = s.metrics
        tr = get_tracer()
        busy0 = m.engine_ms
        dispatch_t = now
        # pin the tracer's clock to virtual time for the dispatch, so the
        # session's wall-measured spans (engine.execute, shard.scan, ...)
        # land at the dispatch's virtual timestamp on one timeline
        with tr.timebase(dispatch_t):
            if batch[0].rows > s.max_batch_rows:
                # a single request bigger than the top bucket:
                # session.search splits it across dispatches (it can
                # never coalesce anyway)
                ids, dists = s.search(batch[0].queries, n_images=1)
                results = [(ids, dists)]
            else:
                results = s.serve_many([r.queries for r in batch])
        # advance the virtual clock by the measured engine wall time
        now += (m.engine_ms - busy0) * 1e-3
        compute_ms = (now - dispatch_t) * 1e3
        rows = sum(r.rows for r in batch)
        dsp = None
        if tr.enabled:
            # one engine span fanning in the batch's request spans
            dsp = tr.add_span(
                "engine.dispatch", dispatch_t, now,
                n_requests=len(batch), rows=rows,
                rids=[r.rid for r in batch],
            )
        for r, (ids, dists) in zip(batch, results):
            m.requests += 1
            wait_ms = (dispatch_t - r.arrival) * 1e3
            done.append(Completion(
                rid=r.rid, image_id=r.image_id, arrival=r.arrival,
                finish=now, source="engine", ids=ids, dists=dists,
                priority=r.priority, wait_ms=wait_ms, compute_ms=compute_ms,
            ))
            m.observe_latency(
                r.priority, wait_ms=wait_ms, compute_ms=compute_ms,
                deadline_ms=self.policy.deadlines_ms.get(r.priority),
            )
            if tr.enabled and tr.sampled(r.rid):
                req = tr.add_span(
                    "request", r.arrival, now, trace_id=r.rid,
                    priority=r.priority, source="engine", rows=r.rows,
                    cache_hit=False, dispatch_id=dsp.span_id,
                )
                tr.add_span("queue.wait", r.arrival, dispatch_t,
                            trace_id=r.rid, parent=req)
                tr.add_span("compute", dispatch_t, now, trace_id=r.rid,
                            parent=req, source="engine",
                            dispatch_id=dsp.span_id)
        return now

    # -- fifo: the original arrival-order coalescing -------------------------

    def _run_fifo(self, requests: list[Request]) -> list[Completion]:
        s = self.session
        m = s.metrics
        todo = sorted(requests, key=lambda r: (r.arrival, r.rid))
        i = 0
        now = 0.0
        pending: deque[Request] = deque()
        rows_pending = 0  # running row count of `pending`
        done: list[Completion] = []

        def admit(until: float):
            nonlocal i, rows_pending
            while i < len(todo) and todo[i].arrival <= until + 1e-12:
                r = todo[i]
                i += 1
                # cache first: a hit never occupies a queue slot, so it is
                # served even under backpressure
                if self._try_cache(r, now, done):
                    continue
                if len(pending) >= self.max_queue:
                    m.observe_drop(r.priority, "rejected")
                    get_tracer().event(
                        "admission.rejected", t=r.arrival, trace_id=r.rid,
                        priority=r.priority, queue_depth=len(pending),
                    )
                    done.append(Completion(
                        rid=r.rid, image_id=r.image_id, arrival=r.arrival,
                        finish=r.arrival, source="rejected",
                        priority=r.priority,
                    ))
                    continue
                pending.append(r)
                rows_pending += r.rows

        while i < len(todo) or pending:
            if not pending:
                now = max(now, todo[i].arrival)
            admit(now)
            if not pending:
                continue
            deadline = pending[0].arrival + self.max_wait
            if rows_pending < s.max_batch_rows and now < deadline and i < len(todo):
                # wait for more coalescing: hop to the next event
                now = min(deadline, todo[i].arrival)
                admit(now)
                if rows_pending < s.max_batch_rows and now < deadline:
                    continue
            # ---- dispatch: fill up to the largest bucket ----------------
            m.observe_queue_depth(len(pending))
            batch: list[Request] = [pending.popleft()]
            rows = batch[0].rows
            while pending and rows + pending[0].rows <= s.max_batch_rows:
                r = pending.popleft()
                batch.append(r)
                rows += r.rows
            rows_pending -= rows
            now = self._dispatch(batch, now, done)
            self._after_dispatch()
        s.steady_state_recompiles()
        return done

    # -- edf: deadline-aware scheduling with admission control ---------------

    def _run_edf(self, requests: list[Request]) -> list[Completion]:
        s = self.session
        m = s.metrics
        policy = self.policy
        todo = sorted(requests, key=lambda r: (r.arrival, r.rid))
        i = 0
        now = 0.0
        # heap entries: (class rank, effective deadline, rid, request) —
        # earliest-deadline-first within class, higher classes first
        heap: list[tuple] = []
        rows_pending = 0
        done: list[Completion] = []

        def admit(until: float):
            nonlocal i, rows_pending
            while i < len(todo) and todo[i].arrival <= until + 1e-12:
                r = todo[i]
                i += 1
                if self._try_cache(r, now, done):
                    continue
                deadline_t = r.arrival + policy.deadline_s(r.priority)
                # admission control: past the fitted-cost-derived depth,
                # queued work alone already exceeds the batch deadline —
                # shed (or deadline-downgrade) incoming batch work rather
                # than let it lengthen every class's queue
                if (policy.shed_depth is not None
                        and r.priority == "batch"
                        and len(heap) >= policy.shed_depth):
                    if policy.on_overload == "shed":
                        m.observe_drop(r.priority, "shed")
                        get_tracer().event(
                            "admission.shed", t=r.arrival, trace_id=r.rid,
                            priority=r.priority, queue_depth=len(heap),
                        )
                        done.append(Completion(
                            rid=r.rid, image_id=r.image_id,
                            arrival=r.arrival, finish=r.arrival,
                            source="shed", priority=r.priority,
                        ))
                        continue
                    m.downgraded += 1
                    get_tracer().event(
                        "admission.downgraded", t=r.arrival,
                        trace_id=r.rid, priority=r.priority,
                        queue_depth=len(heap),
                    )
                    deadline_t += policy.deadline_s("batch")
                if len(heap) >= self.max_queue:
                    m.observe_drop(r.priority, "rejected")
                    get_tracer().event(
                        "admission.rejected", t=r.arrival, trace_id=r.rid,
                        priority=r.priority, queue_depth=len(heap),
                    )
                    done.append(Completion(
                        rid=r.rid, image_id=r.image_id, arrival=r.arrival,
                        finish=r.arrival, source="rejected",
                        priority=r.priority,
                    ))
                    continue
                heapq.heappush(
                    heap, (class_rank(r.priority), deadline_t, r.rid, r)
                )
                rows_pending += r.rows

        while i < len(todo) or heap:
            if not heap:
                now = max(now, todo[i].arrival)
            admit(now)
            if not heap:
                continue
            head = heap[0][3]
            # the head's class decides how long the batcher may hold the
            # queue open to coalesce — interactive holds briefly, batch
            # holds long
            hold = head.arrival + policy.max_wait_s(head.priority)
            if rows_pending < s.max_batch_rows and now < hold and i < len(todo):
                now = min(hold, todo[i].arrival)
                admit(now)
                if rows_pending < s.max_batch_rows and now < hold:
                    continue  # head may have changed: re-evaluate
            # ---- dispatch: fill the bucket in (class, deadline) order ---
            m.observe_queue_depth(len(heap))
            batch: list[Request] = [heapq.heappop(heap)[3]]
            rows = batch[0].rows
            while heap and rows + heap[0][3].rows <= s.max_batch_rows:
                r = heapq.heappop(heap)[3]
                batch.append(r)
                rows += r.rows
            rows_pending -= rows
            now = self._dispatch(batch, now, done)
            self._after_dispatch()
        s.steady_state_recompiles()
        return done
