"""Trace-driven load generation for the serving layer.

A *trace* is the replayable description of a workload: which image each
request queries and when it arrives (``repro_torch.data.synth.sample_trace`` —
uniform or Zipf-skewed popularity, Poisson or all-at-once arrivals,
deterministic under a seed). This module turns a trace into concrete
:class:`Request` objects: a request is one query image, i.e. its
``desc_per_image`` descriptor rows read from the corpus store
(``read_rows`` — only the containing blocks are touched) and perturbed
with noise seeded *by image id*, so a repeated image is the same photo with
the same descriptors — exactly the repetition the hot-leaf cache exploits.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data import synth


@dataclasses.dataclass
class Request:
    """One in-flight search request: a query image's descriptor rows.

    ``priority`` is one of :data:`repro_torch.serving.slo.PRIORITY_CLASSES`
    (``interactive`` / ``standard`` / ``batch``) — the scheduling class
    the micro-batcher's EDF dispatch and admission control key on. It
    never affects *what* the request returns, only when it runs.
    """

    rid: int
    image_id: int
    arrival: float  # seconds since trace start
    queries: np.ndarray  # (desc_per_image, dim) float32
    priority: str = "standard"

    @property
    def rows(self) -> int:
        return self.queries.shape[0]


@dataclasses.dataclass(frozen=True)
class TenantClass:
    """One tenant population in a multi-tenant trace.

    Args:
      priority: the scheduling class its requests carry.
      n_requests: how many requests this tenant contributes.
      rate: mean arrival rate in requests/second.
      skew: ``"uniform"`` or ``"zipf"`` image popularity.
      zipf_s: per-class Zipf exponent (each tenant has its own hot set).
      burst_factor: >= 1. 1 = steady Poisson; B > 1 concentrates all
        arrivals into the first ``1/B`` of every ``burst_period_s``
        window at ``B x rate`` (an on/off modulated Poisson process), so
        the *mean* rate — the offered load — is unchanged.
      burst_period_s: length of one on/off window.
    """

    priority: str
    n_requests: int
    rate: float
    skew: str = "zipf"
    zipf_s: float = 1.1
    burst_factor: float = 1.0
    burst_period_s: float = 1.0

    def __post_init__(self):
        from repro_torch.serving.slo import class_rank

        class_rank(self.priority)  # raises on an unknown class
        if self.burst_factor < 1.0:
            raise ValueError(f"burst_factor={self.burst_factor} must be >= 1")
        if self.rate <= 0:
            raise ValueError(f"rate={self.rate} must be > 0")

    def arrivals(self, rng: np.random.Generator) -> np.ndarray:
        """Deterministic arrival times (seconds, sorted) for this tenant."""
        gaps = rng.exponential(
            1.0 / (self.rate * self.burst_factor), size=self.n_requests
        )
        on_time = np.cumsum(gaps)
        if self.burst_factor == 1.0:
            return on_time
        # map "on-clock" time to wall time: each window of burst_period_s
        # wall seconds is active only for its first on_len seconds
        on_len = self.burst_period_s / self.burst_factor
        window = np.floor(on_time / on_len)
        return window * self.burst_period_s + (on_time - window * on_len)


class TraceLoadGenerator:
    """Materialise query vectors for a (image_ids, arrivals) trace.

    ``corpus`` is either a block store (anything with ``read_rows``/``dim``:
    :class:`~repro_torch.data.store.DescriptorStore` or ``VirtualStore``) or a
    resident ``(rows, dim)`` array. Image ``i`` owns descriptor rows
    ``[i * desc_per_image, (i+1) * desc_per_image)`` — the
    ``synth.sample_images`` layout, which persisted corpora keep.
    """

    def __init__(self, corpus, desc_per_image: int, *, noise: float = 4.0,
                 seed: int = 0):
        self.corpus = corpus
        self.desc_per_image = int(desc_per_image)
        self.noise = float(noise)
        self.seed = int(seed)

    def _read_rows(self, rows: np.ndarray) -> np.ndarray:
        if isinstance(self.corpus, np.ndarray):
            return self.corpus[rows]
        return self.corpus.read_rows(rows)

    def query_image(self, image_id: int) -> np.ndarray:
        """The (deterministic) query descriptors for one image."""
        dpi = self.desc_per_image
        rows = image_id * dpi + np.arange(dpi, dtype=np.int64)
        vecs = np.asarray(self._read_rows(rows), np.float32)
        rng = np.random.default_rng((self.seed, int(image_id)))
        q = vecs + rng.standard_normal(vecs.shape).astype(np.float32) * self.noise
        return np.clip(q, 0.0, 255.0)

    def requests(
        self, image_ids: np.ndarray, arrivals: np.ndarray
    ) -> list[Request]:
        return [
            Request(rid=r, image_id=int(img), arrival=float(t),
                    queries=self.query_image(int(img)))
            for r, (img, t) in enumerate(zip(image_ids, arrivals))
        ]

    def from_trace(
        self,
        n_requests: int,
        n_images: int,
        *,
        skew: str = "uniform",
        zipf_s: float = 1.1,
        rate: float | None = None,
        seed: int | None = None,
    ) -> list[Request]:
        """Sample a trace and materialise it in one step."""
        image_ids, arrivals = synth.sample_trace(
            n_requests, n_images, skew=skew, zipf_s=zipf_s, rate=rate,
            seed=self.seed if seed is None else seed,
        )
        return self.requests(image_ids, arrivals)

    def multi_tenant(
        self,
        classes,
        n_images: int,
        *,
        seed: int | None = None,
    ) -> list[Request]:
        """Materialise a multi-tenant trace: several :class:`TenantClass`
        populations (each with its own rate, burstiness, and Zipf skew)
        merged into one arrival-ordered request stream.

        Deterministic under ``seed``: each class draws from its own rng
        stream (``(seed, class index)``), so adding a class never
        perturbs the others' arrivals or image picks. Request ids are
        assigned in arrival order; ties break by class rank then class
        index so the merge itself is deterministic.

        Args:
          classes: a sequence of :class:`TenantClass`.
          n_images: the corpus image count every class draws ids from.

        Returns:
          One :class:`Request` list sorted by arrival, each request
          stamped with its tenant's ``priority``.
        """
        from repro_torch.serving.slo import class_rank

        seed = self.seed if seed is None else int(seed)
        merged = []
        for ci, tc in enumerate(classes):
            # independent, collision-free streams: one for the image ids
            # (inside sample_trace), one for the arrival process
            image_ids, _ = synth.sample_trace(
                tc.n_requests, n_images, skew=tc.skew, zipf_s=tc.zipf_s,
                rate=None, seed=np.random.SeedSequence([seed, 2 * ci]),
            )
            rng = np.random.default_rng(
                np.random.SeedSequence([seed, 2 * ci + 1])
            )
            arrivals = tc.arrivals(rng)
            for img, t in zip(image_ids, arrivals):
                merged.append(
                    (float(t), class_rank(tc.priority), ci, int(img), tc)
                )
        merged.sort(key=lambda e: e[:3])
        return [
            Request(rid=r, image_id=img, arrival=t,
                    queries=self.query_image(img), priority=tc.priority)
            for r, (t, _rank, _ci, img, tc) in enumerate(merged)
        ]


def default_tenant_mix(
    n_requests: int,
    *,
    rate: float = 100.0,
    interactive_frac: float = 0.4,
    standard_frac: float = 0.3,
    burst_factor: float = 8.0,
) -> tuple[TenantClass, ...]:
    """The stock bursty+steady multi-tenant mix (``--trace multi``):
    steady ``interactive`` traffic with a hot Zipf working set, steady
    ``standard`` traffic, and heavily bursty ``batch`` traffic (same mean
    offered rate per request, arrivals concentrated ``burst_factor``-fold)
    — the workload whose queueing collapses a FIFO tail."""
    n_int = int(n_requests * interactive_frac)
    n_std = int(n_requests * standard_frac)
    n_bat = n_requests - n_int - n_std
    share = float(rate) / max(1, n_requests)
    return (
        TenantClass("interactive", n_int, rate=max(1e-6, share * n_int),
                    skew="zipf", zipf_s=1.3),
        TenantClass("standard", n_std, rate=max(1e-6, share * n_std),
                    skew="zipf", zipf_s=1.1),
        TenantClass("batch", n_bat, rate=max(1e-6, share * n_bat),
                    skew="uniform", burst_factor=burst_factor,
                    burst_period_s=1.0),
    )
