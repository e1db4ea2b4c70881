"""Pluggable cost models: what ``plan()`` consults to pick layouts/budgets.

The JAX package's cost-model subsystem, ported as it is (it has no JAX in
it): a :class:`CostModel` interface with three implementations, plus the
durable :class:`CalibrationStore` they share.

  * :class:`HeuristicModel` -- first-order shape rules (distance pairs +
    carry traffic). Always decides.
  * :class:`ObservedModel` -- exact-signature measured ms/image: decides
    only when *every* candidate plan has been measured under its exact
    plan signature.
  * :class:`FittedModel` -- least-squares fits, per layout, the parametric
    cost ``ms ~ a*(rows_scanned/tile) + b*probes*leaves + c*batch + d``
    from all recorded observations. Slope coefficients are clamped >= 0.

``resolve_model("auto", store)`` builds the default fallback chain
**fitted > observed > heuristic**. A model only ever picks layouts and
budgets -- it never alters search results.

Calibration is keyed by *backend*. A store belongs to one backend
(:func:`backend_name`: ``"cpu"``, or ``"cuda:<device name>"``) and
consults only records of its own backend. Records and tile configs of
another backend, or with no marker (every record the JAX package writes:
CPU or TPU timings), are carried through ``to_json`` unchanged and never
steer a plan here. The marker rides folded into a string of the key that
the JAX package keeps whole and never matches against its own plans: a
record's ``impl`` (``"xla@cuda:<device name>"``) and a tile config's
dtype (``"float32@cpu"``). Its ``from_json`` keys records by (signature,
shapes), so a record of each package under one plan signature and shapes
stays two records through its rewrite of a manifest, and its planner
fits, consults and looks up by the bare ``impl`` and dtype names, so it
never reads the port's. The markers that earlier versions of the port
wrote are still read: a ``backend`` key inside a record's ``stats`` or
beside its ``signature``, and beside a tile config's ``block_rows``.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

LAYOUTS = ("point_major", "query_routed", "scan_codes")
DENSE_LAYOUTS = ("point_major", "query_routed")


#: every field of a plan that shapes its cost (and its signature key)
SIGNATURE_FIELDS = (
    "layout", "k", "probes", "impl", "block_rows", "q_cap", "q_tile", "p_cap",
)

MODEL_KINDS = ("auto", "heuristic", "observed", "fitted")

#: format 2 added record timestamps (decay windowing) and the autotuned
#: tile-config blob; ``from_json`` still accepts format-1 payloads
#: (legacy records load as fresh — better to trust an undated measurement
#: than to discard the only calibration an old manifest has)
CALIBRATION_FORMAT = 2

#: the FittedModel's parametric form - the single source the benchmark
#: artifacts quote (keep in lockstep with FittedModel.features)
FIT_FORM = "ms ~ a*(rows_scanned/tile) + b*probes*leaves + c*batch + d"

#: exponential-decay half-life for calibration records: a measurement
#: ``age`` seconds old carries weight ``0.5 ** (age / half_life)`` in the
#: fitted model, so ms/image measured on a previous impl/hardware stops
#: steering ``plan(model="auto")`` as fresh measurements accumulate
CALIBRATION_HALF_LIFE_S = 7 * 24 * 3600.0

#: records older than this many half-lives are dropped outright (from
#: fits, exact-signature consults, and tuned tile configs) — their weight
#: would be < 0.4% anyway, and a lone stale record must not decide alone
CALIBRATION_MAX_AGE_HALF_LIVES = 8.0


def backend_name(device=None) -> str:
    """The backend a measurement on ``device`` belongs to: ``"cpu"``, or
    ``"cuda:<torch.cuda.get_device_name>"``. ``None``: the card when one
    is present, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return dev.type


#: joins a key string (a record's impl, a tile config's dtype) and the
#: backend in the manifest
MARK = "@"
#: the signature's field that carries a record's backend in the manifest
MARKED_FIELD = SIGNATURE_FIELDS.index("impl")


def split_marked(name: str) -> tuple[str, str | None]:
    """A manifest key string as ``(name, backend)``: ``"float32@cpu"`` ->
    ``("float32", "cpu")``; a bare ``"xla"`` or ``"float32"`` (the JAX
    package's, or an earlier port's) -> (the name, ``None``)."""
    bare, mark, backend = name.partition(MARK)
    return bare, (backend if mark else None)


def _age_weight(ts: float, now: float) -> float:
    """Exponential-window weight of a record last touched at ``ts``."""
    age = max(0.0, now - ts)
    return 0.5 ** (age / CALIBRATION_HALF_LIFE_S)


def _is_stale(ts: float, now: float) -> bool:
    return (now - ts) > CALIBRATION_MAX_AGE_HALF_LIVES * CALIBRATION_HALF_LIFE_S


def plan_signature(plan) -> tuple:
    """The cost-relevant identity of a resolved plan (hashable)."""
    return tuple(getattr(plan, f) for f in SIGNATURE_FIELDS)


def signature_key(sig: tuple) -> str:
    """Stable string form of a plan signature (JSON dict key)."""
    layout, k, probes, impl, block_rows, q_cap, q_tile, p_cap = sig
    return (
        f"{layout}/k={k}/probes={probes}/impl={impl}/"
        f"block_rows={block_rows}/q_cap={q_cap}/"
        f"q_tile={q_tile}/p_cap={p_cap}"
    )


@dataclasses.dataclass(frozen=True)
class PlanShapes:
    """The index/query shapes a plan decision (or measurement) was taken
    at — the features the fitted model generalizes over.

    Args:
      rows: padded index rows the plan scans (summed over shards).
      n_queries: query rows per batch, pre-probe-expansion.
      n_shards: device row-shards the scan splits over.
      n_leaves: vocabulary-tree leaf count.
      dim: descriptor dimension (0 = unknown, legacy records) — what the
        compressed-codes pricing compares code bytes/row against.
    """

    rows: int
    n_queries: int
    n_shards: int = 1
    n_leaves: int = 1
    dim: int = 0

    def to_json(self) -> dict:
        return {
            "rows": int(self.rows),
            "n_queries": int(self.n_queries),
            "n_shards": int(self.n_shards),
            "n_leaves": int(self.n_leaves),
            "dim": int(self.dim),
        }

    @classmethod
    def from_json(cls, d: dict) -> "PlanShapes":
        return cls(
            rows=int(d["rows"]),
            n_queries=int(d["n_queries"]),
            n_shards=int(d.get("n_shards", 1)),
            n_leaves=int(d.get("n_leaves", 1)),
            dim=int(d.get("dim", 0)),
        )


class CalibrationStore:
    """Measured ms/image per plan signature — the durable calibration data.

    One store per :class:`repro_torch.index.Index` (persisted in the
    manifest); a module-level default serves index-less callers. Records
    fold into per-signature running stats; when the recorder supplies
    :class:`PlanShapes`, the observation also feeds the fitted model.
    The ``dirty`` flag tells ``Index.commit`` a manifest bump is due.

    ``backend`` (default :func:`backend_name` of the card or the CPU) is
    the only backend whose records the store consults; the others ride
    along in ``_carried`` / ``_carried_tiles`` as the JSON they came in.
    """

    def __init__(self, backend: str | None = None):
        self.backend = backend if backend is not None else backend_name()
        # records and tile configs of other backends (or of none): the
        # manifest JSON as read, written back unchanged, never consulted
        self._carried: list[dict] = []
        self._carried_tiles: list[dict] = []
        # keyed by (signature, shapes-or-None): a plan signature embeds
        # the index/query shapes only when its budgets were derived from
        # them — pinned or snap-coincident budgets produce the same
        # signature at different corpus sizes, and those measurements
        # must stay distinct for the fit
        self._records: dict[tuple, dict] = {}
        # autotuned fused-kernel tile configs keyed (layout, dim, dtype):
        # the winning block size per shape class (benchmarks/block_size.py)
        self._tile_configs: dict[tuple, dict] = {}
        self._dirty = False
        self._seq = 0  # bumps on every mutation; also the fit-cache key
        self._fit_cache: dict[int, tuple[int, dict]] = {}
        # a recorder may run between dispatches while a writer thread's
        # commit serializes the store into the manifest
        # guard every dict mutation/iteration
        self._mu = threading.RLock()

    @staticmethod
    def _key(plan, shapes: PlanShapes | None) -> tuple:
        return (
            plan_signature(plan),
            dataclasses.astuple(shapes) if shapes is not None else None,
        )

    # -- recording ----------------------------------------------------------
    def record(self, plan, ms_per_image: float,
               shapes: PlanShapes | None = None, *,
               ts: float | None = None) -> None:
        """Fold one measured ms/image into ``plan``'s running stats.

        Args:
          plan: the resolved ``SearchPlan`` that executed.
          ms_per_image: measured engine milliseconds per image.
          shapes: the shapes the measurement was taken at; required for
            the observation to participate in the fitted model.
          ts: measurement wall-clock (``time.time()``); defaults to now.
            The record's timestamp drives the exponential decay window —
            stale measurements stop steering ``plan(model="auto")``
            (tests back-date records through this).
        """
        ms = float(ms_per_image)
        ts = time.time() if ts is None else float(ts)
        with self._mu:
            o = self._records.setdefault(
                self._key(plan, shapes),
                {"count": 0, "total_ms": 0.0, "min_ms": ms, "max_ms": ms,
                 "last_ms": ms, "ts": ts,
                 "shapes": shapes.to_json() if shapes is not None else None},
            )
            o["count"] += 1
            o["total_ms"] += ms
            o["min_ms"] = min(o["min_ms"], ms)
            o["max_ms"] = max(o["max_ms"], ms)
            o["last_ms"] = ms
            o["ts"] = max(float(o.get("ts", ts)), ts)
            self._seq += 1
            o["seq"] = self._seq
            self._dirty = True
        from repro_torch.obs import get_registry

        get_registry().counter("calibration.records").inc()

    def record_tile_config(self, layout: str, dim: int, dtype: str,
                           block_rows: int, ms: float, *,
                           ts: float | None = None) -> None:
        """Persist the autotuned fused-scan block size for a shape class.

        Keyed ``(layout, dim, dtype)`` — the axes the winning tile
        actually varies over. ``plan()`` consults this when budgeting a
        fused candidate (unless the caller pinned ``block_rows``); the
        sweep in ``benchmarks/block_size.py`` writes it.
        """
        ts = time.time() if ts is None else float(ts)
        with self._mu:
            self._tile_configs[(str(layout), int(dim), str(dtype))] = {
                "block_rows": int(block_rows), "ms": float(ms), "ts": ts,
            }
            self._seq += 1
            self._dirty = True

    def tile_config(self, layout: str, dim: int, dtype: str) -> dict | None:
        """The tuned ``{"block_rows", "ms", "ts"}`` for a shape class, or
        ``None`` when never tuned (or tuned too long ago — stale tiles
        age out on the same window as measurements)."""
        with self._mu:
            cfg = self._tile_configs.get((str(layout), int(dim), str(dtype)))
            if cfg is None or _is_stale(cfg["ts"], time.time()):
                return None
            return dict(cfg)

    def merge(self, other: "CalibrationStore") -> None:
        """Fold another store's records into this one (stats summed,
        timestamps and tile configs newest-wins). Raises on a store of
        another backend, whose records this one must not consult."""
        if other.backend != self.backend:
            raise ValueError(f"cannot merge {other.backend!r} calibration "
                             f"into a {self.backend!r} store")
        with self._mu, other._mu:
            for raw in other._carried:
                if raw not in self._carried:
                    self._carried.append(raw)
            for raw in other._carried_tiles:
                if raw not in self._carried_tiles:
                    self._carried_tiles.append(raw)
            now = time.time()
            for key, o in other._records.items():
                mine = self._records.get(key)
                if mine is None:
                    self._seq += 1
                    self._records[key] = dict(o, seq=self._seq)
                else:
                    mine["count"] += o["count"]
                    mine["total_ms"] += o["total_ms"]
                    mine["min_ms"] = min(mine["min_ms"], o["min_ms"])
                    mine["max_ms"] = max(mine["max_ms"], o["max_ms"])
                    mine["last_ms"] = o["last_ms"]
                    mine["ts"] = max(float(mine.get("ts", now)),
                                     float(o.get("ts", now)))
                    self._seq += 1
                    mine["seq"] = self._seq
            for key, cfg in other._tile_configs.items():
                mine = self._tile_configs.get(key)
                if mine is None or cfg["ts"] >= mine["ts"]:
                    self._tile_configs[key] = dict(cfg)
                    self._seq += 1
            if len(other) or other._tile_configs:
                self._dirty = True

    def clear(self) -> None:
        with self._mu:
            if (self._records or self._tile_configs or self._carried
                    or self._carried_tiles):
                self._dirty = True
            self._records.clear()
            self._tile_configs.clear()
            self._carried.clear()
            self._carried_tiles.clear()
            self._seq += 1  # invalidate cached fits

    # -- consultation -------------------------------------------------------
    def lookup(self, plan) -> dict | None:
        """Aggregated running stats recorded under ``plan``'s exact
        signature (folded across the shapes it was measured at)."""
        sig = plan_signature(plan)
        with self._mu:
            return self._aggregate(
                [o for (s, _), o in self._records.items() if s == sig]
            )

    @staticmethod
    def _aggregate(entries) -> dict | None:
        if not entries:
            return None
        latest = max(entries, key=lambda o: o.get("seq", 0))
        return {
            "count": sum(o["count"] for o in entries),
            "total_ms": sum(o["total_ms"] for o in entries),
            "min_ms": min(o["min_ms"] for o in entries),
            "max_ms": max(o["max_ms"] for o in entries),
            "last_ms": latest["last_ms"],
        }

    def mean_ms(self, plan,
                shapes: PlanShapes | None = None) -> float | None:
        """Mean measured ms/image for ``plan``.

        With ``shapes``, only a measurement taken at exactly those shapes
        (or a legacy shape-less record) counts — a pinned budget can
        produce the same plan signature at very different corpus sizes,
        and those measurements must not rank layouts for each other
        (generalizing across shapes is the *fitted* model's job). Without
        ``shapes``, aggregates across everything recorded under the
        signature (the legacy consult/reporting behaviour).
        """
        if shapes is not None:
            o = self._records.get(self._key(plan, shapes))
            if o is None:
                o = self._records.get(self._key(plan, None))
            if o is None or _is_stale(o.get("ts", time.time()), time.time()):
                return None
            return o["total_ms"] / max(1, o["count"])
        o = self.lookup(plan)
        if o is None:
            return None
        return o["total_ms"] / max(1, o["count"])

    def layouts(self) -> set:
        """The layouts with at least one recorded measurement."""
        with self._mu:
            return {sig[0] for (sig, _) in self._records}

    def fit_rows(self) -> list[tuple[tuple, dict, PlanShapes]]:
        """Observations usable by the fit: ``(signature, stats, shapes)``
        for every record that carries shapes and is inside the decay
        window (stale records are dropped; fresher ones are further
        down-weighted by age inside :class:`FittedModel`)."""
        out = []
        now = time.time()
        with self._mu:
            for (sig, _), o in self._records.items():
                if not o.get("shapes"):
                    continue
                if _is_stale(o.get("ts", now), now):
                    continue
                out.append((sig, dict(o), PlanShapes.from_json(o["shapes"])))
        return out

    def __len__(self) -> int:
        """Distinct records of this store's backend (the ones consulted)."""
        return len(self._records)

    @property
    def n_tile_configs(self) -> int:
        """Tile configs of this store's backend."""
        return len(self._tile_configs)

    @property
    def n_carried(self) -> int:
        """Records and tile configs of other backends, carried unread."""
        return len(self._carried) + len(self._carried_tiles)

    # -- persistence --------------------------------------------------------
    @property
    def dirty(self) -> bool:
        """True when records changed since the last :meth:`mark_clean`."""
        return self._dirty

    def mark_clean(self) -> None:
        self._dirty = False

    def snapshot(self) -> dict[str, dict]:
        """JSON-ready view: signature key -> aggregated stats with a
        derived ``mean_ms`` (and the shapes measured under, when any)."""
        by_sig: dict[tuple, list[dict]] = {}
        with self._mu:
            for (sig, _), o in self._records.items():
                by_sig.setdefault(sig, []).append(dict(o))
        out = {}
        for sig, entries in by_sig.items():
            agg = self._aggregate(entries)
            agg["mean_ms"] = agg["total_ms"] / max(1, agg["count"])
            measured_at = [o["shapes"] for o in entries if o.get("shapes")]
            if measured_at:
                agg["shapes"] = measured_at
            out[signature_key(sig)] = agg
        return out

    def to_json(self) -> dict:
        """Versioned manifest payload (``calibration`` field): the JAX
        package's, with the backend folded into each record's ``impl``
        (``"xla@cpu"``) and each tile config's dtype (``"float32@cpu"``),
        key strings that the JAX package keeps whole; carried records
        follow, unchanged."""
        with self._mu:
            return {
                "format": CALIBRATION_FORMAT,
                "records": [
                    {"signature": [f"{v}{MARK}{self.backend}"
                                   if i == MARKED_FIELD else v
                                   for i, v in enumerate(sig)],
                     "stats": {k: v for k, v in o.items()
                               if k not in ("shapes", "seq")},
                     "shapes": o.get("shapes")}
                    for (sig, _), o in self._records.items()
                ] + [dict(r) for r in self._carried],
                "tile_configs": [
                    {"layout": layout, "dim": dim,
                     "dtype": f"{dtype}{MARK}{self.backend}", **cfg}
                    for (layout, dim, dtype), cfg
                    in self._tile_configs.items()
                ] + [dict(c) for c in self._carried_tiles],
            }

    @classmethod
    def from_json(cls, d: dict | None,
                  backend: str | None = None) -> "CalibrationStore":
        """The store of ``backend`` (default :func:`backend_name`) over a
        manifest payload: records and tile configs whose ``backend`` is
        another, or absent, are carried, not consulted. A record's marker
        is read from its ``impl`` (``"xla@cpu"``), or from a ``backend``
        key inside its ``stats`` or beside its ``signature``, where earlier
        versions of the port wrote it; a tile config's from its dtype
        (``"float32@cpu"``), or from a ``backend`` key beside it."""
        store = cls(backend)
        now = time.time()
        for rec in (d or {}).get("records", []):
            o = dict(rec["stats"])
            sig = list(rec["signature"])
            impl, marked = split_marked(str(sig[MARKED_FIELD]))
            earlier = o.pop("backend", rec.get("backend"))
            if (marked or earlier) != store.backend:
                store._carried.append(dict(rec))
                continue
            sig[MARKED_FIELD] = impl
            sig = tuple(sig)
            # format-1 records carry no timestamp: load them as fresh —
            # an undated measurement beats no calibration, and it ages
            # out on the normal window from here
            o["ts"] = float(o.get("ts", now))
            o["shapes"] = rec.get("shapes")
            shapes_key = (
                dataclasses.astuple(PlanShapes.from_json(o["shapes"]))
                if o["shapes"] else None
            )
            store._seq += 1
            o["seq"] = store._seq
            store._records[(sig, shapes_key)] = o
        for cfg in (d or {}).get("tile_configs", []):
            dtype, backend = split_marked(str(cfg["dtype"]))
            if (backend or cfg.get("backend")) != store.backend:
                store._carried_tiles.append(dict(cfg))
                continue
            key = (str(cfg["layout"]), int(cfg["dim"]), dtype)
            store._tile_configs[key] = {
                "block_rows": int(cfg["block_rows"]),
                "ms": float(cfg.get("ms", 0.0)),
                "ts": float(cfg.get("ts", now)),
            }
            store._seq += 1
        return store


# ---------------------------------------------------------------------------
# module-level default store: index-less callers (plan() without a store).
# Index-scoped planning uses Index.calibration instead.
# ---------------------------------------------------------------------------

_DEFAULT_STORE: CalibrationStore | None = None


def default_calibration() -> CalibrationStore:
    """The process-wide fallback store (index-less callers), made on first
    use for the card when one is present, else the CPU."""
    global _DEFAULT_STORE
    if _DEFAULT_STORE is None:
        _DEFAULT_STORE = CalibrationStore()
    return _DEFAULT_STORE


def reset_default_calibration() -> None:
    """Clear the module default store (tests, fresh processes)."""
    store = default_calibration()
    store.clear()
    store.mark_clean()


def record_observation(plan, ms_per_image: float,
                       shapes: PlanShapes | None = None) -> None:
    """Fold one measured ms/image into the *default* store (index-less
    callers; index-scoped recording goes through ``Index.calibration``)."""
    default_calibration().record(plan, ms_per_image, shapes)


def observations() -> dict[str, dict]:
    """JSON-ready snapshot of the default store."""
    return default_calibration().snapshot()


def reset_observations() -> None:
    """Clear the default store (alias of :func:`reset_default_calibration`)."""
    reset_default_calibration()


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


class CostModel:
    """Interface: predict a plan's cost at given shapes, rank candidates.

    ``predict_ms`` returns a comparable cost figure (milliseconds for the
    calibrated models, relative scan units for the heuristic) or ``None``
    when this model cannot price the plan. ``choose`` picks the cheapest
    candidate, or returns ``None`` when any candidate is unpriceable —
    the chain then falls through to the next model.
    """

    kind = "base"

    def predict_ms(self, plan, shapes: PlanShapes) -> float | None:
        raise NotImplementedError

    def ready(self) -> bool:
        """True when this model has enough data to ever decide."""
        return True

    def describe(self) -> str:
        return self.kind

    def choose(self, candidates, shapes: PlanShapes):
        """The cheapest of ``candidates`` under this model, or ``None``.

        Ties keep the candidates' given order (callers list the
        paper-faithful baseline first).
        """
        preds = [self.predict_ms(p, shapes) for p in candidates]
        if any(v is None for v in preds):
            return None
        best = min(range(len(preds)), key=lambda i: (preds[i], i))
        return candidates[best]



#: the heuristic's flat launch/merge cost of the fused fast path (tile
#: padding, the in-kernel sorted merge, pipeline fill) — what a small
#: scan can't amortise. A fused candidate drops the per-wave carry
#: traffic (its running table never leaves VMEM) and pays this instead,
#: so the heuristic flips fused-vs-xla with scan size in both directions.
FUSED_OVERHEAD = 32768.0


class HeuristicModel(CostModel):
    """Today's shape rules, now one implementation among peers: first-order
    per-shard scan cost (distance pairs + carry traffic). Unitless — it
    only has to *rank* the layouts, never predict wall-clock."""

    kind = "heuristic"

    def predict_ms(self, plan, shapes: PlanShapes) -> float:
        from repro_torch.core.engine.plan import round_up

        shard_rows = max(1, shapes.rows // max(1, shapes.n_shards))
        q_rows = max(1, shapes.n_queries * plan.probes)
        if plan.layout == "scan_codes":
            # codes-scan pairs are m/(4*dim) the cost of full-precision
            # pairs (uint8 codes vs f32 rows); the LUT build
            # (q_rows * C * dim mults) and the exact rerank over
            # ``rerank`` survivors are what a small corpus can't amortise
            # — so scan-exact wins small shapes and codes wins large ones
            dim = shapes.dim or 64
            rerank = plan.rerank or plan.k
            ratio = (plan.code_m or dim) / (4.0 * dim)
            n_waves = shard_rows // plan.block_rows
            tile_pairs = shard_rows * plan.q_cap * ratio
            if plan.impl == "fused":
                # in-kernel selection: the running table stays in VMEM —
                # one (q, rerank) emit instead of a per-wave carry fold
                carry = q_rows * rerank + FUSED_OVERHEAD
            else:
                carry = n_waves * q_rows * rerank  # running table per wave
            # LUT build + exact rerank are per *query*, not per probe-
            # expanded scan row: the LUT is leaf-independent and the
            # rerank runs once over the post-merge candidate list
            nq = max(1, shapes.n_queries)
            lut = nq * float(1 << (plan.code_bits or 8)) * dim
            fetch = nq * rerank * 2.0  # row fetch + exact re-score
            return float(tile_pairs + carry + lut + fetch)
        if plan.layout == "point_major":
            n_waves = shard_rows // plan.block_rows
            tile_pairs = shard_rows * plan.q_cap
            if plan.impl == "fused":
                carry = q_rows * plan.k + FUSED_OVERHEAD
            else:
                carry = n_waves * q_rows * plan.k  # running table per wave
            return float(tile_pairs + carry)
        q_cap_shard = round_up(
            max(plan.q_tile,
                int(q_rows / shapes.n_shards * plan.query_capacity_factor)),
            plan.q_tile,
        )
        n_qwaves = q_cap_shard // plan.q_tile
        shuffle = q_rows / shapes.n_shards * 2.0  # all_to_all send+recv rows
        return float(n_qwaves * plan.q_tile * plan.p_cap + shuffle)


class ObservedModel(CostModel):
    """Exact-signature measured ms/image (``plan(model="observed")``, and
    the middle rung of the default chain): decides only when every
    candidate has been measured under its exact resolved signature — and, for
    shape-carrying records, at the exact shapes being planned (see
    :meth:`CalibrationStore.mean_ms`)."""

    kind = "observed"

    def __init__(self, store: CalibrationStore):
        self.store = store

    def ready(self) -> bool:
        """Both dense layouts measured: the minimum for this model to ever
        rank an auto candidate pair (per-candidate signatures are still
        checked at decision time)."""
        return set(DENSE_LAYOUTS) <= self.store.layouts()

    def predict_ms(self, plan, shapes: PlanShapes) -> float | None:
        return self.store.mean_ms(plan, shapes)


class FittedModel(CostModel):
    """Per-(layout, impl) least-squares fit of the parametric cost

        ``ms ≈ a·(rows_scanned/tile) + b·probes·leaves + c·batch + d``

    over every shape-carrying observation in the store, so measurements
    at one shape inform nearby unmeasured shapes. ``tile`` is the plan's
    wave tile (``block_rows`` point-major, ``q_tile`` query-routed);
    slope coefficients ``a, b, c`` are clamped ≥ 0 via an active-set
    refit, which makes predictions monotone in ``rows_scanned``.
    Observations are weighted by the exponential decay window
    (``0.5 ** (age / CALIBRATION_HALF_LIFE_S)``) so measurements from a
    retired impl or old hardware fade instead of steering forever. A
    curve is usable once its (layout, impl) has ``min_observations``
    distinct measured signatures; :meth:`choose` requires every
    candidate's curve usable, else the chain falls back to the observed
    model.
    """

    kind = "fitted"

    #: distinct measured signatures a curve needs before its fit is used
    DEFAULT_MIN_OBSERVATIONS = 2

    def __init__(self, store: CalibrationStore,
                 min_observations: int = DEFAULT_MIN_OBSERVATIONS):
        self.store = store
        self.min_observations = int(min_observations)
        # keyed (layout, impl)
        self.coefficients: dict[tuple, tuple[float, float, float, float]] = {}
        self._fit()

    @staticmethod
    def features(layout: str, tile: int, probes: int, shapes: PlanShapes):
        return (
            shapes.rows / max(1, tile),          # rows_scanned / tile
            float(probes * shapes.n_leaves),     # probes · leaves
            float(shapes.n_queries),             # batch
            1.0,
        )

    @staticmethod
    def _plan_tile(layout: str, block_rows, q_tile) -> int:
        tile = q_tile if layout == "query_routed" else block_rows
        return int(tile) if tile else 1

    def _fit(self) -> None:
        # plan() builds a FittedModel per call (Index.search: per segment)
        # — reuse the store's cached coefficients until a record changes.
        # (Age weights drift with wall clock between cache hits, but the
        # half-life is days; the drift within a process run is noise.)
        cached = self.store._fit_cache.get(self.min_observations)
        if cached is not None and cached[0] == self.store._seq:
            self.coefficients = dict(cached[1])
            return
        now = time.time()
        by_curve: dict[tuple, list[tuple[tuple, float, float]]] = {}
        for sig, o, shapes in self.store.fit_rows():
            layout, k, probes, impl, block_rows, q_cap, q_tile, p_cap = sig
            tile = self._plan_tile(layout, block_rows, q_tile)
            x = self.features(layout, tile, probes, shapes)
            y = o["total_ms"] / max(1, o["count"])
            w = _age_weight(float(o.get("ts", now)), now)
            by_curve.setdefault((layout, impl), []).append((x, y, w))
        for curve, rows in by_curve.items():
            if len(rows) < self.min_observations:
                continue
            # weighted least squares via sqrt(w) row scaling
            sw = np.sqrt(np.array([w for _, _, w in rows], np.float64))
            X = np.array([x for x, _, _ in rows], np.float64) * sw[:, None]
            y = np.array([v for _, v, _ in rows], np.float64) * sw
            self.coefficients[curve] = tuple(_nonneg_slope_lstsq(X, y))
        self.store._fit_cache[self.min_observations] = (
            self.store._seq, dict(self.coefficients)
        )

    def ready(self, layout: str | None = None) -> bool:
        if layout is not None:
            return any(curve[0] == layout for curve in self.coefficients)
        return bool(self.coefficients)

    def predict_ms(self, plan, shapes: PlanShapes) -> float | None:
        coef = self.coefficients.get((plan.layout, plan.impl))
        if coef is None:
            return None
        tile = self._plan_tile(plan.layout, plan.block_rows, plan.q_tile)
        x = self.features(plan.layout, tile, plan.probes, shapes)
        return float(np.dot(coef, x))

    def coefficients_json(self) -> dict:
        """``"layout/impl" -> {a, b, c, d}`` (the benchmark artifact
        payload)."""
        return {
            f"{layout}/{impl}": dict(zip("abcd", (float(v) for v in coef)))
            for (layout, impl), coef in self.coefficients.items()
        }


def _nonneg_slope_lstsq(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Least squares with the slope columns (all but the last, intercept)
    clamped ≥ 0: solve, drop negative slopes, re-solve — the tiny
    active-set loop that keeps fitted costs monotone in their features."""
    n_cols = X.shape[1]
    active = list(range(n_cols))
    while active:
        coef_active, *_ = np.linalg.lstsq(X[:, active], y, rcond=None)
        full = np.zeros(n_cols)
        full[active] = coef_active
        bad = [j for j in active if j < n_cols - 1 and full[j] < 0]
        if not bad:
            return full
        active = [j for j in active if j not in bad]
    return np.zeros(n_cols)


class ModelChain(CostModel):
    """Fallback composition: the first member that can rank the candidates
    decides (fitted > observed > heuristic for ``"auto"``)."""

    def __init__(self, models, kind: str):
        self.models = tuple(models)
        self.kind = kind

    def decide(self, candidates, shapes: PlanShapes):
        """``(pick, kind)`` — which plan won and which member decided."""
        for m in self.models:
            pick = m.choose(candidates, shapes)
            if pick is not None:
                return pick, m.kind
        raise ValueError("no model in the chain could rank the candidates")

    def choose(self, candidates, shapes: PlanShapes):
        return self.decide(candidates, shapes)[0]

    def predict_ms(self, plan, shapes: PlanShapes) -> float | None:
        for m in self.models:
            v = m.predict_ms(plan, shapes)
            if v is not None:
                return v
        return None

    def describe(self) -> str:
        """Best-effort provenance label (e.g. ``"auto(observed)"``): the most
        calibrated member with enough data to ever rank an auto candidate
        pair; :meth:`decide` gives the per-decision answer."""
        for m in self.models:
            # a fitted model that cannot price every dense layout cannot
            # rank an auto candidate pair
            if isinstance(m, FittedModel):
                if not all(m.ready(layout) for layout in DENSE_LAYOUTS):
                    continue
            elif not m.ready():
                continue
            return f"{self.kind}({m.kind})" if m.kind != self.kind \
                else self.kind
        return f"{self.kind}({self.models[-1].kind})"


def resolve_model(model="auto",
                  calibration: CalibrationStore | None = None) -> CostModel:
    """A ready-to-consult :class:`CostModel` for a spec + store.

    Args:
      model: one of :data:`MODEL_KINDS`, or an already-built
        :class:`CostModel` (returned unchanged).
      calibration: the store the calibrated models read; ``None`` means
        the module default (index-less callers).

    Returns:
      ``"heuristic"`` → shape rules only; ``"observed"`` → exact
      signatures, heuristic fallback; ``"fitted"``/``"auto"`` → the full
      fitted > observed > heuristic chain (``auto`` is the default alias
      consumers advertise).

    Raises:
      ValueError: an unknown model spec.
    """
    if isinstance(model, CostModel):
        return model
    store = calibration if calibration is not None else default_calibration()
    heuristic = HeuristicModel()
    if model == "heuristic":
        return ModelChain([heuristic], "heuristic")
    if model == "observed":
        return ModelChain([ObservedModel(store), heuristic], "observed")
    if model in ("fitted", "auto"):
        return ModelChain(
            [FittedModel(store), ObservedModel(store), heuristic], model
        )
    raise ValueError(f"unknown cost model {model!r}; want one of {MODEL_KINDS}")


def fitted_component(model, calibration: CalibrationStore | None):
    """The :class:`FittedModel` a spec implies, or ``None`` — what the
    sharded layers consult for per-shard budget scaling (scales stay
    uniform until a fit is actually available)."""
    if isinstance(model, FittedModel):
        return model if model.ready() else None
    if isinstance(model, ModelChain):
        for m in model.models:
            if isinstance(m, FittedModel):
                return m if m.ready() else None
        return None
    if model in ("fitted", "auto"):
        store = (calibration if calibration is not None
                 else default_calibration())
        fitted = FittedModel(store)
        return fitted if fitted.ready() else None
    return None


# ---------------------------------------------------------------------------
# per-shard budget scaling (the sharded scatter-gather consumers)
# ---------------------------------------------------------------------------


def shard_slab_scales(fitted, plans, shapes_per_shard,
                      *, max_scale: float = 2.0) -> list[float]:
    """Per-shard slab-headroom multipliers from fitted per-shard costs.

    Replaces the uniform budget split: a shard the fit predicts to be
    more expensive than the mean earns proportionally more slab headroom
    (up to ``max_scale``); cheaper shards keep the derived default.
    Scales are ≥ 1 by construction — budgets only ever *grow*, so in the
    zero-overflow regime (the one every bit-identity test pins down)
    results are untouched; when a slab *would* overflow, the grown slab
    can only recover candidates the uniform split truncated — strictly
    closer to the true k-NN, with the remaining overflow still counted.
    All-ones when ``fitted`` is ``None`` or cannot price every shard
    (the uniform fallback).
    """
    n = len(plans)
    if fitted is None or n < 2:
        return [1.0] * n
    preds = [fitted.predict_ms(p, s) for p, s in zip(plans, shapes_per_shard)]
    if any(v is None for v in preds):
        return [1.0] * n
    mean = sum(preds) / n
    if mean <= 0:
        return [1.0] * n
    return [min(float(max_scale), max(1.0, v / mean)) for v in preds]


def scale_slab_budget(plan, scale: float, *, n_queries: int,
                      shard_rows: int):
    """``plan`` with its slab budget (``q_cap`` point-major, ``p_cap``
    query-routed) grown by ``scale`` (≥ 1; snapped to 8 rows).

    Growth is capped at what a slab can actually hold — the
    probe-expanded query rows for point-major, the shard's point rows
    for query-routed — so scaling never pads dead rows into the wave
    scans. ``scale <= 1`` returns the plan unchanged: shrinking a slab
    could introduce overflow truncation and is never done here; growth
    is identity-preserving while no slab overflows and can only
    *reduce* truncation otherwise.
    """
    from repro_torch.core.engine.plan import round_up

    if scale <= 1.0:
        return plan
    if plan.layout != "query_routed":  # point_major and scan_codes slab q_cap
        grown = min(
            round_up(int(plan.q_cap * scale), 8),
            max(plan.q_cap, n_queries * plan.probes),
        )
        return dataclasses.replace(plan, q_cap=grown)
    grown = min(
        round_up(int(plan.p_cap * scale), 8),
        max(plan.p_cap, shard_rows),
    )
    return dataclasses.replace(plan, p_cap=grown)
