"""repro_torch's cost models and ``plan()`` against the JAX package's.

From the same calibration (each package's JSON form of it),
``plan(layout="auto")`` and ``plan(impl="auto")`` pick the same plan under
the heuristic, observed, fitted and default chains; the
``CalibrationStore`` JSON round-trips against the reference's; records and
tile configs of another backend (or of none, as the JAX package writes
them) are carried through and never consulted, at the store and through
an ``Index`` manifest; the port's records and tile configs survive the
reference's rewrite of a manifest and still steer the port's plans, also
where both packages recorded the same (signature, shapes) key, and the
reference's plans stay the ones its own records give.
"""

import copy
import importlib
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.core.engine import costmodel as jcm
from repro.core.tree import build_tree as j_build_tree
from repro.index import Index as JIndex
from repro_torch.core.engine import costmodel as tcm
from repro_torch.data import synth
from repro_torch.index import Index
from repro_torch.index import manifest as manifest_lib

jplan = importlib.import_module("repro.core.engine.plan")
tplan = importlib.import_module("repro_torch.core.engine.plan")

SHAPES = dict(rows=65_536, n_leaves=64, n_queries=256, n_shards=1, k=10)
FIELDS = ("layout", "k", "probes", "impl", "block_rows", "q_cap", "q_tile",
          "p_cap", "rerank", "code_m", "code_bits", "query_capacity_factor")
BACKEND = "cpu"


def _key(p):
    return tuple(getattr(p, f) for f in FIELDS)


def _tagged(d, backend=BACKEND, *, where="impl"):
    """The JSON with ``backend`` folded into every record's ``impl``
    (``"xla@cpu"``) and every tile config's dtype (``"float32@cpu"``), as
    the port writes them; with ``where="stats"`` or ``"record"``, where
    earlier versions of the port wrote a record's marker: a ``backend``
    key inside its ``stats`` (the tile configs' folded into their dtype),
    or beside its ``signature`` (and a ``backend`` key beside the tile
    config's ``block_rows``)."""
    d = copy.deepcopy(d)
    for rec in d["records"]:
        if where == "impl":
            rec["signature"][3] = f"{rec['signature'][3]}@{backend}"
        else:
            (rec["stats"] if where == "stats" else rec)["backend"] = backend
    for cfg in d["tile_configs"]:
        if where == "record":
            cfg["backend"] = backend
        else:
            cfg["dtype"] = f"{cfg['dtype']}@{backend}"
    return d


def _marked_keys(snapshot, backend=BACKEND):
    """A snapshot's signature keys with ``backend`` folded into the impl,
    as the reference keys the port's records."""
    return {re.sub(r"/impl=([^/]+)/", rf"/impl=\1@{backend}/", key): v
            for key, v in snapshot.items()}


@pytest.fixture(scope="module")
def calibration_json():
    """A reference store calibrated against the shape rules: both dense
    layouts at three row counts (query-routed cheap, point-major growing
    with rows), fused and codes candidates, and one tuned tile config."""
    store = jcm.CalibrationStore()
    for i, rows in enumerate((32_768, 65_536, 262_144)):
        kw = dict(SHAPES, rows=rows)
        shapes = jcm.PlanShapes(rows=rows, n_queries=256, n_shards=1,
                                n_leaves=64)
        for layout, impl, ms in (("point_major", "xla", 50.0 * (i + 1)),
                                 ("point_major", "fused", 40.0 * (i + 1)),
                                 ("query_routed", "xla", 5.0 + i)):
            p = jplan.plan(layout=layout, impl=impl, **kw)
            store.record(p, ms, shapes)
            store.record(p, ms * 1.5, shapes)
        sc = jplan.plan(layout="scan_codes", code_m=8, code_bits=8, dim=32, **kw)
        store.record(sc, 3.0, shapes)
    store.record(jplan.plan(layout="point_major", **SHAPES), 70.0)  # shapeless
    store.record_tile_config("point_major", 32, "float32", 2048, 1.5)
    return store.to_json()


GRID = [
    dict(SHAPES),
    dict(SHAPES, rows=131_072),
    dict(SHAPES, rows=1 << 20, n_queries=1024),
    dict(SHAPES, rows=4096, n_queries=8, k=5),
    dict(SHAPES, probes=2),
    dict(SHAPES, k=20, dim=32),
    dict(SHAPES, dim=32, code_m=8, code_bits=8),
    dict(SHAPES, rows=262_144, dim=32, code_m=8, code_bits=8, rerank=64),
]


@pytest.mark.parametrize("model", ["heuristic", "observed", "fitted", "auto"])
@pytest.mark.parametrize("impl", ["xla", "auto"])
@pytest.mark.parametrize("layout", ["auto", "point_major", "query_routed"])
def test_plan_picks_the_reference_plan(calibration_json, model, impl, layout):
    jstore = jcm.CalibrationStore.from_json(calibration_json)  # its own form
    tstore = tcm.CalibrationStore.from_json(_tagged(calibration_json),
                                            backend=BACKEND)
    assert len(tstore) == len(jstore) and tstore.n_carried == 0
    for kw in GRID:
        jp = jplan.plan(layout=layout, impl=impl, model=model,
                        calibration=jstore, **kw)
        tp = tplan.plan(layout=layout, impl=impl, model=model,
                        calibration=tstore, **kw)
        assert _key(jp) == _key(tp), kw
        assert tp.wire_dtype == torch.float32


def test_the_deciding_model_is_the_reference_one(calibration_json):
    jstore = jcm.CalibrationStore.from_json(calibration_json)  # its own form
    tstore = tcm.CalibrationStore.from_json(_tagged(calibration_json),
                                            backend=BACKEND)
    kinds = set()
    for kw in GRID:
        for model in ("heuristic", "observed", "fitted", "auto"):
            jc = [jplan.plan(layout=lay, **kw)
                  for lay in ("point_major", "query_routed")]
            tc = [tplan.plan(layout=lay, **kw)
                  for lay in ("point_major", "query_routed")]
            ctx = dict(rows=kw["rows"], n_queries=kw["n_queries"], n_shards=1,
                       n_leaves=kw["n_leaves"], dim=kw.get("dim", 0))
            jpick, jkind = jcm.resolve_model(model, jstore).decide(
                tuple(jc), jcm.PlanShapes(**ctx))
            tpick, tkind = tcm.resolve_model(model, tstore).decide(
                tuple(tc), tcm.PlanShapes(**ctx))
            assert (_key(jpick), jkind) == (_key(tpick), tkind), (kw, model)
            kinds.add(tkind)
    # the grid exercises every model of the chain
    assert kinds == {"heuristic", "observed", "fitted"}
    jfit = jcm.FittedModel(jstore).coefficients_json()
    tfit = tcm.FittedModel(tstore).coefficients_json()
    assert sorted(jfit) == sorted(tfit)
    for curve in jfit:
        # least squares in float64: equal up to its rounding (a clamped
        # slope may read 0 in one and 1e-18 in the other)
        np.testing.assert_allclose(list(tfit[curve].values()),
                                   list(jfit[curve].values()), rtol=1e-9,
                                   atol=1e-12)


def test_calibration_json_roundtrips_against_the_reference(calibration_json):
    # the reference's JSON (no backend keys) is carried verbatim
    carried = tcm.CalibrationStore.from_json(calibration_json, backend=BACKEND)
    assert len(carried) == 0 and carried.n_carried == len(
        calibration_json["records"]) + len(calibration_json["tile_configs"])
    assert carried.to_json() == calibration_json
    # records of this backend come back out with their backend marker,
    # and the reference reads them into a store of its own; its rewrite
    # keeps the markers (folded into each record's impl and each tile
    # config's dtype, key strings it keeps whole)
    own = tcm.CalibrationStore.from_json(_tagged(calibration_json),
                                         backend=BACKEND)
    out = own.to_json()
    assert out == _tagged(calibration_json)
    back = jcm.CalibrationStore.from_json(json.loads(json.dumps(out)))
    rewritten = back.to_json()
    assert rewritten["records"] == out["records"]
    assert rewritten["tile_configs"] == out["tile_configs"]
    assert _marked_keys(own.snapshot()) == back.snapshot()
    again = tcm.CalibrationStore.from_json(rewritten, backend=BACKEND)
    assert len(again) == len(own) and again.n_carried == 0
    assert again.snapshot() == own.snapshot()
    assert again.tile_config("point_major", 32, "float32")["block_rows"] == 2048
    # the markers of earlier versions (inside the record's stats or beside
    # its signature, a tile config's backend key) are still read
    for where in ("stats", "record"):
        old = tcm.CalibrationStore.from_json(
            _tagged(calibration_json, where=where), backend=BACKEND)
        assert len(old) == len(own) and old.n_carried == 0
        assert old.to_json() == out


def test_other_backends_are_carried_not_consulted(calibration_json):
    """A store of another backend's measurements (they make observed and
    fitted flip the layout) steers nothing here: every model plans as the
    heuristic does, and the fused candidate ignores the foreign tuned
    tile."""
    foreign = tcm.CalibrationStore.from_json(
        _tagged(calibration_json, "cuda:Another GPU"), backend=BACKEND)
    assert len(foreign) == 0 and foreign.tile_config(
        "point_major", 32, "float32") is None
    own = tcm.CalibrationStore.from_json(_tagged(calibration_json),
                                         backend=BACKEND)
    flipped = 0
    for kw in GRID:
        heur = tplan.plan(layout="auto", impl="auto", model="heuristic", **kw)
        got = tplan.plan(layout="auto", impl="auto", model="auto",
                         calibration=foreign, **kw)
        assert _key(got) == _key(heur), kw
        flipped += _key(tplan.plan(layout="auto", impl="auto", model="auto",
                                   calibration=own, **kw)) != _key(heur)
    assert flipped  # the same records of this backend do decide
    # a measurement made here is recorded under this backend, and the
    # foreign records ride along unchanged
    foreign.record(tplan.plan(layout="point_major", **SHAPES), 9.0)
    out = foreign.to_json()
    assert out["records"][0]["signature"][3].endswith(f"@{BACKEND}")
    assert "backend" not in out["records"][0]["stats"]
    assert out["records"][1:] == _tagged(calibration_json,
                                         "cuda:Another GPU")["records"]
    with pytest.raises(ValueError, match="cannot merge"):
        own.merge(tcm.CalibrationStore(backend="cuda:Another GPU"))


def test_backend_names():
    assert tcm.backend_name("cpu") == "cpu"
    assert tcm.CalibrationStore(backend="cpu").backend == "cpu"


def test_index_manifest_carries_reference_calibration(calibration_json,
                                                      tmp_path):
    """A directory the reference wrote carries its calibration; the port
    opens it, plans as if it had none, and commits it back unchanged."""
    mesh = Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))
    x, _ = synth.sample_descriptors(512, 8, seed=0, n_centers=8)
    jt = j_build_tree(jnp.asarray(x), (4, 2), key=jax.random.PRNGKey(0))
    d = str(tmp_path / "idx")
    ji = JIndex.create(jt, d, mesh=mesh)
    ji.append(x)
    ji.calibration.merge(jcm.CalibrationStore.from_json(calibration_json))
    ji.commit()
    ti = Index.open(d, device="cpu")
    assert len(ti.calibration) == 0 and ti.calibration.n_carried > 0
    ti.append(x[:64] + 1.0)
    ti.commit()
    m = manifest_lib.latest(d)
    assert m.calibration == ji.calibration.to_json()
    # and the reference still reads the manifest the port wrote
    assert JIndex.open(d, mesh=mesh).rows == ti.rows


def test_plan_rejects_fused_query_routed():
    with pytest.raises(ValueError, match="fused"):
        tplan.plan(layout="query_routed", impl="fused", **SHAPES)
    with pytest.raises(ValueError, match="unknown layout"):
        tplan.plan(layout="bogus", **SHAPES)
    with pytest.raises(ValueError, match="cost model"):
        tplan.plan(layout="auto", model="bogus", **SHAPES)


def test_port_calibration_survives_a_reference_commit(calibration_json, tmp_path):
    """A directory the port committed with its own records, then the
    reference opened, appended to and committed, then the port reopened:
    the port's records are still its own and still steer its plans (the
    marker rides folded into each record's impl, a key string the
    reference writes back whole)."""
    mesh = Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))
    x, _ = synth.sample_descriptors(512, 8, seed=1, n_centers=8)
    jt = j_build_tree(jnp.asarray(x), (4, 2), key=jax.random.PRNGKey(0))
    d = str(tmp_path / "idx")
    ji = JIndex.create(jt, d, mesh=mesh)
    ji.append(x)
    ji.commit()
    ti = Index.open(d, device="cpu")
    ti.calibration.merge(tcm.CalibrationStore.from_json(
        _tagged(calibration_json), backend=BACKEND))
    n_own = len(ti.calibration)
    assert n_own > 0
    ti.commit()
    ji = JIndex.open(d, mesh=mesh)
    assert len(ji.calibration) == n_own
    ji.append(x[:64] + 1.0)
    ji.commit()
    ti = Index.open(d, device="cpu")
    assert len(ti.calibration) == n_own
    assert ti.calibration.snapshot() == tcm.CalibrationStore.from_json(
        _tagged(calibration_json), backend=BACKEND).snapshot()
    # the tile config's marker survived too (folded into its dtype)
    assert ti.calibration.n_carried == 0
    assert ti.calibration.tile_config("point_major", 32, "float32")["block_rows"] == 2048
    flipped = sum(
        _key(tplan.plan(layout="auto", impl="auto", model="auto",
                        calibration=ti.calibration, **kw))
        != _key(tplan.plan(layout="auto", impl="auto", model="heuristic", **kw))
        for kw in GRID)
    assert flipped


def test_port_tile_config_steers_its_plan_across_a_reference_commit(tmp_path):
    """The port records a tuned tile config (and one measurement: the
    reference writes a manifest's calibration back only when it holds
    records) and commits; the reference opens the directory on the Auto
    mesh, appends and commits; the port reopens and its fused plan takes
    that ``block_rows``. The reference's own fused plan is the one it
    makes with no tile config at all."""
    mesh = Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))
    x, _ = synth.sample_descriptors(512, 8, seed=2, n_centers=8)
    jt = j_build_tree(jnp.asarray(x), (4, 2), key=jax.random.PRNGKey(0))
    d = str(tmp_path / "idx")
    ji = JIndex.create(jt, d, mesh=mesh)
    ji.append(x)
    ji.commit()
    shapes = dict(rows=65_536, n_leaves=8, n_queries=256, n_shards=1, k=10, dim=8,
                  layout="point_major", impl="fused", model="heuristic")
    untuned = tplan.plan(**shapes, calibration=tcm.CalibrationStore(backend=BACKEND))
    ti = Index.open(d, device="cpu")
    assert ti.calibration.backend == BACKEND
    ti.calibration.record_tile_config("point_major", 8, "float32", 512, 0.25)
    ti.calibration.record(untuned, 3.0)
    ti.commit()
    raw = manifest_lib.latest(d).calibration["tile_configs"]
    assert [c["dtype"] for c in raw] == [f"float32@{BACKEND}"]
    ji = JIndex.open(d, mesh=mesh)
    ji.append(x[:64] + 1.0)
    ji.commit()
    # the reference's plan never reads the port's entry
    j_shapes = dict(shapes)
    j_shapes.pop("model")
    j_tuned = jplan.plan(**j_shapes, model="heuristic", calibration=ji.calibration)
    j_bare = jplan.plan(**j_shapes, model="heuristic",
                        calibration=jcm.CalibrationStore())
    assert j_tuned.block_rows == j_bare.block_rows == untuned.block_rows != 512
    ti = Index.open(d, device="cpu")
    assert ti.calibration.n_carried == 0
    assert ti.calibration.tile_config("point_major", 8, "float32")["block_rows"] == 512
    tuned = tplan.plan(**shapes, calibration=ti.calibration)
    assert tuned.block_rows == 512
    # another card's port reads the entry as foreign
    other = tcm.CalibrationStore.from_json(manifest_lib.latest(d).calibration,
                                           backend="cuda:Another GPU")
    assert other.tile_config("point_major", 8, "float32") is None
    assert len(other) == 0 and other.n_carried == 2  # the record and the tile


def _scaled(d, by_layout):
    """The JSON with every record's times multiplied by its layout's
    factor in ``by_layout``."""
    d = copy.deepcopy(d)
    for rec in d["records"]:
        f = by_layout.get(rec["signature"][0], 1.0)
        for key in ("total_ms", "min_ms", "max_ms", "last_ms"):
            rec["stats"][key] *= f
    return d


def test_both_packages_records_of_one_key_survive_a_reference_commit(
        calibration_json, tmp_path):
    """ROADMAP P8: the port records a calibration under every (signature,
    shapes) key that the reference then records too, with times that
    would flip the reference's layouts if it read them; the reference
    opens the directory on the Auto mesh, records its own, fits, plans,
    appends and commits. Both packages' records survive, each package
    reopens exactly its own, and the reference's plans under every model
    are the ones its own records alone give."""
    mesh = Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))
    x, _ = synth.sample_descriptors(512, 8, seed=3, n_centers=8)
    jt = j_build_tree(jnp.asarray(x), (4, 2), key=jax.random.PRNGKey(0))
    d = str(tmp_path / "idx")
    ji = JIndex.create(jt, d, mesh=mesh)
    ji.append(x)
    ji.commit()
    flipped = _scaled(calibration_json, {"point_major": 1e-3, "query_routed": 1e3})
    port = tcm.CalibrationStore.from_json(_tagged(flipped), backend=BACKEND)
    ti = Index.open(d, device="cpu")
    ti.calibration.merge(port)
    ti.commit()
    n = len(calibration_json["records"])
    assert len(ti.calibration) == n

    ji = JIndex.open(d, mesh=mesh)
    ji.calibration.merge(jcm.CalibrationStore.from_json(calibration_json))
    assert len(ji.calibration) == 2 * n  # one record of each package a key
    assert len(ji.calibration.fit_rows()) == 2 * (n - 1)  # one is shapeless
    fitted = jcm.FittedModel(ji.calibration)
    assert set(fitted.coefficients) >= {("point_major", "xla"),
                                        ("query_routed", "xla")}
    ji.append(x[:64] + 1.0)
    ji.commit()
    raw = manifest_lib.latest(d).calibration["records"]
    assert len(raw) == 2 * n
    assert sum(r["signature"][3].endswith(f"@{BACKEND}") for r in raw) == n

    # each package reopens exactly its own records
    ti = Index.open(d, device="cpu")
    assert ti.calibration.snapshot() == port.snapshot()
    # the reference's records and tile config ride along, unread
    assert ti.calibration.n_carried == n + len(calibration_json["tile_configs"])
    ji = JIndex.open(d, mesh=mesh)
    alone = jcm.CalibrationStore.from_json(calibration_json)
    with_port = jcm.CalibrationStore.from_json(
        jcm.CalibrationStore.from_json(flipped).to_json())
    flips = 0
    for kw in GRID:
        for model in ("heuristic", "observed", "fitted", "auto"):
            got = jplan.plan(layout="auto", impl="auto", model=model,
                             calibration=ji.calibration, **kw)
            want = jplan.plan(layout="auto", impl="auto", model=model,
                              calibration=alone, **kw)
            assert _key(got) == _key(want), (model, kw)
            flips += _key(jplan.plan(layout="auto", impl="auto", model=model,
                                     calibration=with_port, **kw)) != _key(want)
    assert flips  # the port's times, read as the reference's, would steer it
    # and the port plans from its own records, as before the commit
    for kw in GRID:
        assert _key(tplan.plan(layout="auto", impl="auto", model="auto",
                               calibration=ti.calibration, **kw)) == _key(
            tplan.plan(layout="auto", impl="auto", model="auto",
                       calibration=port, **kw))
