"""repro_torch's cost models and ``plan()`` against the JAX package's.

From the same calibration JSON, ``plan(layout="auto")`` and
``plan(impl="auto")`` pick the same plan under the heuristic, observed,
fitted and default chains; the ``CalibrationStore`` JSON round-trips
against the reference's; records and tile configs of another backend (or
of none, as the JAX package writes them) are carried through and never
consulted, at the store and through an ``Index`` manifest.
"""

import copy
import importlib
import json

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


def _tagged(d, backend=BACKEND):
    """The JSON with ``backend`` on every record and tile config (the
    reference's from_json ignores the key)."""
    d = copy.deepcopy(d)
    for rec in d["records"]:
        rec["backend"] = backend
    for cfg in d["tile_configs"]:
        cfg["backend"] = backend
    return d


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
    jstore = jcm.CalibrationStore.from_json(_tagged(calibration_json))
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
    jstore = jcm.CalibrationStore.from_json(_tagged(calibration_json))
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
    # records of this backend come back out with their backend key, and
    # the reference reads them (ignoring the key) into the same store
    own = tcm.CalibrationStore.from_json(_tagged(calibration_json),
                                         backend=BACKEND)
    out = own.to_json()
    assert out == _tagged(calibration_json)
    back = jcm.CalibrationStore.from_json(json.loads(json.dumps(out)))
    assert back.to_json() == calibration_json
    assert own.snapshot() == back.snapshot()


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
    assert out["records"][0]["backend"] == BACKEND
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
