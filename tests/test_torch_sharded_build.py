"""repro_torch's two jobs over S shards on a CPU mesh: ``build_index`` and
``batch_search`` at S = 1, 2, 4 on ``DeviceMesh((cpu,) * S)`` against the
JAX package's on a mesh of four host devices (Auto axes, ``impl="xla"``;
tests/mesh_reference.py runs it in a subprocess): the global arrays bit
for bit, a skewed corpus's routing overflow included; ids, distances,
``pairs`` and ``q_cap_overflow`` at both dense layouts, probes 1 and 2
(query-routed ``pairs`` S times the one shard's, ROADMAP R5); the
scan_codes candidates; and the port's fused and pallas executors at S
equal to its own xla at S."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mesh_reference as mref
from repro_torch import interop
from repro_torch.core import lookup as tlookup
from repro_torch.core.engine.plan import plan as tplan
from repro_torch.core.index_build import MeshIndex, build_index
from repro_torch.core.search import batch_search, search_with_lookup
from repro_torch.distributed.meshutil import DeviceMesh

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
FIELDS = ("vecs", "ids", "leaves", "offsets", "n_valid", "overflow")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ref") / "build.npz"
    run = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "mesh_reference.py"), "build",
         str(out)], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def world(ref):
    x, skew, q = mref.corpus()
    tree = interop.tree_from_numpy(
        [ref[f"tree_{i}"] for i in range(len(mref.FANOUTS))], device="cpu")
    built = {s: build_index(x, tree, mesh=DeviceMesh((CPU,) * s))
             for s in mref.SHARDS}
    return dict(x=x, skew=skew, q=q, tree=tree, built=built)


@pytest.mark.parametrize("s", mref.SHARDS)
def test_build_index_equals_the_reference(ref, world, s):
    idx = world["built"][s]
    assert idx.n_shards == s and isinstance(idx, MeshIndex) == (s > 1)
    got = interop.index_to_numpy(idx)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], ref[f"S{s}_{f}"], err_msg=f)
    # each shard's rows live on its device, its leaves ascend (P3)
    for part, dev in zip(idx.parts, idx.mesh.devices):
        assert part.vecs.device == dev
        assert bool((part.leaves[1:] >= part.leaves[:-1]).all())


@pytest.mark.parametrize("s", mref.SHARDS)
def test_skewed_build_overflows_as_the_reference(ref, world, s):
    idx = build_index(world["skew"], world["tree"], capacity_factor=1.0,
                      mesh=DeviceMesh((CPU,) * s))
    got = interop.index_to_numpy(idx)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], ref[f"S{s}_skew_{f}"], err_msg=f)
    assert (int(got["overflow"]) > 0) == (s > 1)


def _same(res, ref, tag, *, rtol=0.0):
    np.testing.assert_array_equal(res.ids.numpy(), ref[f"{tag}_ids"])
    np.testing.assert_allclose(res.dists.numpy(), ref[f"{tag}_dists"],
                               rtol=rtol, atol=0)
    assert float(res.pairs) == float(ref[f"{tag}_pairs"])
    assert int(res.q_cap_overflow) == int(ref[f"{tag}_ov"])


@pytest.mark.parametrize("s", mref.SHARDS)
@pytest.mark.parametrize("layout", ["point_major", "query_routed"])
@pytest.mark.parametrize("probes", [1, 2])
def test_batch_search_equals_the_reference(ref, world, s, layout, probes):
    res = batch_search(world["built"][s], world["tree"], world["q"], mref.K,
                       layout=layout, probes=probes, device="cpu")
    # integer data: the distances agree bit for bit (the contract is 2e-4)
    _same(res, ref, f"S{s}_{layout}_{probes}")
    one = ref[f"S1_{layout}_{probes}_pairs"]
    assert float(res.pairs) == float(one) * (s if layout == "query_routed" else 1)


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_fused_and_pallas_at_s_equal_xla_at_s(world, s, impl):
    idx, tree, q = world["built"][s], world["tree"], world["q"]
    layouts = ["point_major"] + (["query_routed"] if impl == "pallas" else [])
    for layout in layouts:
        base = batch_search(idx, tree, q, mref.K, layout=layout, probes=2,
                            device="cpu")
        res = batch_search(idx, tree, q, mref.K, layout=layout, probes=2,
                           impl=impl, device="cpu")
        for f in ("ids", "dists", "pairs", "q_cap_overflow"):
            assert torch.equal(getattr(res, f), getattr(base, f)), (layout, f)


def _codes_search(ref, world, s, probes, impl):
    idx = world["built"][s]
    codes = torch.as_tensor(ref[f"S{s}_codes"])
    if s > 1:
        codes = codes.reshape(s, -1, codes.shape[1]).unbind(0)
    lk = tlookup.build_lookup(world["tree"], torch.as_tensor(world["q"]),
                              probes=probes)
    p = tplan(rows=idx.rows, n_leaves=idx.n_leaves, n_queries=mref.N_Q,
              n_shards=s, k=mref.K, probes=probes, layout="scan_codes",
              impl=impl, code_m=mref.CODE_M, code_bits=mref.CODE_BITS,
              rerank=mref.RERANK)
    return search_with_lookup(idx, lk, p, n_queries=mref.N_Q, codes=codes,
                              codebooks=ref["codebooks"])


@pytest.mark.parametrize("s", mref.SHARDS)
@pytest.mark.parametrize("probes", [1, 2])
def test_scan_codes_candidates_equal_the_reference(ref, world, s, probes):
    res = _codes_search(ref, world, s, probes, "xla")
    # the LUTs are real-valued: ADC sums agree within the 2e-4 contract
    _same(res, ref, f"S{s}_codes_{probes}", rtol=2e-4)
    fused = _codes_search(ref, world, s, probes, "fused")
    assert torch.equal(fused.ids, res.ids)
    assert torch.equal(fused.dists, res.dists)
    assert float(fused.pairs) == float(res.pairs)


def test_build_refuses_leaves_that_do_not_split(world):
    with pytest.raises(ValueError, match="must divide over 3 shards"):
        build_index(world["x"], world["tree"], mesh=DeviceMesh((CPU,) * 3))
