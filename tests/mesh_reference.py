"""The JAX package's answers on a mesh of four CPU devices, for the port's
sharded tests (tests/test_torch_mesh.py, test_torch_sharded_build.py,
test_torch_sharded_index.py).

The test workers keep JAX at one device, so the sharded tests run this in
a subprocess:

    python tests/mesh_reference.py CASE OUT.npz [DIR ...]

It sets ``XLA_FLAGS`` to four host devices before it imports JAX (the
tests import this module for its constants and corpus only), builds
every mesh with Auto axes (``Mesh(devices[:S].reshape(S, 1), ("data",
"model"))``, ROADMAP R1) and searches with ``impl="xla"`` (R2). CASE is
``tree``, ``submeshes``, ``build`` or ``index``; the results go to OUT.npz.
"""

from __future__ import annotations

import os
import sys

import numpy as np

DIM = 16
FANOUTS = (8, 4)
N = 4096
N_Q = 64
K = 5
CODE_M, CODE_BITS, RERANK = 4, 4, 16
SHARDS = (1, 2, 4)
# the Index case: two appends at two shards, a delete, and the P12 pair
# at four shards (the first append's last row dropped by routing)
APPENDS = (0, 1500, N)
DEAD = np.arange(7, N, 53)
P12_APPENDS = (0, 1501, 4000)


def corpus():
    """(x, skewed x, queries): SIFT-like integer rows, a copy whose rows
    crowd into a few leaves (routing overflows at capacity factor 1), and
    queries near the first rows."""
    from repro.data import synth

    x, _ = synth.sample_descriptors(N, DIM, seed=0, n_centers=40)
    rng = np.random.default_rng(3)
    hot = x[rng.integers(0, 4, size=N)]
    skew = np.where(rng.random((N, 1)) < 0.6, hot, x).astype(np.float32)
    q = x[:N_Q] + rng.integers(-3, 4, size=(N_Q, DIM)).astype(np.float32)
    return x, skew, q


def _mesh(s):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:s]).reshape(s, 1), ("data", "model"))


def _tree(x):
    import jax
    import jax.numpy as jnp

    from repro.core.tree import build_tree

    return build_tree(jnp.asarray(x), FANOUTS, key=jax.random.PRNGKey(1))


def case_tree(out):
    """The tree of the corpus, for the port's side of the Index case."""
    x, _, _ = corpus()
    for i, lvl in enumerate(_tree(x).levels):
        out[f"tree_{i}"] = np.asarray(lvl)


def case_submeshes(out):
    """Device groups of ``shard_submeshes`` for every (devices, shards)."""
    from repro.distributed.meshutil import shard_submeshes

    for n_dev in (1, 2, 3, 4):
        for n in (1, 2, 3, 4):
            subs = shard_submeshes(_mesh(n_dev), n)
            out[f"sub_{n_dev}_{n}"] = np.array(
                [[d.id for d in m.devices.reshape(-1)] for m in subs])


def _index_arrays(out, tag, idx):
    for f in ("vecs", "ids", "leaves", "offsets", "n_valid", "overflow"):
        out[f"{tag}_{f}"] = np.asarray(getattr(idx, f))


def _result(out, tag, res):
    out[f"{tag}_ids"] = np.asarray(res.ids)
    out[f"{tag}_dists"] = np.asarray(res.dists)
    out[f"{tag}_pairs"] = np.asarray(res.pairs)
    out[f"{tag}_ov"] = np.asarray(res.q_cap_overflow)


def case_build(out):
    """build_index at S = 1, 2, 4 (and the skewed corpus at capacity
    factor 1), batch_search at both layouts and probes 1 and 2, and the
    scan_codes candidates at probes 1 and 2."""
    import jax.numpy as jnp

    from repro.codes import ProductQuantizer
    from repro.core import lookup as jlookup
    from repro.core.engine.plan import plan as jplan_fn
    from repro.core.index_build import build_index
    from repro.core.search import batch_search, search_with_lookup

    x, skew, q = corpus()
    tree = _tree(x)
    for i, lvl in enumerate(tree.levels):
        out[f"tree_{i}"] = np.asarray(lvl)
    pq = ProductQuantizer.train(x, m=CODE_M, bits=CODE_BITS, seed=0,
                                sample=2048, iters=4)
    out["codebooks"] = pq.codebooks
    for s in SHARDS:
        mesh = _mesh(s)
        idx = build_index(jnp.asarray(x), tree, mesh)
        _index_arrays(out, f"S{s}", idx)
        _index_arrays(out, f"S{s}_skew",
                      build_index(jnp.asarray(skew), tree, mesh,
                                  capacity_factor=1.0))
        for layout in ("point_major", "query_routed"):
            for probes in (1, 2):
                _result(out, f"S{s}_{layout}_{probes}", batch_search(
                    idx, tree, jnp.asarray(q), K, mesh, layout=layout,
                    probes=probes, impl="xla"))
        codes = pq.encode(np.asarray(idx.vecs))
        out[f"S{s}_codes"] = codes
        for probes in (1, 2):
            lk = jlookup.build_lookup(tree, jnp.asarray(q), probes=probes)
            p = jplan_fn(rows=idx.rows, n_leaves=idx.n_leaves, n_queries=N_Q,
                           n_shards=s, k=K, probes=probes, layout="scan_codes",
                           impl="xla", dim=DIM, code_m=CODE_M,
                           code_bits=CODE_BITS, model="heuristic",
                           rerank=RERANK)
            _result(out, f"S{s}_codes_{probes}", search_with_lookup(
                idx, lk, p, mesh, n_queries=N_Q, codes=codes,
                codebooks=pq.codebooks))


def case_index(out, grown_by_port):
    """The Index at two shards: grow a directory (two appends, a delete)
    and search it; open the port's directory and search that; then the
    P12 pair of appends at four shards."""
    import jax.numpy as jnp

    from repro.index import Index

    x, skew, q = corpus()
    tree = _tree(x)
    for i, lvl in enumerate(tree.levels):
        out[f"tree_{i}"] = np.asarray(lvl)
    mesh = _mesh(2)
    ref_dir = os.path.join(os.path.dirname(grown_by_port), "ref")
    idx = Index.create(tree, ref_dir, mesh=mesh)
    for lo, hi in zip(APPENDS, APPENDS[1:]):
        idx.append(x[lo:hi])
    idx.commit()
    idx.delete(DEAD)
    idx.commit()
    for layout in ("point_major", "query_routed"):
        for probes in (1, 2):
            _result(out, f"ref_{layout}_{probes}", idx.search(
                jnp.asarray(q), K, layout=layout, probes=probes, impl="xla"))
            _result(out, f"port_{layout}_{probes}", Index.open(
                grown_by_port, mesh=mesh).search(
                jnp.asarray(q), K, layout=layout, probes=probes, impl="xla"))
    out["ref_dir"] = np.array(ref_dir)
    p12 = Index.create(tree, None, mesh=_mesh(4))
    for lo, hi in zip(P12_APPENDS, P12_APPENDS[1:]):
        p12.append(skew[lo:hi])
    out["p12_min_ids"] = np.array([s.min_id for s in p12.segments])
    out["p12_overflow"] = np.array(
        [int(s.index.overflow) for s in p12.segments])
    _result(out, "p12", p12.search(jnp.asarray(q), K, layout="point_major",
                                   impl="xla"))


def main(argv):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    case, path = argv[0], argv[1]
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    out = {}
    if case == "tree":
        case_tree(out)
    elif case == "submeshes":
        case_submeshes(out)
    elif case == "build":
        case_build(out)
    elif case == "index":
        case_index(out, argv[2])
    else:
        raise SystemExit(f"unknown case {case!r}")
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1:])
