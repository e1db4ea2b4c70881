"""The Copydays protocol (paper §4.2, Fig 4) and the sift100m constants,
repro_torch against the JAX package.

``make_copydays`` and ``vote_images`` are numpy copies: equal outputs for
several seeds, ``-1`` ids included. The reference's end-to-end Copydays
workflow (``tests/test_system.py``) runs on both packages with the JAX
tree carried across (``interop.tree_from_numpy``); the queries are
real-valued, so the two searches may differ inside fp32 near-ties, and the
image votes are held equal per variant. ``sift_smoke`` passes on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import sift100m as jcfg
from repro.core.index_build import build_index as j_build_index
from repro.core.search import batch_search as j_batch_search
from repro.core.tree import build_tree as j_build_tree
from repro.data import copydays as jcd
from repro.data import synth as jsynth
from repro_torch import batch_search, build_index, interop
from repro_torch.configs import sift100m as tcfg
from repro_torch.data import copydays as tcd


def _mesh():
    return Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_make_copydays_matches_reference(seed):
    vecs, img = jsynth.sample_images(30, 12, 16, seed=seed)
    a = jcd.make_copydays(vecs, img, seed=seed)
    b = tcd.make_copydays(vecs, img, seed=seed)
    for f in ("query_vecs", "query_img", "query_variant"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.n_originals == b.n_originals == 30
    assert tcd.VARIANTS == jcd.VARIANTS


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_vote_images_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n_db, n_img, q, k = 600, 40, 500, 10
    db_img = rng.integers(0, n_img, n_db)
    q_img = rng.integers(0, n_img, q).astype(np.int32)
    q_var = rng.integers(0, len(jcd.VARIANTS), q).astype(np.int32)
    ids = rng.integers(-1, n_db, (q, k))  # -1: no neighbour
    ids[:7] = -1  # queries that kept no match at all
    # plant the true image in some rows so recalls are not all zero
    own = np.flatnonzero(db_img == q_img[8])
    ids[8] = own[0] if own.size else -1
    a = jcd.vote_images(ids, db_img, q_img, q_var, len(jcd.VARIANTS))
    b = tcd.vote_images(ids, db_img, q_img, q_var, len(tcd.VARIANTS))
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1]


def test_copydays_workflow_matches_reference():
    """``test_system.py``'s workflow: 400 images of 24 descriptors, 40
    originals, k = 10 votes; per-variant recall@1 equal on both packages,
    the mild variant near-perfect as the reference asks."""
    n_images, dpi, dim = 400, 24, 32
    vecs_np, img_ids = jsynth.sample_images(n_images, dpi, dim, seed=0)
    mesh = _mesh()
    jt = j_build_tree(jnp.asarray(vecs_np), (8, 8), key=jax.random.PRNGKey(1))
    ji = j_build_index(jnp.asarray(vecs_np), jt, mesh, wire_dtype=jnp.float32)
    tt = interop.tree_from_numpy([np.asarray(lvl) for lvl in jt.levels],
                                 device="cpu")
    ti = build_index(vecs_np, tt, wire_dtype=torch.float32, device="cpu")
    originals = np.random.default_rng(3).choice(n_images, 40, replace=False)
    rows = np.isin(img_ids, originals)
    cd = tcd.make_copydays(vecs_np[rows], img_ids[rows], seed=4)
    jr = j_batch_search(ji, jt, jnp.asarray(cd.query_vecs), k=10, mesh=mesh,
                        q_cap=1024)
    tr = batch_search(ti, tt, cd.query_vecs, 10, q_cap=1024, device="cpu")
    assert int(jr.q_cap_overflow) == int(tr.q_cap_overflow) == 0
    nv = len(tcd.VARIANTS)
    jv, javg = jcd.vote_images(np.array(jr.ids), img_ids, cd.query_img,
                               cd.query_variant, nv)
    tv, tavg = tcd.vote_images(tr.ids.numpy(), img_ids, cd.query_img,
                               cd.query_variant, nv)
    np.testing.assert_array_equal(jv, tv)
    assert javg == tavg
    assert tv[0] >= 0.9 and tavg >= 0.5, (tv, tavg)


def test_sift100m_constants_match_reference():
    for name in ("DIM", "FANOUTS", "N_LEAVES", "INDEX_ROWS", "WAVE_ROWS",
                 "CAPACITY_FACTOR", "K"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert tcfg.N_LEAVES == int(np.prod(tcfg.FANOUTS))
    for name, shape in (("search_32k", tcfg.SEARCH_32K),
                        ("search_1m", tcfg.SEARCH_1M)):
        # the reference's cell closes over its batch shape
        fn = jcfg.ARCH.cells[name]().make_fn
        ref = {v: c.cell_contents
               for v, c in zip(fn.__code__.co_freevars, fn.__closure__)}
        assert {key: ref[key] for key in shape} == shape, name


def test_sift_smoke_on_the_cpu():
    out = tcfg.sift_smoke(device="cpu")
    assert out["top1_exact"] >= 62 / 64 and out["leaves"] == 64
