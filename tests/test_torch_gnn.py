"""repro_torch's GIN and graph data against the JAX package's
``models/gnn.py`` and ``data/graph.py`` on the CPU.

One draw of weights (``init_params``' rule, from a seed) is carried
across as numpy to both packages (``interop.params_from_numpy``, the
stacked ``(L-1, h, h)`` weights kept stacked); graphs come from both
packages' generators, which must agree bit for bit. Tolerances:

* ``forward`` on a padded full graph and on a neighbor-sampled minibatch:
  every logit within 1e-5 x the reference's largest |logit| (fp32 sums in
  another order through three layers of segment sums and products);
* ``loss_fn`` within 1e-5 (relative), every gradient leaf within 1e-4 x
  its largest entry of ``jax.value_and_grad``, a bias within 1e-4 x its
  layer's (its own or its weight's: a bias's gradient sums every node's
  upstream gradient, which can cancel);
* one ``make_train_step`` step: params within 1e-5 x each leaf's largest
  entry plus 2 x lr x 1e-4 where the gradient exceeds 1e-6 (100 x Adam's
  eps), ``m`` and ``v`` as the gradients, ``step`` equal, loss and grad
  norm within 1e-5 (relative);
* the properties of ``tests/test_models.py``'s GIN cases, on the port: the
  dense-adjacency oracle within 2e-4, edge order and padded edges within
  1e-5 (each destination sums in its edges' order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gin_tu
from repro.data import graph as jgraph
from repro.models import gnn as jgnn
from repro.train import AdamWConfig as JAdamW
from repro.train import make_train_step as j_make_train_step
from repro.train.step import init_train_state as j_init_train_state
from repro_torch import interop
from repro_torch.configs import gnn as cgnn
from repro_torch.data import graph as tgraph
from repro_torch.models import gnn as tgnn
from repro_torch.models.module import init_params
from repro_torch.train import AdamWConfig, make_train_step, tree
from repro_torch.train.step import init_train_state

SMOKE = dict(name="gin-smoke", n_layers=3, d_in=12, d_hidden=16, n_classes=4)
TC, JC = tgnn.GINConfig(**SMOKE), jgnn.GINConfig(**SMOKE)
LR = 1e-3
_CACHE = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread in this module: its ops here are tiny."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _batches():
    """The smoke's full-graph batch and its sampled minibatch (numpy)."""
    g = tgraph.random_graph(300, 6.0, seed=1)
    feats = np.random.default_rng(2).standard_normal((300, 12)).astype(np.float32)
    labels = np.random.default_rng(3).integers(0, 4, 300).astype(np.int32)
    edges = tgraph.to_edge_list(g)
    full = tgraph.pad_graph_batch(feats, edges, labels, n_nodes_pad=384,
                                  n_edges_pad=cgnn.round_up(edges.shape[1], 256))
    sub, sedges, n_seed = tgraph.neighbor_sample(g, np.arange(32), (5, 3), seed=4)
    sl = np.full(len(sub), -1, np.int32)
    sl[:n_seed] = labels[sub[:n_seed]]
    mini = tgraph.pad_graph_batch(feats[sub], sedges, sl, n_nodes_pad=640,
                                  n_edges_pad=640)
    return full, mini


def _weights():
    """One draw of GIN's weights as numpy (``init_params``' rule), handed
    to both packages: the reference's as arrays, the port's through
    ``interop.params_from_numpy``."""
    if "weights" not in _CACHE:
        drawn = init_params(TC.param_specs(), torch.Generator().manual_seed(0),
                            device="cpu")
        _CACHE["weights"] = {k: v.numpy() for k, v in drawn.items()}
    np_params = _CACHE["weights"]
    return (jax.tree.map(jnp.asarray, np_params),
            interop.params_from_numpy(np_params, TC, device="cpu"))


def _reference():
    """The reference's forwards on both batches, loss and gradients and one
    train step on the full batch: one jitted function, run once."""
    if "reference" not in _CACHE:
        step = j_make_train_step(lambda p, b: jgnn.loss_fn(p, JC, b), JAdamW(lr=LR))

        def run(p, full, mini):
            return {"full": jgnn.forward(p, JC, full), "mini": jgnn.forward(p, JC, mini),
                    "grad": jax.value_and_grad(lambda q: jgnn.loss_fn(q, JC, full),
                                               has_aux=True)(p),
                    "step": step(p, j_init_train_state(p), full)}

        _CACHE["reference"] = jax.jit(run)(
            _weights()[0], *jax.tree.map(jnp.asarray, _batches()))
    return _CACHE["reference"]


WEIGHT_OF = {"in_b1": "in_w1", "in_b2": "in_w2", "b1": "w1", "b2": "w2",
             "out_b": "out_w"}


def _layer_scale(name: str, grads) -> float:
    """A leaf's largest |entry|, or for a bias its layer's (its own or its
    weight's)."""
    names = [name, WEIGHT_OF.get(name, name)]
    return max(float(np.abs(_np(grads[n])).max()) for n in names)


def _close_grads(got, want, rel, what=""):
    for name in want:
        g, w = _np(got[name]), _np(want[name])
        assert g.shape == w.shape, (what, name)
        assert np.abs(g - w).max() <= rel * _layer_scale(name, want), (what, name)


@pytest.mark.parametrize("which", ["full", "mini"])
def test_forward_matches_the_reference(which):
    batch = dict(zip(("full", "mini"), _batches()))[which]
    got = tgnn.forward(_weights()[1], TC, batch, device="cpu")
    want = _np(_reference()[which])
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(_np(got) - want).max() <= 1e-5 * np.abs(want).max()


def test_loss_and_gradients_match_the_reference():
    (jl, jaux), jg = _reference()["grad"]
    leaves = [p.detach().clone().requires_grad_() for p in tree.leaves(_weights()[1])]
    params = tree.unflatten(_weights()[1], leaves)
    loss, aux = tgnn.loss_fn(params, TC, tgnn.prepare(_batches()[0], device="cpu"),
                             device="cpu")
    grads = tree.unflatten(params, torch.autograd.grad(loss, leaves))
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    assert float(aux["acc"]) == pytest.approx(float(jaux["acc"]), rel=1e-6)
    assert sorted(grads) == sorted(jg)
    _close_grads(grads, jg, 1e-4)


def test_train_step_matches_the_reference():
    jp, js, jm = _reference()["step"]
    step = make_train_step(lambda p, b: tgnn.loss_fn(p, TC, b, device="cpu"),
                           AdamWConfig(lr=LR))
    tp = _weights()[1]
    tp, ts, tm = step(tp, init_train_state(tp), tgnn.prepare(_batches()[0], device="cpu"))
    assert int(ts["step"]) == int(js["step"]) == 1
    for key in ("loss", "grad_norm"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5), key
    _close_grads(ts["m"], js["m"], 1e-4, "m")
    _close_grads(ts["v"], js["v"], 1e-4, "v")
    for key in jp:
        g, w = _np(tp[key]), _np(jp[key])
        moved = np.abs(_np(js["m"][key])) >= 0.1 * 1e-6  # m = (1 - b1) g
        tol = 1e-5 * float(np.abs(w).max()) + 2 * LR * 1e-4
        assert (np.abs(g - w)[moved] <= tol).all(), key


def test_params_keep_the_references_stacked_names():
    jp, tp = _weights()
    assert sorted(tp) == sorted(jp)
    assert tuple(tp["w1"].shape) == (SMOKE["n_layers"] - 1, 16, 16)
    np_state = jax.tree.map(np.asarray, j_init_train_state(jp))
    p2, s2 = interop.train_state_from_numpy(jax.tree.map(np.asarray, jp), np_state, TC,
                                            device="cpu")
    named = tree.named((p2, s2))
    assert "0/w1" in named and "1/m/w1" in named and "1/step" in named
    with pytest.raises(ValueError, match="shape"):
        interop.params_from_numpy(dict(jax.tree.map(np.asarray, jp),
                                       w1=np.zeros((4, 16, 16), np.float32)),
                                  TC, device="cpu")


# ---------------------------------------------------------------------------
# the properties of tests/test_models.py's GIN cases
# ---------------------------------------------------------------------------


def _small(n_layers=2, d_in=4, seed=0):
    cfg = tgnn.GINConfig(name="g", n_layers=n_layers, d_in=d_in, d_hidden=8,
                         n_classes=3)
    params = init_params(cfg.param_specs(), torch.Generator().manual_seed(seed),
                         device="cpu")
    with torch.no_grad():  # eps 0 and zero biases would hide their terms
        for key in ("eps", "in_b1", "b1", "out_b"):
            params[key].normal_(generator=torch.Generator().manual_seed(seed + 1))
    return cfg, params


def test_matches_the_dense_adjacency_oracle():
    cfg, params = _small(d_in=6)
    rng = np.random.default_rng(1)
    N, E = 20, 60
    feats = rng.standard_normal((N, 6)).astype(np.float32)
    edges = rng.integers(0, N, (2, E))
    batch = {"feats": feats, "edges": edges, "edge_w": np.ones(E, np.float32),
             "labels": np.zeros(N, np.int32)}
    with torch.no_grad():
        logits = tgnn.forward(params, cfg, batch, device="cpu").numpy()
    A = np.zeros((N, N), np.float64)
    for s, d in edges.T:
        A[d, s] += 1.0
    P = {k: v.double().numpy() for k, v in params.items()}

    def relu(x):
        return np.maximum(x, 0)

    h = feats.astype(np.float64)
    z = (1 + P["eps"][0]) * h + A @ h
    h = relu(relu(z @ P["in_w1"] + P["in_b1"]) @ P["in_w2"] + P["in_b2"])
    z = (1 + P["eps"][1]) * h + A @ h
    h = relu(relu(z @ P["w1"][0] + P["b1"][0]) @ P["w2"][0] + P["b2"][0])
    np.testing.assert_allclose(logits, h @ P["out_w"] + P["out_b"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edge_order_invariance(seed):
    cfg, params = _small()
    rng = np.random.default_rng(seed)
    N, E = 15, 40
    feats = rng.standard_normal((N, 4)).astype(np.float32)
    edges = rng.integers(0, N, (2, E))
    b1 = {"feats": feats, "edges": edges, "edge_w": np.ones(E, np.float32),
          "labels": np.zeros(N, np.int32)}
    b2 = dict(b1, edges=edges[:, rng.permutation(E)])
    with torch.no_grad():
        np.testing.assert_allclose(tgnn.forward(params, cfg, b1, device="cpu").numpy(),
                                   tgnn.forward(params, cfg, b2, device="cpu").numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_padded_edges_are_noops():
    cfg, params = _small()
    rng = np.random.default_rng(3)
    N, E = 15, 30
    feats = rng.standard_normal((N, 4)).astype(np.float32)
    edges = rng.integers(0, N, (2, E))
    b1 = {"feats": feats, "edges": edges, "edge_w": np.ones(E, np.float32),
          "labels": np.zeros(N, np.int32)}
    b2 = dict(b1, edges=np.concatenate([edges, np.zeros((2, 10), np.int64)], 1),
              edge_w=np.concatenate([np.ones(E, np.float32), np.zeros(10, np.float32)]))
    with torch.no_grad():
        np.testing.assert_allclose(tgnn.forward(params, cfg, b1, device="cpu").numpy(),
                                   tgnn.forward(params, cfg, b2, device="cpu").numpy(),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# graph data, configs, the smoke
# ---------------------------------------------------------------------------


def _same(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for key in want:
            _same(got[key], want[key])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("power_law", [True, False])
def test_graph_generators_bit_for_bit(power_law):
    for seed in (0, 5):
        jg = jgraph.random_graph(500, 7.5, seed=seed, power_law=power_law)
        tg = tgraph.random_graph(500, 7.5, seed=seed, power_law=power_law)
        _same((tg.indptr, tg.indices, tg.n_nodes, tg.n_edges),
              (jg.indptr, jg.indices, jg.n_nodes, jg.n_edges))
        _same(tgraph.to_edge_list(tg), jgraph.to_edge_list(jg))
        for fanouts in ((5, 3), (4, 4, 2)):
            _same(tgraph.neighbor_sample(tg, np.arange(40), fanouts, seed=seed + 1),
                  jgraph.neighbor_sample(jg, np.arange(40), fanouts, seed=seed + 1))
    feats = np.random.default_rng(0).standard_normal((50, 3)).astype(np.float32)
    edges = np.random.default_rng(1).integers(0, 50, (2, 70))
    labels = np.random.default_rng(2).integers(0, 3, 50).astype(np.int32)
    _same(tgraph.pad_graph_batch(feats, edges, labels, n_nodes_pad=64, n_edges_pad=96),
          jgraph.pad_graph_batch(feats, edges, labels, n_nodes_pad=64, n_edges_pad=96))
    with pytest.raises(ValueError, match="exceeds pad"):
        tgraph.pad_graph_batch(feats, edges, labels, n_nodes_pad=64, n_edges_pad=32)
    _same(tgraph.molecule_batch(8, 30, 64, 16, 2, seed=3),
          jgraph.molecule_batch(8, 30, 64, 16, 2, seed=3))


def test_shapes_and_flops_are_the_references():
    assert cgnn.SHAPES == gin_tu.SHAPES
    for name, spec in cgnn.SHAPES.items():
        assert cgnn.padded(spec) == gin_tu._padded(spec)
        cfg = cgnn.gin_config(name)
        jcfg = jgnn.GINConfig(name="gin-tu", n_layers=5, d_hidden=64, d_in=spec["d_in"],
                              n_classes=spec["n_classes"])
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        p = cgnn.padded(spec)
        assert cgnn.gin_flops(cfg, p["nodes"], p["edges"]) == gin_tu._mlp_flops_gin(
            jcfg, p["nodes"], p["edges"])
        assert cfg.param_count() == jcfg.param_count()


def test_smoke_runs_on_the_cpu():
    out = cgnn.gin_smoke(device="cpu")
    assert np.isfinite(out["loss"]) and np.isfinite(out["mb_loss"])
    assert out["params"] == TC.param_count()
