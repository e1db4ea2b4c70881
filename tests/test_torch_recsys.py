"""repro_torch's recsys family (DLRM, DIN, DIEN, two-tower) against the JAX
package's ``models/recsys.py`` on the CPU, at the reference's smoke sizes.

One draw of weights a model (``init_params``' rule, from a seed) is carried
across as numpy to both packages (``interop.params_from_numpy``);
batches come from both packages' numpy generators, which must agree bit
for bit. Tolerances:

* ``embedding_bag`` (sum, mean, ``valid``) and ``field_lookup``: bit for
  bit (a gather and a sum over a handful of rows);
* ``dlrm_forward``, ``din_forward`` at ``gru_dim`` 0 and 16,
  ``twotower_score`` and ``pair_score``: every output within 1e-5 x the
  reference's largest |output| (fp32 sums in another order through two to
  four products, DIEN's through 2 x 20 recurrent steps);
* each loss within 1e-5 (relative), every gradient leaf within 1e-4 x that
  leaf's largest entry of ``jax.value_and_grad`` (``tests/test_torch_train.py``'s
  rule), a bias within 1e-4 x its layer's largest entry (its own or its
  weight's): a bias's gradient sums the batch's upstream gradients, which
  can cancel far below their rounding -- DIEN's output bias is 7.6e-6
  from terms of about 0.008 under balanced labels, and each package's
  fp32 sum lies 4e-9 to 1.1e-8 from a float64 one;
* one ``make_train_step`` step against the reference's, to that file's
  tolerances: params within 1e-5 x each leaf's largest entry plus
  2 x lr x 1e-4, ``m`` and ``v`` within 1e-4 x (a bias's within its
  layer's, as its gradient), ``step`` equal, loss and grad norm within 1e-5
  (relative). Entries whose gradient is below 1e-6 (100 x Adam's eps) are
  held through ``m`` and ``v`` only: the first step moves them by
  lr x g / (|g| + eps), which turns the gradient's absolute error into a
  move of up to lr (one of DIEN's 36,000 table entries has a gradient of
  1.48e-9 in the reference, 1.47e-9 here: its move differs by 7.6e-7);
* the slice as a whole: the carried item tower's embeddings of 2,048
  candidates (d = 32) and 64 users' embeddings, built into an index and
  searched by both packages on the reference's tree carried across
  (``interop.tree_from_numpy``; the reference on an Auto-axes mesh, R1, at
  ``impl="xla"``, R2): ids equal, distances within P1's 1e-6 x ||q||^2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs.two_tower import pair_score as j_pair_score
from repro.core import index_build as jib
from repro.core import search as jsearch
from repro.core.tree import build_tree as j_build_tree
from repro.data import batches as jbatches
from repro.models import recsys as jrec
from repro.train import AdamWConfig as JAdamW
from repro.train import make_train_step as j_make_train_step
from repro.train.step import init_train_state as j_init_train_state
from repro_torch import batch_search, build_index, interop
from repro_torch.configs import recsys as crec
from repro_torch.data import batches as tbatches
from repro_torch.models import recsys as trec
from repro_torch.models.module import init_params
from repro_torch.train import AdamWConfig, make_train_step, tree
from repro_torch.train.step import init_train_state

# the reference's smoke configurations (configs/{dlrm_rm2,din,two_tower}.py)
DLRM = dict(name="dlrm-smoke", vocab_per_field=1000, embed_dim=16, bot_mlp=(32, 16),
            top_mlp=(32, 16, 1))
DIN = dict(name="din-smoke", vocab=2000, seq_len=20, attn_mlp=(16, 8), mlp=(24, 12))
TT = dict(name="tt-smoke", vocab_per_field=1000, field_dim=16, tower_mlp=(64, 32),
          embed_dim=32)
MODELS = {  # name: (port config, reference config, port loss, reference loss)
    "dlrm": (trec.DLRMConfig(**DLRM), jrec.DLRMConfig(**DLRM), trec.dlrm_loss,
             jrec.dlrm_loss),
    "din": (trec.DINConfig(**DIN), jrec.DINConfig(**DIN), trec.din_loss, jrec.din_loss),
    "dien": (trec.DINConfig(**DIN, gru_dim=16), jrec.DINConfig(**DIN, gru_dim=16),
             trec.din_loss, jrec.din_loss),
    "two-tower": (trec.TwoTowerConfig(**TT), jrec.TwoTowerConfig(**TT),
                  trec.twotower_loss, jrec.twotower_loss),
}
_JIT = {}  # the reference's weights and results, once a model


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread in this module: its ops here are tiny, and a
    pool of threads costs more than it brings (several times, measured)."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _batch(name, seed=1, b=64):
    if name == "dlrm":
        return tbatches.dlrm_batch(b, 13, 26, 1000, seed=seed)
    if name in ("din", "dien"):
        return tbatches.din_batch(b, 20, 2000, seed=seed)
    return tbatches.twotower_batch(b, 4, 4, 1000, seed=seed)


def _weights(name):
    """One draw of weights a model, as numpy (``init_params``' rule: normal
    x 1/sqrt(fan_in) or the spec's scale, zero biases), handed to both
    packages: the reference's as arrays, the port's through
    ``interop.params_from_numpy``."""
    if ("weights", name) not in _JIT:
        tc = MODELS[name][0]
        drawn = init_params(tc.param_specs(), torch.Generator().manual_seed(0),
                            device="cpu")
        _JIT[("weights", name)] = ({k: v.numpy() for k, v in drawn.items()}, tc)
    np_params, tc = _JIT[("weights", name)]
    return (jax.tree.map(jnp.asarray, np_params),
            interop.params_from_numpy(np_params, tc, device="cpu"))


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _close(got, want, rel, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= rel * float(np.abs(want).max()), (what, err)


def _layer_scale(name: str, grads) -> float:
    """A leaf's scale: its largest |entry|, or for a bias (``<p>_b<i>``,
    ``<gru>_b``) its layer's (the bias's and its weights')."""
    head, _, tail = name.rpartition("_")
    names = [name]
    if tail.startswith("b") and tail[1:].isdigit():
        names.append(f"{head}_w{tail[1:]}")
    elif tail == "b":
        names += [f"{head}_wx", f"{head}_wh"]
    return max(float(np.abs(_np(grads[n])).max()) for n in names if n in grads)


def _close_grads(got, want, rel, what=""):
    for name in want:
        g, w = _np(got[name]), _np(want[name])
        assert g.shape == w.shape, (what, name)
        assert np.abs(g - w).max() <= rel * _layer_scale(name, want), (what, name)


# ---------------------------------------------------------------------------
# the shared substrate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("masked", [False, True])
def test_embedding_bag_bit_for_bit(mode, masked):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, (6, 4)).astype(np.int32)
    valid = rng.random((6, 4)) < 0.7 if masked else None
    want = jrec.embedding_bag(jnp.asarray(table), jnp.asarray(ids), mode=mode,
                              valid=None if valid is None else jnp.asarray(valid))
    got = trec.embedding_bag(torch.as_tensor(table), ids, mode=mode, valid=valid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_field_lookup_bit_for_bit():
    rng = np.random.default_rng(1)
    tables = rng.standard_normal((5, 30, 6)).astype(np.float32)
    ids = rng.integers(0, 30, (7, 5)).astype(np.int32)
    want = jrec.field_lookup(jnp.asarray(tables), jnp.asarray(ids))
    got = trec.field_lookup(torch.as_tensor(tables), ids)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dot_interaction_is_the_upper_triangle():
    z = torch.as_tensor(np.random.default_rng(2).standard_normal((3, 5, 4)),
                        dtype=torch.float32)
    gram = z @ z.transpose(1, 2)
    iu, ju = np.triu_indices(5, k=1)
    np.testing.assert_array_equal(trec.dot_interaction(z).numpy(),
                                  gram[:, iu, ju].numpy())


# ---------------------------------------------------------------------------
# forwards, losses, gradients and a train step against the reference
# ---------------------------------------------------------------------------


LR = 1e-3  # the train step's learning rate
CANDS = np.random.default_rng(2).integers(0, 1000, (256, 4), dtype=np.int32)


def _serve(b):
    return {k: v for k, v in b.items() if k != "label"}


FORWARDS = {  # name: (model, port forward, reference forward, batch)
    "dlrm": ("dlrm", trec.dlrm_forward, jrec.dlrm_forward, _serve),
    "din": ("din", trec.din_forward, jrec.din_forward, _serve),
    "dien": ("dien", trec.din_forward, jrec.din_forward, _serve),
    "twotower_score": ("two-tower", trec.twotower_score, jrec.twotower_score,
                       lambda b: {"user_ids": b["user_ids"][:1], "cand_ids": CANDS}),
    "pair_score": ("two-tower", trec.pair_score, j_pair_score, lambda b: b),
}


def _reference(name):
    """The reference's forwards, loss and gradients and one train step of
    model ``name``, all on ``_batch(name)``: one jitted function a model
    (XLA shares the common subgraphs), run once."""
    if ("reference", name) not in _JIT:
        _, jc, _, jloss = MODELS[name]
        fwds = {f: (jfn, make) for f, (m, _, jfn, make) in FORWARDS.items() if m == name}
        step = j_make_train_step(lambda p, b: jloss(p, jc, b), JAdamW(lr=LR))

        def run(p, fb, b):
            out = {f: jfn(p, jc, fb[f]) for f, (jfn, _) in fwds.items()}
            out["grad"] = jax.value_and_grad(lambda q: jloss(q, jc, b), has_aux=True)(p)
            out["step"] = step(p, j_init_train_state(p), b)
            return out

        fb = {f: make(_batch(name)) for f, (_, make) in fwds.items()}
        args = jax.tree.map(jnp.asarray, (fb, _batch(name)))
        _JIT[("reference", name)] = (jax.jit(run)(_weights(name)[0], *args), fb)
    return _JIT[("reference", name)]


@pytest.mark.parametrize("fwd", list(FORWARDS))
def test_forward_matches_the_reference(fwd):
    name, tfn = FORWARDS[fwd][:2]
    want, fb = _reference(name)
    got = tfn(_weights(name)[1], MODELS[name][0], fb[fwd], device="cpu")
    assert got.dtype == torch.float32
    _close(got, want[fwd], 1e-5, fwd)


def _port_grads(params, name, batch):
    tc, _, tloss, _ = MODELS[name]
    leaves = [p.detach().clone().requires_grad_() for p in tree.leaves(params)]
    loss, aux = tloss(tree.unflatten(params, leaves), tc, batch, device="cpu")
    return loss, aux, tree.unflatten(params, torch.autograd.grad(loss, leaves))


@pytest.mark.parametrize("name", list(MODELS))
def test_loss_and_gradients_match_the_reference(name):
    (jl, jaux), jg = _reference(name)[0]["grad"]
    loss, aux, grads = _port_grads(_weights(name)[1], name, _batch(name))
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    assert set(aux) == set(jaux)
    for key in aux:
        assert float(aux[key].detach()) == pytest.approx(float(jaux[key]), rel=1e-5), key
    assert sorted(grads) == sorted(jg)
    _close_grads(grads, jg, 1e-4, what=name)


@pytest.mark.parametrize("name", list(MODELS))
def test_train_step_matches_the_reference(name):
    tc, _, tloss, _ = MODELS[name]
    jp, js, jm = _reference(name)[0]["step"]
    tfn = make_train_step(lambda p, b: tloss(p, tc, b, device="cpu"), AdamWConfig(lr=LR))
    tp = _weights(name)[1]
    tp, ts, tm = tfn(tp, init_train_state(tp), _batch(name))
    assert int(ts["step"]) == int(js["step"]) == 1
    for key in ("loss", "grad_norm"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5), key
    _close_grads(ts["m"], js["m"], 1e-4, what=name + " m")
    _close_grads(ts["v"], js["v"], 1e-4, what=name + " v")
    for key in jp:
        g, w = _np(tp[key]), _np(jp[key])
        moved = np.abs(_np(js["m"][key])) >= 0.1 * 1e-6  # m = (1 - b1) g
        tol = 1e-5 * float(np.abs(w).max()) + 2 * LR * 1e-4
        assert (np.abs(g - w)[moved] <= tol).all(), (name, key)


def test_gru_remat_gives_identical_gradients(monkeypatch):
    """Under grad the GRU loops checkpoint every ``GRU_REMAT`` steps and
    recompute them in the backward: the same bits as the plain loop, at
    the module's interval and at one that does not divide T."""
    tp = init_params(MODELS["dien"][0].param_specs(), torch.Generator().manual_seed(4),
                     device="cpu")
    batch = _batch("dien", seed=6, b=16)

    def grads():
        leaves = [p.detach().clone().requires_grad_() for p in tree.leaves(tp)]
        loss, _ = trec.din_loss(tree.unflatten(tp, leaves), MODELS["dien"][0], batch,
                                device="cpu")
        return loss, torch.autograd.grad(loss, leaves)

    out = {"remat": grads()}
    monkeypatch.setattr(trec, "GRU_REMAT", 7)
    out["remat 7"] = grads()
    with monkeypatch.context() as m:  # the plain loop: no checkpoint
        m.setattr(trec.torch_checkpoint, "checkpoint",
                  lambda fn, *a, use_reentrant: fn(*a))
        plain = grads()
    for name, (loss, g) in out.items():
        assert torch.equal(loss, plain[0]), name
        for a, b in zip(g, plain[1]):
            assert torch.equal(a, b), name


def test_params_carry_rejects_a_wrong_tree():
    tc = MODELS["dlrm"][0]
    jp = jax.tree.map(np.asarray, _weights("dlrm")[0])
    with pytest.raises(ValueError, match="keys"):
        interop.params_from_numpy({k: v for k, v in jp.items() if k != "top_b0"},
                                  tc, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        interop.params_from_numpy(dict(jp, extra=jp["top_b0"]), tc, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        interop.params_from_numpy(dict(jp, tables=jp["tables"][:, :10]), tc,
                                  device="cpu")


# ---------------------------------------------------------------------------
# generators, properties, smokes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gen,args", [
    ("dlrm_batch", (300, 13, 26, 1000)), ("din_batch", (300, 20, 2000)),
    ("twotower_batch", (300, 4, 4, 1000)), ("lm_batch", (3, 16, 256))])
def test_batches_bit_for_bit(gen, args):
    for seed in (0, 7):
        want = getattr(jbatches, gen)(*args, seed=seed)
        got = getattr(tbatches, gen)(*args, seed=seed)
        assert list(got) == list(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


def test_din_padding_history_is_masked():
    cfg = trec.DINConfig(name="d", vocab=100, seq_len=6, attn_mlp=(8,), mlp=(8,))
    params = init_params(cfg.param_specs(), torch.Generator().manual_seed(0),
                         device="cpu")
    t = np.asarray([42])

    def score(hist):
        return float(trec.din_forward(params, cfg, {"hist": np.asarray([hist]),
                                                    "target": t}, device="cpu")[0])

    s1 = score([3, 4, 5, 0, 0, 0])
    assert s1 == score([3, 4, 5, 0, 0, 0])
    assert abs(s1 - score([3, 4, 5, 7, 9, 11])) > 1e-7  # real items change it


def test_twotower_training_separates_pairs():
    cfg = trec.TwoTowerConfig(name="tt", vocab_per_field=200, field_dim=8,
                              tower_mlp=(32, 16), embed_dim=16)
    params = init_params(cfg.param_specs(), torch.Generator().manual_seed(0),
                         device="cpu")
    state = init_train_state(params)
    step = make_train_step(lambda p, b: trec.twotower_loss(p, cfg, b, device="cpu"),
                           AdamWConfig(lr=3e-3))
    accs = []
    for i in range(30):
        params, state, m = step(params, state,
                                tbatches.twotower_batch(32, 4, 4, 200, seed=i % 4))
        accs.append(float(m["acc"]))
    assert np.mean(accs[-5:]) > np.mean(accs[:5]) + 0.2, accs[::6]


@pytest.mark.parametrize("smoke", ["dlrm", "din", "dien", "two-tower"])
def test_smokes_run_on_the_cpu(smoke):
    fn = {"dlrm": crec.dlrm_smoke, "din": lambda device: crec.din_smoke(0, device),
          "dien": lambda device: crec.din_smoke(16, device),
          "two-tower": crec.twotower_smoke}[smoke]
    out = fn(device="cpu")
    assert np.isfinite(out["loss"]) and out["params"] > 0


def test_full_configs_are_the_references():
    from repro.configs import dien, din, dlrm_rm2, two_tower

    for port, ref in ((crec.DLRM_RM2, dlrm_rm2.CONFIG), (crec.DIN, din.CONFIG),
                      (crec.DIEN, dien.CONFIG), (crec.TWO_TOWER, two_tower.CONFIG)):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
    assert crec.DLRM_FLOPS_PER_SAMPLE == dlrm_rm2.FLOPS_PER_SAMPLE
    assert crec.din_flops_per_sample(crec.DIN) == din.din_flops_per_sample(din.CONFIG)
    assert crec.dien_flops_per_sample(crec.DIEN) == dien.dien_flops_per_sample(dien.CONFIG)
    assert crec.TOWER_FLOPS == two_tower._TOWER_FLOPS


# ---------------------------------------------------------------------------
# the slice as a whole: the towers' candidates through the index
# ---------------------------------------------------------------------------


def test_retrieval_through_the_index_matches_the_reference():
    tc = MODELS["two-tower"][0]
    tp = _weights("two-tower")[1]
    rng = np.random.default_rng(9)
    cand = rng.integers(0, 1000, (2048, 4)).astype(np.int32)
    users = rng.integers(0, 1000, (64, 4)).astype(np.int32)
    with torch.no_grad():
        items = trec.tower(tp, tc, "item", cand, device="cpu").numpy()
        queries = trec.tower(tp, tc, "user", users, device="cpu").numpy()
    mesh = Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))
    jt = j_build_tree(jnp.asarray(items), (8, 8), key=jax.random.PRNGKey(2))
    ji = jib.build_index(jnp.asarray(items), jt, mesh, wire_dtype=jnp.float32)
    tt = interop.tree_from_numpy([np.asarray(lvl) for lvl in jt.levels], device="cpu")
    ti = build_index(items, tt, wire_dtype=torch.float32, device="cpu")
    for f in ("ids", "leaves", "offsets"):
        np.testing.assert_array_equal(getattr(ti, f).numpy().reshape(-1),
                                      np.asarray(getattr(ji, f)).reshape(-1), f)
    for probes, impl in ((1, "xla"), (3, "fused")):
        want = jsearch.batch_search(ji, jt, jnp.asarray(queries), k=10, mesh=mesh,
                                    probes=probes, impl="xla")
        got = batch_search(ti, tt, queries, 10, probes=probes, impl=impl, device="cpu")
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
        jd = np.asarray(want.dists)
        tol = 1e-6 * (queries.astype(np.float64) ** 2).sum(1)[:, None]
        fin = np.isfinite(jd)
        assert (np.abs(got.dists.numpy()[fin] - jd[fin])
                <= np.broadcast_to(tol, jd.shape)[fin]).all()
        assert int(got.pairs) == int(want.pairs)
