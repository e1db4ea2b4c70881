"""repro_torch training against the JAX package's, on the CPU.

The reference's weights (``init_params`` with a JAX key) are carried across
as numpy (``interop.transformer_params_from_numpy``, fp32 master weights);
batches come from ``lm_batch``, optimizer inputs are made with numpy from a
seed. At the three smoke configurations (dense internlm2; gemma with a
window, qk_norm and scale_embed; moonshot's MoE), with full and chunked
attention:

* ``loss_fn`` within 1e-5 (relative) of the reference's, and every gradient
  leaf within 1e-4 x that leaf's largest entry of
  ``jax.value_and_grad(repro.models.transformer.loss_fn)`` (fp32 sums in
  another order, through two layers and a softmax over the vocabulary);
* the three remat modes give bit-identical gradients;
* the optimizer and the compressors on the same numpy inputs as the
  reference's: ``warmup_cosine`` and ``adamw_update`` within 1e-6
  (relative), the compressors bit for bit; the properties of
  ``tests/test_train_ckpt.py`` (convergence on a quadratic, clipping,
  error-feedback mass, top-k sparsity, microbatch = full batch);
* three ``make_train_step`` steps against the reference's at microbatches
  1 and 2, compress None and bf16: params within 1e-5 x each leaf's
  largest entry plus 2 x lr x 1e-4 (an Adam step moves an entry by up to lr
  whatever its gradient's size, so a gradient near 0 whose last bits
  differ may move it differently), ``m`` and ``v`` within 1e-4 x, the
  feedback within 0.05 x (a residual is at most 2^-9 of the gradient it
  came from and carries that gradient's own 1e-4), ``step`` equal, the loss and grad norm within
  1e-5 (relative), ``lr`` within 1e-7 (relative). With bf16 compression a
  gradient whose fp32 value differs in its last bits may round to the next
  bf16 value (2^-8 away) on one side, and the flip carries into later
  steps: at most 1 % of a leaf's entries may differ by more.

``warmup_cosine`` is held within 1e-6, not 1e-7: torch's and XLA's cos
differ by an ulp, which 1 + cos amplifies near the schedule's end.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_4b, internlm2_18b, moonshot_v1_16b
from repro.models import transformer as jtfm
from repro.models.module import init_params as j_init_params
from repro.train import grad_compress as jgc
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import interop
from repro_torch.configs import lm
from repro_torch.data.batches import lm_batch
from repro_torch.models import transformer as tfm
from repro_torch.train import grad_compress as tgc
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep
from repro_torch.train import tree

SMOKES = {  # port config, reference config
    "internlm2-1.8b-smoke": (lm.INTERNLM2_18B_SMOKE, internlm2_18b.SMOKE_CONFIG),
    "gemma3-4b-smoke": (lm.GEMMA3_4B_SMOKE, gemma3_4b.SMOKE_CONFIG),
    "moonshot-smoke": (lm.MOONSHOT_V1_16B_SMOKE, moonshot_v1_16b.SMOKE_CONFIG),
}
ATTN = {"full": dict(attn_impl="full"), "chunked": dict(attn_impl="chunked", attn_chunk=8)}


def _pair(name, **changes):
    tc, jc = SMOKES[name]
    return dataclasses.replace(tc, **changes), dataclasses.replace(jc, **changes)


def _weights(jc, tc, seed=0):
    jp = j_init_params(jc.param_specs(), jax.random.PRNGKey(seed))
    return jp, interop.transformer_params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                                     device="cpu")


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _close_tree(got, want, rel, *, atol=0.0, flips=0.0, what=""):
    """Every leaf of the port's tree within ``rel`` x the leaf's largest
    entry (plus ``atol``) of the reference's, but for at most a share
    ``flips`` of each leaf's entries (see the train-step test)."""
    jleaves = jax.tree_util.tree_flatten_with_path(want)[0]
    tleaves = list(tree.items(got))
    assert len(jleaves) == len(tleaves), what
    for (jpath, w), (tpath, g) in zip(jleaves, tleaves):
        w, g = _np(w), _np(g)
        assert g.shape == w.shape, (what, tpath)
        bad = np.abs(g - w) > rel * float(np.abs(w).max()) + atol
        assert bad.mean() <= flips, (what, tpath, int(bad.sum()), bad.size)


def _port_grads(params, cfg, batch):
    leaves = [p.detach().clone().requires_grad_() for p in tree.leaves(params)]
    p = tree.unflatten(params, leaves)
    loss, aux = tfm.loss_fn(p, cfg, batch, device="cpu")
    return loss, aux, tree.unflatten(params, torch.autograd.grad(loss, leaves))


@pytest.mark.parametrize("attn", list(ATTN))
@pytest.mark.parametrize("name", list(SMOKES))
def test_loss_and_gradients_match_the_reference(name, attn):
    tc, jc = _pair(name, **ATTN[attn])
    jp, tp = _weights(jc, tc)
    batch = lm_batch(2, 16, tc.vocab_size, seed=1)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, jc, jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(jp)
    loss, aux, grads = _port_grads(tp, tc, batch)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert float(aux["loss"].detach()) == float(loss.detach())
    assert aux["moe_drops"].dtype == torch.int32
    assert int(aux["moe_drops"]) == int(jaux["moe_drops"])
    _close_tree(grads, jgrads, 1e-4, what=f"{name} {attn}")


@pytest.mark.parametrize("name", ["gemma3-4b-smoke", "moonshot-smoke"])
def test_remat_modes_give_identical_gradients(name):
    grads = {}
    for mode in ("none", "full", "dots"):
        tc, jc = _pair(name, remat=mode, attn_impl="chunked", attn_chunk=8)
        _, tp = _weights(jc, tc, seed=3)
        loss, _, g = _port_grads(tp, tc, lm_batch(2, 16, tc.vocab_size, seed=4))
        grads[mode] = (loss, tree.leaves(g))
    for mode in ("full", "dots"):
        assert torch.equal(grads[mode][0], grads["none"][0])
        for a, b in zip(grads[mode][1], grads["none"][1]):
            assert torch.equal(a, b), mode


def test_remat_dots_recomputes_all_but_the_matrix_products():
    """Ops the backward runs, by remat mode: ``"full"`` runs the layers'
    forward again (their ``mm``s and norms), ``"dots"`` runs their norms
    again but not their ``mm``s (kept), ``"none"`` runs neither."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            self.ops[name] = self.ops.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    runs = {}
    for mode in ("none", "full", "dots"):
        tc, jc = _pair("internlm2-1.8b-smoke", remat=mode)
        _, tp = _weights(jc, tc, seed=5)
        leaves = [p.detach().clone().requires_grad_() for p in tree.leaves(tp)]
        loss, _ = tfm.loss_fn(tree.unflatten(tp, leaves), tc,
                              lm_batch(2, 16, tc.vocab_size, seed=6), device="cpu")
        with Count() as c:
            torch.autograd.grad(loss, leaves)
        runs[mode] = c.ops
    norms = {m: runs[m].get("rsqrt", 0) for m in runs}
    mms = {m: runs[m].get("mm", 0) for m in runs}
    assert norms["none"] == 0 and norms["dots"] == norms["full"] > 0
    assert mms["dots"] == mms["none"] < mms["full"]


def test_remat_rejects_an_unknown_mode():
    tc, jc = _pair("internlm2-1.8b-smoke", remat="bogus")
    _, tp = _weights(jc, tc)
    with pytest.raises(ValueError, match="remat"):
        _port_grads(tp, tc, lm_batch(2, 8, tc.vocab_size, seed=1))


# ---------------------------------------------------------------------------
# optimizer and compression against the reference on the same inputs
# ---------------------------------------------------------------------------


def _trees(seed, shapes=((4, 3), (5,), (2, 2, 2))):
    rng = np.random.default_rng(seed)
    return {f"w{i}": rng.standard_normal(s).astype(np.float32) * 10.0 ** (i - 1)
            for i, s in enumerate(shapes)}


def _t(np_tree):
    return {k: torch.as_tensor(np.array(v)) for k, v in np_tree.items()}


def _j(np_tree):
    return {k: jnp.asarray(v) for k, v in np_tree.items()}


def test_warmup_cosine_matches_the_reference():
    for peak, warm, total in ((1e-3, 10, 60), (3e-4, 0, 5), (0.1, 7, 7)):
        j, t = jopt.warmup_cosine(peak, warm, total), topt.warmup_cosine(peak, warm, total)
        for step in range(0, total + 3):
            want = float(j(jnp.int32(step)))
            got = t(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12), (peak, step)


@pytest.mark.parametrize("clip,wd", [(1.0, 0.0), (None, 0.1), (1e-2, 0.01)])
def test_adamw_update_matches_the_reference(clip, wd):
    params, grads = _trees(0), _trees(1)
    cfg = dict(lr=topt.warmup_cosine(1e-2, 2, 10), weight_decay=wd, clip_norm=clip)
    jcfg = jopt.AdamWConfig(**dict(cfg, lr=jopt.warmup_cosine(1e-2, 2, 10)))
    tcfg = topt.AdamWConfig(**cfg)
    jp, js = _j(params), jopt.init_opt_state(_j(params))
    tp = _t(params)
    ts = topt.init_opt_state(tp)
    for i in range(3):
        g = _trees(10 + i)
        jp, js, jm = jopt.adamw_update(jp, _j(g), js, jcfg)
        tp, ts, tm = topt.adamw_update(tp, _t(g), ts, tcfg)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        assert ts["step"].dtype == torch.int32
        for key in ("grad_norm", "lr"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-6)
        for a, b in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
            for k in a:
                np.testing.assert_allclose(_np(a[k]), np.asarray(b[k]), rtol=1e-6,
                                           atol=1e-6 * float(np.abs(b[k]).max()))


def test_global_norm_matches_the_reference():
    g = _trees(2)
    assert float(topt.global_norm(_t(g))) == pytest.approx(
        float(jopt.global_norm(_j(g))), rel=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compressors_match_the_reference_bit_for_bit(seed):
    g, r = _trees(20 + seed), _trees(30 + seed)
    r = {k: v * 1e-3 for k, v in r.items()}
    jc, jr = jgc.bf16_compress(_j(g), _j(r))
    tc, tr = tgc.bf16_compress(_t(g), _t(r))
    for k in g:
        assert tc[k].dtype == torch.bfloat16 and tr[k].dtype == torch.float32
        np.testing.assert_array_equal(_np(tc[k]), np.asarray(jc[k], np.float32))
        np.testing.assert_array_equal(tr[k].numpy(), np.asarray(jr[k]))
    for frac in (0.01, 0.25, 0.5):
        jc, jr = jgc.topk_compress(_j(g), _j(r), fraction=frac)
        tc, tr = tgc.topk_compress(_t(g), _t(r), fraction=frac)
        for k in g:
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
            np.testing.assert_array_equal(tr[k].numpy(), np.asarray(jr[k]))
    fb = tgc.init_feedback(_t(g))
    assert all(v.dtype == torch.float32 and not v.any() for v in fb.values())


# ---------------------------------------------------------------------------
# the properties of tests/test_train_ckpt.py
# ---------------------------------------------------------------------------


def _quad_loss(p, batch):
    r = p["w"] * batch["x"] - batch["y"]
    return (r * r).mean(), {"loss": (r * r).mean()}


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor(5.0)}
    state = topt.init_opt_state(params)
    cfg = topt.AdamWConfig(lr=0.1, clip_norm=None)
    batch = {"x": torch.ones(()), "y": torch.tensor(2.0)}
    for _ in range(200):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(_quad_loss({"w": w}, batch)[0], [w])
        params, state, _ = topt.adamw_update(params, {"w": g}, state, cfg)
    assert abs(float(params["w"]) - 2.0) < 1e-2


def test_grad_clip_bounds_update():
    params = {"w": torch.tensor(0.0)}
    state = topt.init_opt_state(params)
    cfg = topt.AdamWConfig(lr=1.0, clip_norm=1e-3)
    _, _, metrics = topt.adamw_update(params, {"w": torch.tensor(1e6)}, state, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(1e6)


@pytest.mark.parametrize("seed", [0, 7, 99])
def test_bf16_error_feedback_conserves_mass(seed):
    g = {"a": torch.as_tensor(np.random.default_rng(seed).standard_normal(64)
                              .astype(np.float32) * 1e-3)}
    fb = tgc.init_feedback(g)
    total, sent = torch.zeros(64), torch.zeros(64)
    for _ in range(8):
        comp, fb = tgc.bf16_compress(g, fb)
        sent = sent + comp["a"].float()
        total = total + g["a"]
    np.testing.assert_allclose((sent + fb["a"]).numpy(), total.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_topk_compression_sparsity_and_feedback():
    g = {"a": torch.arange(1.0, 101.0)}
    comp, fb = tgc.topk_compress(g, tgc.init_feedback(g), fraction=0.1)
    assert int((comp["a"] != 0).sum()) == 10
    np.testing.assert_allclose((comp["a"] + fb["a"]).numpy(), g["a"].numpy(), rtol=1e-6)


def test_microbatch_equals_full_batch():
    cfg = topt.AdamWConfig(lr=1e-2)

    def loss(p, b):
        r = b["x"] @ p["w"] - b["y"]
        return (r * r).mean(), {"loss": (r * r).mean()}

    rng = np.random.default_rng(0)
    batch = {"x": torch.as_tensor(rng.standard_normal((16, 2)).astype(np.float32)),
             "y": torch.as_tensor(rng.standard_normal(16).astype(np.float32))}
    p1 = {"w": torch.tensor([1.0, -1.0])}
    p2 = {"w": torch.tensor([1.0, -1.0])}
    p1, _, m1 = tstep.make_train_step(loss, cfg)(p1, tstep.init_train_state(p1), batch)
    p2, _, m2 = tstep.make_train_step(loss, cfg, microbatches=4)(
        p2, tstep.init_train_state(p2), batch)
    np.testing.assert_allclose(p1["w"].detach().numpy(), p2["w"].detach().numpy(),
                               rtol=1e-5)
    assert p2["w"].requires_grad


def test_train_step_rejects_an_unknown_compressor():
    with pytest.raises(ValueError, match="compress"):
        tstep.make_train_step(_quad_loss, topt.AdamWConfig(), compress="zip")


# ---------------------------------------------------------------------------
# make_train_step on the transformer, three steps against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches,compress", [(1, None), (2, None), (1, "bf16"),
                                                   (2, "bf16")])
@pytest.mark.parametrize("name", ["internlm2-1.8b-smoke", "moonshot-smoke"])
def test_train_steps_match_the_reference(name, microbatches, compress):
    tc, jc = _pair(name)
    jp, tp = _weights(jc, tc, seed=7)
    lr = 1e-3
    jcfg = jopt.AdamWConfig(lr=jopt.warmup_cosine(lr, 2, 10), weight_decay=0.01)
    tcfg = topt.AdamWConfig(lr=topt.warmup_cosine(lr, 2, 10), weight_decay=0.01)
    jfn = jax.jit(jstep.make_train_step(lambda p, b: jtfm.loss_fn(p, jc, b), jcfg,
                                        microbatches=microbatches, compress=compress))
    tfn = tstep.make_train_step(lambda p, b: tfm.loss_fn(p, tc, b, device="cpu"), tcfg,
                                microbatches=microbatches, compress=compress)
    js = jstep.init_train_state(jp, compress=compress)
    ts = tstep.init_train_state(tp, compress=compress)
    for i in range(3):
        batch = lm_batch(4, 16, tc.vocab_size, seed=40 + i)
        jp, js, jm = jfn(jp, js, jax.tree.map(jnp.asarray, batch))
        tp, ts, tm = tfn(tp, ts, batch)
        what = f"{name} step {i}"
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for key in ("loss", "grad_norm"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5), (what, key)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-7)
        assert float(tm["moe_drops"]) == float(jm["moe_drops"])
        step_atol = 2 * lr * 1e-4
        flips = 1e-2 if compress else 0.0
        _close_tree(tp, jp, 1e-5, atol=step_atol, flips=flips, what=what + " params")
        _close_tree(ts["m"], js["m"], 1e-4, flips=flips, what=what + " m")
        _close_tree(ts["v"], js["v"], 1e-4, flips=flips, what=what + " v")
        if compress:
            _close_tree(ts["feedback"], js["feedback"], 0.05, flips=flips,
                        what=what + " feedback")
    assert all(p.requires_grad for p in tree.leaves(tp))


def test_tree_order_is_the_references():
    """Leaf order and names: jax.tree's sorted dict keys, tuple positions."""
    t = {"b": {"y": 1, "x": 2}, "a": (3, {"z": 4})}
    assert [tree.key(p) for p, _ in tree.items(t)] == ["a/0", "a/1/z", "b/x", "b/y"]
    flat = jax.tree_util.tree_flatten_with_path(t)[0]
    assert tree.leaves(t) == [leaf for _, leaf in flat]
    assert tree.unflatten(t, [10, 20, 30, 40]) == {"a": (10, {"z": 20}),
                                                   "b": {"x": 30, "y": 40}}
    assert math.isclose(1.0, 1.0)


@pytest.mark.parametrize("compress", [None, "bf16"])
def test_train_state_crosses_both_ways(compress):
    """``interop.train_state_from_numpy`` / ``_to_numpy`` carry the
    reference's (params, opt_state) across and back unchanged, and the
    checkpoint names of the port's state are the reference's."""
    from repro.distributed.checkpoint import _leaf_key

    tc, jc = _pair("gemma3-4b-smoke")
    jp = j_init_params(jc.param_specs(), jax.random.PRNGKey(9))
    js = jstep.init_train_state(jp, compress=compress)
    js = jax.tree.map(lambda x: x + 1 if x.dtype == jnp.int32 else x + 0.5, js)
    np_p, np_s = jax.tree.map(np.asarray, (jp, js))
    tp, ts = interop.train_state_from_numpy(np_p, np_s, tc, device="cpu")
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 1
    back = interop.train_state_to_numpy(tp, ts)
    want = jax.tree_util.tree_flatten_with_path((np_p, np_s))[0]
    got = tree.named(back)
    assert list(got) == [_leaf_key(path) for path, _ in want]
    for (path, w) in want:
        np.testing.assert_array_equal(got[_leaf_key(path)], w)
    with pytest.raises(ValueError, match="unexpected"):
        interop.train_state_from_numpy(np_p, dict(np_s, extra=np_s["step"]), tc,
                                       device="cpu")
