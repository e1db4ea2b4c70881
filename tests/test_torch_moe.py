"""repro_torch's MoE transformer (global and routed dispatch) against the
JAX package's, on the CPU.

The reference's weights (``init_params`` with a JAX key) are carried across
as numpy; tokens are made with numpy from a seed. The smoke configurations
of moonshot-v1-16b-a3b and phi3.5-moe run through ``forward``, ``prefill``
and ``decode_step`` at the dense tests' tolerances (fp32: 1e-4, decode
1e-3), with ``moe_drops`` equal, at their own capacity factors and at
``tests/test_models.py::test_moe_drops_counted``'s 0.1, where tokens drop.
An all-zero router ties every expert: each token must take experts 0..k-1,
as ``jax.lax.top_k`` orders ties, and overflow alike.

The routed variant runs over ``DeviceMesh((cpu,) * 4)`` (four shards in
turn on the CPU) and is held against the port's global variant and the
reference's global one within 2e-4 (the tolerance of
``tests/test_variants.py::test_routed_moe_matches_global``, which itself
raises on this jax) where nothing drops; at a small capacity factor its
drop count is held against the reference's rule (its capacities and its
count, ``models/transformer.py`` ``_moe_ffn_routed``) computed in numpy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import moonshot_v1_16b, phi35_moe
from repro.models import transformer as jtfm
from repro.models.module import init_params as j_init_params
from repro_torch import interop
from repro_torch.configs import lm
from repro_torch.distributed.meshutil import DeviceMesh
from repro_torch.models import transformer as tfm

SMOKES = {
    "moonshot-smoke": (lm.MOONSHOT_V1_16B_SMOKE, moonshot_v1_16b.SMOKE_CONFIG),
    "phi35-moe-smoke": (lm.PHI35_MOE_SMOKE, phi35_moe.SMOKE_CONFIG),
}
DROPS_FIXTURE = dict(name="m", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
                     head_dim=8, d_ff=32, vocab_size=32, dtype="float32")
MESH4 = DeviceMesh((torch.device("cpu"),) * 4)


def _pair(name, **changes):
    tc, jc = SMOKES[name]
    return dataclasses.replace(tc, **changes), dataclasses.replace(jc, **changes)


def _drops_pair(capacity_factor):
    """``test_moe_drops_counted``'s model at ``capacity_factor``."""
    tc = tfm.TransformerConfig(**DROPS_FIXTURE, moe=tfm.MoEConfig(
        n_experts=4, top_k=2, d_ff=32, capacity_factor=capacity_factor))
    jc = jtfm.TransformerConfig(**DROPS_FIXTURE, moe=jtfm.MoEConfig(
        n_experts=4, top_k=2, d_ff=32, capacity_factor=capacity_factor))
    return tc, jc


def _weights(jc, tc, seed=0, zero_router=False):
    jp = j_init_params(jc.param_specs(), jax.random.PRNGKey(seed))
    if zero_router:
        jp["layers"]["router"] = jnp.zeros_like(jp["layers"]["router"])
    npp = jax.tree.map(np.asarray, jp)
    return jp, interop.transformer_params_from_numpy(npp, tc, device="cpu",
                                                     dtype=tc.compute_dtype)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def test_moe_param_specs_and_counts_match_the_reference():
    for tc, jc in [*SMOKES.values(), (lm.MOONSHOT_V1_16B, moonshot_v1_16b.CONFIG),
                   (lm.PHI35_MOE, phi35_moe.CONFIG)]:
        tspecs, jspecs = tc.param_specs(), jc.param_specs()
        assert set(tspecs["layers"]) == set(jspecs["layers"])
        for key, spec in jspecs["layers"].items():
            assert tspecs["layers"][key].shape == spec.shape, key
            assert tspecs["layers"][key].axes == spec.axes, key
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
    assert lm.MOONSHOT_V1_16B.param_count() == 27_722_450_944


@pytest.mark.parametrize("n_tokens", [1, 4, 64, 8192])
@pytest.mark.parametrize("cf", [None, 0.1, 4.0])
def test_moe_capacity_for_matches_the_reference(n_tokens, cf):
    for tc, jc in SMOKES.values():
        assert tfm.moe_capacity_for(tc, n_tokens, cf) == jtfm.moe_capacity_for(
            jc, n_tokens, cf)
    assert tfm.moe_capacity_for(lm.GEMMA3_4B, n_tokens, cf) == 0


def test_top_k_orders_ties_as_jax():
    rng = np.random.default_rng(0)
    logits = rng.integers(-2, 3, (50, 16)).astype(np.float32)  # many ties
    jv, ji = jax.lax.top_k(jnp.asarray(logits), 5)
    tv, ti = tfm.top_k(torch.as_tensor(logits), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_router_logits_do_not_depend_on_the_row_count():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2 * tfm.ROUTER_CHUNK + 40, 64, generator=g)
    w = torch.randn(64, 16, generator=g)
    full = tfm.router_logits(x, w)
    for lo, hi in ((0, 7), (5, 1500), (tfm.ROUTER_CHUNK, x.shape[0])):
        assert torch.equal(tfm.router_logits(x[lo:hi], w), full[lo:hi])
    np.testing.assert_allclose(full.numpy(), (x.double() @ w.double()).numpy(),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("capacity", [4, 48])
def test_moe_ffn_matches_the_reference(capacity):
    tc, jc = _pair("moonshot-smoke")
    jp, tp = _weights(jc, tc, seed=1)
    x = np.random.default_rng(2).standard_normal((48, tc.d_model)).astype(np.float32)
    jl = {k: v[0] for k, v in jp["layers"].items()}
    tl = {k: v[0] for k, v in tp["layers"].items()}
    jy, jdrops = jtfm._moe_ffn(jnp.asarray(x), jl, jc, capacity)
    ty, tdrops = tfm._moe_ffn(torch.as_tensor(x), tl, tc, capacity)
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=1e-5, atol=1e-5)
    assert int(tdrops) == int(jdrops)
    # 4: every expert overflows; 48: each takes every token
    assert (int(tdrops) > 0) == (capacity == 4)


def _entry_points(tc, jc, jp, tp, toks, *, cf=None, mesh=None):
    """forward, prefill and a decode step of both packages; returns the
    port's drops (forward, prefill) and the reference's forward drops."""
    S = toks.shape[1]
    jl, jaux = jtfm.forward(jp, jc, jnp.asarray(toks), capacity_factor=cf)
    tl, taux = tfm.forward(tp, tc, toks, device="cpu", capacity_factor=cf, mesh=mesh)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4)
    jpl, jcache = jtfm.prefill(jp, jc, jnp.asarray(toks), S + 4, capacity_factor=cf)
    paux = {}
    tpl, tcache = tfm.prefill(tp, tc, toks, S + 4, device="cpu", capacity_factor=cf,
                              mesh=mesh, aux=paux)
    np.testing.assert_allclose(_np(tpl), _np(jpl), atol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]), atol=1e-4)
    nxt = np.asarray(jnp.argmax(jpl[:, -1:], -1)).astype(np.int32)
    jd, _ = jtfm.decode_step(jp, jc, jnp.asarray(nxt), jcache, jnp.int32(S),
                             capacity_factor=cf)
    td, _ = tfm.decode_step(tp, tc, nxt, tcache, S, device="cpu", capacity_factor=cf,
                            mesh=mesh)
    np.testing.assert_allclose(_np(td), _np(jd), atol=1e-3)
    return int(taux["moe_drops"]), int(paux["moe_drops"]), int(jaux["moe_drops"])


@pytest.mark.parametrize("name,impl", [("moonshot-smoke", "full"),
                                       ("moonshot-smoke", "chunked"),
                                       ("phi35-moe-smoke", "full")])
def test_forward_prefill_decode_match_reference(name, impl):
    tc, jc = _pair(name, attn_impl=impl, attn_chunk=4)
    jp, tp = _weights(jc, tc)
    toks = _tokens(4, 2, 12, tc.vocab_size)
    fwd, pre, want = _entry_points(tc, jc, jp, tp, toks)
    assert fwd == pre == want
    if impl == "full":
        # at test_moe_drops_counted's factor, where tokens drop (an expert
        # takes at least 32 rows: 192 tokens send it 48 on average)
        toks = _tokens(5, 4, 48, tc.vocab_size)
        fwd, pre, want = _entry_points(tc, jc, jp, tp, toks, cf=0.1)
        assert fwd == pre == want > 0


def test_moe_drops_counted_as_the_reference():
    """``tests/test_models.py::test_moe_drops_counted``'s model and factor
    (0.1), on the reference's weights: the same logits and drop count."""
    tc, jc = _drops_pair(0.1)
    jp, tp = _weights(jc, tc, seed=5)
    toks = _tokens(6, 4, 64, 32)
    jl, jaux = jtfm.forward(jp, jc, jnp.asarray(toks))
    tl, taux = tfm.forward(tp, tc, toks, device="cpu")
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4)
    assert int(taux["moe_drops"]) == int(jaux["moe_drops"]) > 0
    assert taux["moe_drops"].dtype == torch.int32


def test_all_zero_router_ties_go_to_the_lower_experts():
    tc, jc = _pair("moonshot-smoke")
    jp, tp = _weights(jc, tc, seed=3, zero_router=True)
    x = np.random.default_rng(4).standard_normal((40, tc.d_model)).astype(np.float32)
    tl = {k: v[0] for k, v in tp["layers"].items()}
    logits = tfm.router_logits(torch.as_tensor(x), tl["router"])
    _, idx = tfm.top_k(logits, tc.moe.top_k)
    assert (idx == torch.arange(tc.moe.top_k)).all()
    toks = _tokens(7, 2, 40, tc.vocab_size)
    fwd, pre, want = _entry_points(tc, jc, jp, tp, toks, cf=0.5)
    # experts 0 and 1 take every token and overflow alike in both: 2 x (80
    # tokens - their capacity of 32) a layer
    assert fwd == pre == want == 2 * tc.n_layers * (80 - 32)


def _routed_drops_numpy(x2d, router, cfg, n_shards):
    """The reference's routed drop count (``_moe_ffn_routed``: its
    capacities, a stable counting sort a source, the owner's second
    dispatch and ``psum(lay.overflow + max(drops2, 0))``) in numpy."""
    moe = cfg.moe
    T = x2d.shape[0]
    e_loc, t_loc, k = moe.n_experts // n_shards, T // n_shards, moe.top_k
    cap = max(8, -(-t_loc * k // n_shards))
    cap = ((int(cap * moe.capacity_factor) + 7) // 8) * 8
    cap2 = ((int(n_shards * cap / e_loc * 1.25) + 7) // 8) * 8 if e_loc > 1 else 0
    sent = [[[] for _ in range(n_shards)] for _ in range(n_shards)]  # [src][dst]
    total = 0
    for s in range(n_shards):
        logits = x2d[s * t_loc:(s + 1) * t_loc].astype(np.float32) @ router
        experts = np.argsort(-logits, axis=1, kind="stable")[:, :k].reshape(-1)
        for e in experts:
            dst = e // e_loc
            if len(sent[s][dst]) < cap:
                sent[s][dst].append(e)
            else:
                total += 1  # send-side drop
    for m in range(n_shards):
        recv = [e - m * e_loc for s in range(n_shards) for e in sent[s][m]]
        n_invalid = n_shards * cap - len(recv)
        if e_loc > 1:
            counts = np.bincount(recv, minlength=e_loc)
            drops2 = int(np.maximum(counts - cap2, 0).sum()) - n_invalid
            total += max(drops2, 0)
    return total, cap, cap2


@pytest.mark.parametrize("name", list(SMOKES))
def test_routed_matches_global_on_four_shards(name):
    """Four shards on the CPU: E / S = 2 experts a shard for moonshot's
    smoke (a second dispatch on the owner), 1 for phi3.5's."""
    tc, jc = _pair(name, moe_impl="routed")
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, capacity_factor=4.0))
    jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, capacity_factor=4.0))
    jp, tp = _weights(jc, tc, seed=6)
    toks = _tokens(8, 4, 16, tc.vocab_size)
    glob = dataclasses.replace(tc, moe_impl="global")
    lg, ag = tfm.forward(tp, glob, toks, device="cpu", capacity_factor=4.0)
    calls = []
    real = tfm._moe_ffn_routed

    def spy(*a, **kw):
        calls.append(a[0].shape[0])
        return real(*a, **kw)

    tfm._moe_ffn_routed = spy
    try:
        fwd, pre, want = _entry_points(tc, jc, jp, tp, toks, cf=4.0, mesh=MESH4)
        lr, ar = tfm.forward(tp, tc, toks, device="cpu", capacity_factor=4.0,
                             mesh=MESH4)
    finally:
        tfm._moe_ffn_routed = real
    assert calls and set(calls) >= {64}  # the prompt's 64 tokens, routed
    np.testing.assert_allclose(_np(lr), _np(lg), atol=2e-4)
    assert int(ar["moe_drops"]) == int(ag["moe_drops"]) == fwd == pre == want == 0
    # one shard, or a token count that does not split: the global variant
    lone, _ = tfm.forward(tp, tc, toks, device="cpu", capacity_factor=4.0,
                          mesh=DeviceMesh((torch.device("cpu"),)))
    assert torch.equal(lone, lg)
    odd, _ = tfm.forward(tp, tc, toks[:, :13], device="cpu", capacity_factor=4.0,
                         mesh=MESH4)
    assert torch.equal(odd, tfm.forward(tp, glob, toks[:, :13], device="cpu",
                                        capacity_factor=4.0)[0])


@pytest.mark.parametrize("cf", [0.25, 0.5, 1.25, 4.0])
@pytest.mark.parametrize("name", list(SMOKES))
def test_routed_drops_follow_the_reference_rule(name, cf):
    tc, jc = _pair(name, moe_impl="routed")
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, capacity_factor=cf))
    _, tp = _weights(jc, tc, seed=9)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((96, tc.d_model)).astype(np.float32)
    layer = {k: v[0] for k, v in tp["layers"].items()}
    want, cap, cap2 = _routed_drops_numpy(x, layer["router"].numpy(), tc, 4)
    assert tfm.routed_capacities(tc, 96, 4) == (cap, cap2)
    out, drops = tfm._moe_ffn_routed(torch.as_tensor(x), layer, tc, 0, MESH4)
    assert int(drops) == want
    assert out.shape == (96, tc.d_model) and bool(torch.isfinite(out).all())
    if cf < 1:
        assert want > 0
    if cf == 4.0:
        assert want == 0
        glob, _ = tfm._moe_ffn(torch.as_tensor(x), layer, tc, 96)
        np.testing.assert_allclose(out.numpy(), glob.numpy(), atol=2e-4)


def test_params_from_numpy_carries_the_experts_and_rejects_a_wrong_tree():
    tc, jc = _pair("moonshot-smoke")
    jp, tp = _weights(jc, tc, seed=11)
    L, E, D, Fe = 2, 8, 32, 48
    assert tp["layers"]["w_gate"].shape == (L, E, D, Fe)
    assert tp["layers"]["w_down"].shape == (L, E, Fe, D)
    assert tp["layers"]["router"].shape == (L, D, E)
    np.testing.assert_array_equal(tp["layers"]["w_up"].numpy(),
                                  np.asarray(jp["layers"]["w_up"]))
    npp = jax.tree.map(np.asarray, jp)
    bad = dict(npp, layers={k: v for k, v in npp["layers"].items() if k != "router"})
    with pytest.raises(ValueError, match="keys"):
        interop.transformer_params_from_numpy(bad, tc, device="cpu")
    bad = dict(npp, layers=dict(npp["layers"], w_gate=npp["layers"]["w_gate"][:, :4]))
    with pytest.raises(ValueError, match="shape"):
        interop.transformer_params_from_numpy(bad, tc, device="cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SMOKES))
def test_cuda_moe_matches_cpu_and_routed_picks_as_global(cuda, name):
    """On the card the chunked prefill runs K6 (the smoke's hd 8: the
    CUDA-core kernel) and the MoE layers, and matches the CPU run; routed
    over four shards of the card picks each token's experts bit for bit
    as global does."""
    tc, jc = _pair(name, attn_impl="chunked", attn_chunk=4)
    # the routed capacities follow the configuration's factor: 4.0, where
    # neither variant drops a row
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, capacity_factor=4.0))
    _, tp = _weights(jc, tc, seed=12)
    gp = jax.tree.map(lambda t: t.to(cuda), tp)
    toks = _tokens(13, 4, 16, tc.vocab_size)
    cl, _ = tfm.prefill(tp, tc, toks, 20, device="cpu")
    gl, _ = tfm.prefill(gp, tc, toks, 20, device=cuda)
    np.testing.assert_allclose(_np(gl.cpu()), _np(cl), atol=1e-4)
    picks = {}
    real = tfm.top_k

    def record(logits, k):
        out = real(logits, k)
        picks.setdefault(tag, []).append(out[1].cpu())
        return out

    tfm.top_k = record
    try:
        tag = "global"
        lg, ag = tfm.forward(gp, tc, toks, device=cuda)
        tag = "routed"
        lr, ar = tfm.forward(gp, dataclasses.replace(tc, moe_impl="routed"), toks,
                             device=cuda, mesh=DeviceMesh((cuda,) * 4))
    finally:
        tfm.top_k = real
    n = tc.n_layers
    routed = [torch.cat(picks["routed"][i * 4:(i + 1) * 4]) for i in range(n)]
    for g, r in zip(picks["global"], routed):
        assert torch.equal(g, r)
    np.testing.assert_allclose(_np(lr.cpu()), _np(lg.cpu()), atol=2e-4)
    assert int(ar["moe_drops"]) == int(ag["moe_drops"]) == 0
