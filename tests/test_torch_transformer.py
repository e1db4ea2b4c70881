"""repro_torch dense transformer against the JAX package, on the CPU.

The reference's weights (``init_params`` with a JAX key) are carried across
as numpy (``interop.transformer_params_from_numpy``); inputs are made with
numpy from a seed. Tolerances are the reference's own
(``tests/test_models.py``): fp32 forward and prefill within 1e-4, decode
within 1e-3, the invariants within 1e-5. In bf16 every activation is
rounded to 8 significant bits on both sides, at the same cast points but
after sums taken in another order, so a logit may differ by a few units of
bf16 rounding of the logits' scale: within 2^-5 x the largest |logit|
(8 bf16 ulps). The building blocks (``rms_norm``, ``rope``, ``attend``,
``attend_chunked``) are held at 2e-6 in fp32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import (gemma3_4b, internlm2_18b, llama32_3b, moonshot_v1_16b,
                           phi35_moe)
from repro.models import transformer as jtfm
from repro.models.module import init_params as j_init_params
from repro_torch import interop
from repro_torch.configs import lm
from repro_torch.data.batches import lm_batch
from repro_torch.models import module as tmodule
from repro_torch.models import transformer as tfm

LM_FIXTURE = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                  head_dim=8, d_ff=64, vocab_size=64, dtype="float32")
SMOKES = {  # port config, reference config
    "gemma3-4b-smoke": (lm.GEMMA3_4B_SMOKE, gemma3_4b.SMOKE_CONFIG),
    "llama3.2-3b-smoke": (lm.LLAMA32_3B_SMOKE, llama32_3b.SMOKE_CONFIG),
    "internlm2-1.8b-smoke": (lm.INTERNLM2_18B_SMOKE, internlm2_18b.SMOKE_CONFIG),
    "t": (tfm.TransformerConfig(**LM_FIXTURE), jtfm.TransformerConfig(**LM_FIXTURE)),
}
NAMES = list(SMOKES)
BF16_TOL = 2.0**-5


def _pair(name, **changes):
    tc, jc = SMOKES[name]
    return dataclasses.replace(tc, **changes), dataclasses.replace(jc, **changes)


def _weights(jc, tc, seed=0):
    jp = j_init_params(jc.param_specs(), jax.random.PRNGKey(seed))
    npp = jax.tree.map(np.asarray, jp)
    return jp, interop.transformer_params_from_numpy(npp, tc, device="cpu",
                                                     dtype=tc.compute_dtype)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def test_configs_copy_the_reference():
    for cfg in (lm.GEMMA3_4B, lm.LLAMA32_3B, lm.INTERNLM2_18B, lm.MOONSHOT_V1_16B,
                lm.PHI35_MOE):
        ref = {"gemma3-4b": gemma3_4b.CONFIG, "llama3.2-3b": llama32_3b.CONFIG,
               "internlm2-1.8b": internlm2_18b.CONFIG,
               "moonshot-v1-16b-a3b": moonshot_v1_16b.CONFIG,
               "phi3.5-moe-42b-a6.6b": phi35_moe.CONFIG}[cfg.name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        assert cfg.param_count() == ref.param_count()
        assert cfg.active_param_count() == ref.active_param_count()
        assert cfg.window_sizes() == np.asarray(ref.window_sizes()).tolist()
    for tc, jc in [*SMOKES.values(), (lm.MOONSHOT_V1_16B_SMOKE, moonshot_v1_16b.SMOKE_CONFIG),
                   (lm.PHI35_MOE_SMOKE, phi35_moe.SMOKE_CONFIG)]:
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert lm.GEMMA3_4B.param_count() == 3_879_925_248


def test_lm_model_flops_copies_the_reference():
    from repro.configs.lm_common import lm_model_flops as j_flops

    for cfg in (lm.GEMMA3_4B, lm.LLAMA32_3B, lm.MOONSHOT_V1_16B):
        ref = {"gemma3-4b": gemma3_4b.CONFIG, "llama3.2-3b": llama32_3b.CONFIG,
               "moonshot-v1-16b-a3b": moonshot_v1_16b.CONFIG}[cfg.name]
        for mode, b, s in (("prefill", 4, 2048), ("decode", 128, 32768), ("train", 2, 64)):
            assert lm.lm_model_flops(cfg, b, s, mode) == j_flops(ref, b, s, mode)


def test_lm_batch_copies_the_reference():
    from repro.data.batches import lm_batch as j_lm_batch

    a, b = lm_batch(3, 17, 1000, seed=4), j_lm_batch(3, 17, 1000, seed=4)
    for key in ("tokens", "labels"):
        np.testing.assert_array_equal(a[key], b[key])


def test_init_params_shapes_scales_and_generator():
    cfg = lm.GEMMA3_4B_SMOKE
    specs = cfg.param_specs()
    p1 = tmodule.init_params(specs, torch.Generator().manual_seed(3), device="cpu")
    p2 = tmodule.init_params(specs, torch.Generator().manual_seed(3), device="cpu")
    assert tmodule.param_count(specs) == cfg.param_count()
    assert torch.equal(p1["layers"]["wq"], p2["layers"]["wq"])
    assert torch.equal(p1["layers"]["attn_norm"], torch.ones_like(p1["layers"]["attn_norm"]))
    assert p1["embed"].dtype == torch.float32
    std = float(p1["layers"]["w_gate"].std())
    assert abs(std - 1.0 / np.sqrt(cfg.d_model)) < 0.1 / np.sqrt(cfg.d_model)
    assert abs(float(p1["embed"].std()) - 1.0) < 0.1  # scale=1.0
    pb = tmodule.init_params(specs, torch.Generator().manual_seed(3), device="cpu",
                             dtype=torch.bfloat16)
    assert torch.equal(pb["layers"]["wq"], p1["layers"]["wq"].bfloat16())


def test_params_from_numpy_rejects_a_wrong_tree():
    tc, jc = SMOKES["t"]
    npp = jax.tree.map(np.asarray, j_init_params(jc.param_specs(), jax.random.PRNGKey(0)))
    bad = dict(npp, layers={k: v for k, v in npp["layers"].items() if k != "wq"})
    with pytest.raises(ValueError, match="keys"):
        interop.transformer_params_from_numpy(bad, tc, device="cpu")
    bad = dict(npp, final_norm=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="shape"):
        interop.transformer_params_from_numpy(bad, tc, device="cpu")


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.as_tensor(np.array(jx, np.float32)).to(getattr(torch, dtype))
    tol = 2e-6 if dtype == "float32" else 2.0**-7
    np.testing.assert_allclose(_np(tfm.rms_norm(tx, torch.as_tensor(w), 1e-6)),
                               _np(jtfm.rms_norm(jx, jnp.asarray(w), 1e-6)),
                               rtol=tol, atol=tol)
    pos = np.arange(5, 12, dtype=np.int32)
    np.testing.assert_allclose(_np(tfm.rope(tx, torch.as_tensor(pos), 1e6)),
                               _np(jtfm.rope(jx, jnp.asarray(pos), 1e6)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("valid", [None, 9])
@pytest.mark.parametrize("window", [-1, 3])
@pytest.mark.parametrize("chunked", [False, True])
def test_attend_matches_reference(chunked, window, valid):
    rng = np.random.default_rng(2)
    B, Sq, Skv, Hq, Hkv, hd = 2, 4 if valid else 12, 12, 6, 2, 8
    q = rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    q_pos = (np.arange(Sq) + (5 if valid else 0)).astype(np.int32)
    kv_pos = np.arange(Skv, dtype=np.int32)
    jfn, tfn = ((jtfm.attend_chunked, tfm.attend_chunked) if chunked
                else (jtfm.attend, tfm.attend))
    extra = dict(chunk=4) if chunked else {}
    want = jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_pos=jnp.asarray(q_pos),
               kv_pos=jnp.asarray(kv_pos), window=jnp.int32(window),
               kv_valid_len=None if valid is None else jnp.int32(valid), **extra)
    got = tfn(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
              q_pos=torch.as_tensor(q_pos), kv_pos=torch.as_tensor(kv_pos),
              window=window, kv_valid_len=valid, **extra)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("name", NAMES)
def test_layer_body_matches_reference(name):
    tc, jc = _pair(name)
    jp, tp = _weights(jc, tc, seed=1)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, tc.d_model)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32)
    i = tc.n_layers - 1  # the global layer of the gemma smoke's 5:1 period
    jl = {k: v[i] for k, v in jp["layers"].items()}
    jl["window"] = jc.window_sizes()[i]
    tl = {k: v[i] for k, v in tp["layers"].items()}
    tl["window"] = tc.window_sizes()[i]
    jy, _, _, (jk, jv) = jtfm._layer_body(jnp.asarray(x), jl, jc, q_pos=jnp.asarray(pos),
                                          kv_pos=jnp.asarray(pos))
    ty, _, drops, (tk, tv) = tfm._layer_body(torch.as_tensor(x), tl, tc,
                                             q_pos=torch.as_tensor(pos),
                                             kv_pos=torch.as_tensor(pos))
    assert drops == 0
    for a, b in ((ty, jy), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["full", "chunked"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_prefill_decode_match_reference(name, impl):
    tc, jc = _pair(name, attn_impl=impl, attn_chunk=4)
    jp, tp = _weights(jc, tc)
    toks = _tokens(4, 2, 12, tc.vocab_size)
    jl, _ = jtfm.forward(jp, jc, jnp.asarray(toks))
    tl, aux = tfm.forward(tp, tc, toks, device="cpu")
    assert tl.dtype == torch.float32 and aux["moe_drops"] == 0
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4)

    jpl, jcache = jtfm.prefill(jp, jc, jnp.asarray(toks), 16)
    tpl, tcache = tfm.prefill(tp, tc, toks, 16, device="cpu")
    np.testing.assert_allclose(_np(tpl), _np(jpl), atol=1e-4)
    for key in ("k", "v"):
        assert tcache[key].shape == jcache[key].shape
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]), atol=1e-4)

    nxt = np.asarray(jnp.argmax(jpl[:, -1:], -1)).astype(np.int32)
    jd, jcache2 = jtfm.decode_step(jp, jc, jnp.asarray(nxt), jcache, jnp.int32(12))
    td, tcache2 = tfm.decode_step(tp, tc, nxt, tcache, 12, device="cpu")
    np.testing.assert_allclose(_np(td), _np(jd), atol=1e-3)
    np.testing.assert_allclose(_np(tcache2["k"]), _np(jcache2["k"]), atol=1e-4)
    # the reference's own cache, carried across, gives the same step
    carried = interop.cache_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")
    td2, _ = tfm.decode_step(tp, tc, nxt, carried, 12, device="cpu")
    np.testing.assert_allclose(_np(td2), _np(jd), atol=1e-3)


def test_multi_token_decode_step_matches_reference():
    """A decode step of several tokens runs the chunked path with the
    cache's valid length."""
    tc, jc = _pair("gemma3-4b-smoke", attn_impl="chunked", attn_chunk=4)
    jp, tp = _weights(jc, tc, seed=2)
    toks = _tokens(5, 2, 8, tc.vocab_size)
    more = _tokens(6, 2, 3, tc.vocab_size)
    _, jcache = jtfm.prefill(jp, jc, jnp.asarray(toks), 12)
    _, tcache = tfm.prefill(tp, tc, toks, 12, device="cpu")
    jd, _ = jtfm.decode_step(jp, jc, jnp.asarray(more), jcache, jnp.int32(8))
    td, _ = tfm.decode_step(tp, tc, more, tcache, 8, device="cpu")
    np.testing.assert_allclose(_np(td), _np(jd), atol=1e-3)


@pytest.mark.parametrize("impl", ["full", "chunked"])
def test_bf16_forward_and_prefill_match_reference(impl):
    tc, jc = _pair("gemma3-4b-smoke", dtype="bfloat16", attn_impl=impl, attn_chunk=4)
    jp, tp = _weights(jc, tc, seed=3)
    assert tp["layers"]["wq"].dtype == torch.bfloat16
    toks = _tokens(7, 2, 12, tc.vocab_size)
    jl, _ = jtfm.forward(jp, jc, jnp.asarray(toks))
    tl, _ = tfm.forward(tp, tc, toks, device="cpu")
    scale = float(np.abs(_np(jl)).max())
    np.testing.assert_allclose(_np(tl), _np(jl), atol=BF16_TOL * scale, rtol=0)
    jpl, jcache = jtfm.prefill(jp, jc, jnp.asarray(toks), 16)
    tpl, tcache = tfm.prefill(tp, tc, toks, 16, device="cpu")
    assert tcache["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tpl), _np(jpl), atol=BF16_TOL * scale, rtol=0)
    # layer 0's cache comes before any attention: the same bits
    np.testing.assert_array_equal(_np(tcache["k"][0]), _np(jcache["k"][0]))


# ---------------------------------------------------------------------------
# the reference's invariants, on the port (tests/test_models.py:24-72)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm_model():
    cfg = tfm.TransformerConfig(**LM_FIXTURE)
    params = tmodule.init_params(cfg.param_specs(), torch.Generator().manual_seed(0),
                                 device="cpu")
    return cfg, params


@pytest.mark.parametrize("impl", ["full", "chunked"])
def test_prefill_decode_match_forward(lm_model, impl):
    cfg, params = lm_model
    cfg = dataclasses.replace(cfg, attn_impl=impl, attn_chunk=4)
    toks = torch.as_tensor(_tokens(1, 2, 12, 64))
    logits, _ = tfm.forward(params, cfg, toks, device="cpu")
    plogits, cache = tfm.prefill(params, cfg, toks, 16, device="cpu")
    np.testing.assert_allclose(_np(plogits), _np(logits), atol=1e-4)
    nxt = plogits[:, -1:].argmax(-1)
    dl, _ = tfm.decode_step(params, cfg, nxt, cache, 12, device="cpu")
    full, _ = tfm.forward(params, cfg, torch.cat([toks, nxt], 1), device="cpu")
    np.testing.assert_allclose(_np(dl[:, 0]), _np(full[:, -1]), atol=1e-3)


@pytest.mark.parametrize("impl", ["full", "chunked"])
def test_sliding_window_masks_past(impl):
    cfg = tfm.TransformerConfig(name="w", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4,
                                head_dim=8, d_ff=64, vocab_size=64, dtype="float32",
                                window=3, attn_impl=impl, attn_chunk=5)
    params = tmodule.init_params(cfg.param_specs(), torch.Generator().manual_seed(2),
                                 device="cpu")
    t1 = torch.as_tensor(_tokens(3, 1, 10, 64)).long()
    t2 = t1.clone()
    t2[0, 0] = (t1[0, 0] + 17) % 64  # a distant token
    l1, _ = tfm.forward(params, cfg, t1, device="cpu")
    l2, _ = tfm.forward(params, cfg, t2, device="cpu")
    np.testing.assert_allclose(_np(l1[0, -1]), _np(l2[0, -1]), atol=1e-5)
    t3 = t1.clone()
    t3[0, 9] = (t1[0, 9] + 17) % 64  # an in-window token
    l3, _ = tfm.forward(params, cfg, t3, device="cpu")
    assert float((l3[0, -1] - l1[0, -1]).abs().max()) > 1e-4


def test_causality(lm_model):
    cfg, params = lm_model
    t1 = torch.as_tensor(_tokens(4, 1, 8, 64)).long()
    t2 = t1.clone()
    t2[0, 5] = (t1[0, 5] + 3) % 64
    l1, _ = tfm.forward(params, cfg, t1, device="cpu")
    l2, _ = tfm.forward(params, cfg, t2, device="cpu")
    np.testing.assert_allclose(_np(l1[0, :5]), _np(l2[0, :5]), atol=1e-5)
    assert float((l1[0, 5:] - l2[0, 5:]).abs().max()) > 1e-4


def test_entry_points_check_the_weights_device(lm_model):
    cfg, params = lm_model
    with pytest.raises(ValueError, match="params on"):
        tfm.forward(params, cfg, np.zeros((1, 4), np.int32), device="meta")


# ---------------------------------------------------------------------------
# on the card: the chunked path goes through K6
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_cuda_chunked_prefill_runs_k6_and_matches_cpu(cuda, name):
    from repro_torch.kernels.flashattn.ops import flash_attention

    tc, jc = _pair(name, attn_impl="chunked", attn_chunk=4)
    _, tp = _weights(jc, tc)
    gp = jax.tree.map(lambda t: t.to(cuda), tp)
    toks = _tokens(8, 2, 12, tc.vocab_size)
    before = flash_attention.launches
    gl, gcache = tfm.prefill(gp, tc, toks, 16, device=cuda)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + tc.n_layers
    cl, ccache = tfm.prefill(tp, tc, toks, 16, device="cpu")
    np.testing.assert_allclose(_np(gl.cpu()), _np(cl), atol=1e-4)
    nxt = cl[:, -1:].argmax(-1)
    gd, _ = tfm.decode_step(gp, tc, nxt, gcache, 12, device=cuda)
    cd, _ = tfm.decode_step(tp, tc, nxt, ccache, 12, device="cpu")
    np.testing.assert_allclose(_np(gd.cpu()), _np(cd), atol=1e-3)
