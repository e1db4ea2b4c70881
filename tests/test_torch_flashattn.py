"""repro_torch flash attention (K6): the plain version and the CPU path of
the wrapper against the JAX package's ``flash_attention`` (``impl="xla"``
and the Pallas kernel in interpret mode), a CPU emulation of the
tensor-core kernel's rounding against the plain version and the JAX
``flash_attention_ref``, and on the card both CUDA kernels (tensor-core
and CUDA-core variants) against the plain version. The gradient
(``FlashAttention``: the forward's ``lse``, ``flash_attention_bwd_ref`` on
the CPU, ``csrc/flashattn_bwd_tc.cu`` and ``csrc/flashattn_bwd.cu`` on the
card) against ``jax.vjp`` of the reference's ``flash_attention_ref``,
against float64 autograd, and within ``fp32_bound.attention_grads_f64``'s
bounds; a CPU emulation of the tensor-core backward's rounding within its
bf16 tolerance.

Inputs are made with numpy from a seed. Tolerances on the CPU are the
reference's own (``tests/test_flashattn.py``): 2e-4 in fp32 (sums in
another order), 2e-2 in bf16. On the card: fp32 outputs within the fp32
error bound of a float64 oracle (``kernels/fp32_bound.attention_f64``),
which the plain version with TF32-rounded products must break; bf16 outputs within
``fp32_bound.attention_bf16_tol`` of the plain version (its bf16-rounded
weights and the two outputs' roundings).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.flashattn.ops import flash_attention as j_flash
from repro.kernels.flashattn.ref import flash_attention_ref as j_flash_ref
from repro_torch.kernels import fp32_bound
from repro_torch.kernels.flashattn.ops import _forward as fa_forward
from repro_torch.kernels.flashattn.ops import (
    FlashAttention,
    _kernel,
    flash_attention,
    flash_attention_bwd,
    variant,
)
from repro_torch.kernels.flashattn.ref import (
    attention_mask,
    flash_attention_bwd_ref,
    flash_attention_lse_ref,
    flash_attention_ref,
)
from repro_torch.models import transformer as tfm

SHAPES = [  # b, sq, skv, hq, hkv, hd, win, tq, tkv (tests/test_flashattn.py)
    (2, 64, 64, 4, 2, 16, -1, 32, 32),  # GQA causal
    (1, 32, 64, 6, 2, 8, 12, 16, 16),  # prefill-with-history + window
    (2, 128, 128, 8, 8, 32, -1, 64, 32),  # MHA
    (1, 64, 64, 4, 1, 16, 7, 64, 64),  # MQA, single tiles
]
DTYPES = {"float32": (torch.float32, jnp.float32, 2e-4),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _qkv(seed, b, sq, skv, hq, hkv, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, hd)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, hd)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, hd)).astype(np.float32))


def _both(arrays, tdt, jdt, device="cpu"):
    """The same values in both packages: rounded to ``jdt`` once by JAX."""
    j = [jnp.asarray(a).astype(jdt) for a in arrays]
    t = [torch.as_tensor(np.array(x, np.float32), device=device).to(tdt) for x in j]
    return j, t


def _f32(x):
    return np.asarray(x.float().cpu() if isinstance(x, torch.Tensor) else x, np.float32)


def _jax_both(seed, shape, dtype):
    """Inputs in both packages and the JAX outputs of ``impl="xla"`` and of
    the Pallas kernel (interpret mode on the CPU)."""
    b, sq, skv, hq, hkv, hd, win, tq, tkv = shape
    tdt, jdt, tol = DTYPES[dtype]
    (jq, jk, jv), t = _both(_qkv(seed, b, sq, skv, hq, hkv, hd), tdt, jdt)
    wants = (j_flash(jq, jk, jv, window=win, impl="xla"),
             j_flash(jq, jk, jv, window=win, impl="pallas", tile_q=tq, tile_kv=tkv))
    return t, wants, tol


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax(shape, dtype):
    (q, k, v), wants, tol = _jax_both(0, shape, dtype)
    got = flash_attention_ref(q, k, v, window=shape[6])
    assert got.dtype == q.dtype and got.shape == q.shape
    for want in wants:
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_cpu_wrapper_matches_jax(shape, dtype):
    (q, k, v), wants, tol = _jax_both(1, shape, dtype)
    got = flash_attention(q, k, v, window=shape[6])
    for want in wants:
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_plain_matches_model_attend():
    """The plain version equals the port's own attend() with arange positions."""
    B, S, Hq, Hkv, hd = 2, 32, 4, 2, 8
    q, k, v = (torch.as_tensor(a) for a in _qkv(3, B, S, S, Hq, Hkv, hd))
    pos = torch.arange(S)
    want = tfm.attend(q, k, v, q_pos=pos, kv_pos=pos, window=-1)
    got = flash_attention_ref(q, k, v)
    np.testing.assert_allclose(got.reshape(B, S, Hq * hd).numpy(), want.numpy(),
                               rtol=2e-4, atol=2e-4)


@settings(max_examples=10, deadline=None)
@given(
    seed=st.integers(0, 2**30),
    hkv=st.sampled_from([1, 2, 4]),
    g=st.sampled_from([1, 2, 3]),
    win=st.sampled_from([-1, 5, 16]),
)
def test_property_sweep(seed, hkv, g, win):
    (jq, jk, jv), (q, k, v) = _both(_qkv(seed, 1, 32, 32, hkv * g, hkv, 8),
                                    torch.float32, jnp.float32)
    got = flash_attention(q, k, v, window=win).numpy()
    np.testing.assert_allclose(got, np.asarray(j_flash(jq, jk, jv, window=win, impl="xla")),
                               rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(
        got, np.asarray(j_flash(jq, jk, jv, window=win, impl="pallas",
                                tile_q=16, tile_kv=16)), rtol=3e-4, atol=3e-4)


def _tf32(x):
    """``x`` rounded to TF32 (11 significant bits), to nearest."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000 + ((i >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def _ref_tf32(q, k, v, window):
    """The plain version with every product's inputs rounded to TF32, as
    the card's TF32 matmuls do."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = _tf32(q).reshape(B, Sq, Hkv, Hq // Hkv, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, _tf32(k)) * (1.0 / math.sqrt(hd))
    pos = torch.arange(Skv, device=q.device)
    dist = (pos[Skv - Sq:])[:, None] - pos[None]
    mask = (dist >= 0) & ((dist < window) if window > 0 else True)
    probs = torch.softmax(torch.where(mask, logits, -1e30), -1)
    return torch.einsum("bkgqs,bskh->bqkgh", _tf32(probs), _tf32(v)).reshape(B, Sq, Hq, hd)


def _real_qkv(seed, b, sq, skv, hq, hkv, hd):
    """Unit-RMS rows (as qk_norm gives) moved off the bf16 grid."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(seed, b, sq, skv, hq, hkv, hd))
    q = q / q.pow(2).mean(-1, keepdim=True).sqrt()
    k = k / k.pow(2).mean(-1, keepdim=True).sqrt()
    return q, k, v


@pytest.mark.parametrize("sq,skv,hd,win", [(64, 64, 8, -1), (48, 96, 32, 20),
                                           (128, 128, 128, -1)])
def test_fp32_bound_holds_plain_and_breaks_tf32(sq, skv, hd, win):
    q, k, v = _real_qkv(5, 1, sq, skv, 4, 2, hd)
    exact, tol = fp32_bound.attention_f64(q, k, v, window=win)
    assert fp32_bound.attention_error_ratio(flash_attention_ref(q, k, v, window=win),
                                            exact, tol) <= 0.5
    assert fp32_bound.attention_error_ratio(_ref_tf32(q, k, v, win), exact, tol) > 4.0


def test_fp32_bound_breaks_tf32_on_peaked_long_rows():
    """Over gemma3's ~1000 keys a row's TF32 errors cancel and stay inside
    the bound; a peaked copy (q x 8, exact in fp32) rests each row on a few
    keys, where the TF32 plain version breaks it and the fp32 one holds."""
    q, k, v = _real_qkv(5, 1, 130, 1100, 4, 2, 256)
    q = q * 8
    exact, tol = fp32_bound.attention_f64(q, k, v, window=1024)
    assert fp32_bound.attention_error_ratio(flash_attention_ref(q, k, v, window=1024),
                                            exact, tol) <= 0.5
    assert fp32_bound.attention_error_ratio(_ref_tf32(q, k, v, 1024), exact, tol) > 4.0


def test_fp32_oracle_row_chunks_agree():
    q, k, v = _real_qkv(6, 2, 40, 40, 4, 2, 16)
    a = fp32_bound.attention_f64(q, k, v, window=9, rows=3)
    b = fp32_bound.attention_f64(q, k, v, window=9, rows=64)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-12, atol=0)


def test_bf16_tol_separates_window_and_head_faults():
    """The plain version in bf16 stays within the bf16 tolerance of the
    fp32 weights' output; a window off by one and a shifted GQA head map
    break it."""
    q, k, v = (t.bfloat16() for t in _real_qkv(7, 1, 256, 256, 4, 2, 32))
    win = 64
    tol = fp32_bound.attention_bf16_tol(q, k, v, window=win)
    fp32_weights = flash_attention_ref(q.float(), k.float(), v.float(), window=win)
    good = flash_attention_ref(q, k, v, window=win).double()
    assert float(((good - fp32_weights.bfloat16().double()).abs() / tol).max()) <= 1.0
    off_by_one = flash_attention_ref(q, k, v, window=win + 1).double()
    assert float(((off_by_one - good).abs() / tol).max()) > 1.0
    shifted = flash_attention_ref(q, k.roll(1, dims=2), v.roll(1, dims=2),
                                  window=win).double()
    assert float(((shifted - good).abs() / tol).max()) > 1.0


def test_cpu_wrapper_counts_no_launch():
    before = flash_attention.launches
    q, k, v = (torch.as_tensor(a) for a in _qkv(8, 1, 8, 8, 2, 1, 8))
    flash_attention(q, k, v)
    assert flash_attention.launches == before


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 64, "tensor_core"), (torch.bfloat16, 128, "tensor_core"),
    (torch.bfloat16, 256, "tensor_core"), (torch.bfloat16, 32, "cuda_core"),
    (torch.bfloat16, 8, "cuda_core"), (torch.float32, 128, "cuda_core"),
    (torch.float32, 256, "cuda_core"), (torch.float16, 128, "cuda_core"),
])
def test_variant_rule(dtype, hd, want):
    """bf16 at hd 64/128/256 (every full LM config) takes the tensor cores;
    fp32 (TF32 there would break the fp32 bound) and small heads do not;
    the forward and the backward alike."""
    assert variant(dtype, hd) == want
    q = torch.zeros((1, 8, 2, hd), dtype=dtype)
    k = q[:, :, :1]
    assert _kernel("flash_attention", None, q, k, k) == want
    assert _kernel("flash_attention_bwd", None, q, k, k, q, q) == want
    if want == "cuda_core":  # forcing the tensor cores on what they do not take
        with pytest.raises(ValueError, match="tensor-core"):
            _kernel("flash_attention_bwd", "tensor_core", q, k, k, q, q)
    assert _kernel("flash_attention_bwd", "cuda_core", q, k, k, q, q) == "cuda_core"


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bwd"])
def test_tensor_core_rule_rejects_misaligned_rows(name):
    """The tensor-core kernels read 16-byte rows: a stride off a multiple of
    8 elements or a pointer off 16 bytes raises before any launch (checked
    on CPU tensors; the rule reads only strides and addresses)."""
    base = torch.zeros(2 * 8 * 2 * 132 + 8, dtype=torch.bfloat16)
    good = base[:8 * 2 * 64].view(1, 8, 2, 64)
    assert _kernel(name, None, good, good, good, good, good) == "tensor_core"
    odd = base.as_strided((1, 8, 2, 64), (8 * 132, 132, 64, 1))  # stride 132
    shifted = base[1:1 + 8 * 2 * 64].view(1, 8, 2, 64)  # 2 bytes off
    for bad in ((odd, good, good), (good, shifted, good), (good, good, shifted)):
        with pytest.raises(ValueError, match="16-byte"):
            _kernel(name, None, *bad, good, good)
    if name == "flash_attention_bwd":  # out and dout are read as 16-byte rows too
        with pytest.raises(ValueError, match="16-byte"):
            _kernel(name, None, good, good, good, good, shifted)
    with pytest.raises(ValueError, match="no kernel"):
        _kernel(name, "wgmma", good, good, good)


def _tc_emulation(q, k, v, window=-1, *, split=True, tk=64):
    """The tensor-core kernel's arithmetic on the CPU: 64-key tiles, fp32
    scores from the bf16 inputs, an fp32 online softmax, unnormalised p
    entering the PV product as bf16 (``split``: hi = bf16(p) plus
    lo = bf16(p - hi), as the kernel does; else hi alone), l summed in fp32
    from the unrounded p, out = acc / max(l, 1e-30) rounded to bf16."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.float().reshape(B, Sq, Hkv, G, hd).permute(0, 2, 1, 3, 4).reshape(
        B, Hkv, Sq * G, hd)
    kf, vf = k.float().permute(0, 2, 1, 3), v.float().permute(0, 2, 1, 3)
    qa = torch.arange(Sq * G) // G + (Skv - Sq)
    m = torch.full(qg.shape[:3], -math.inf)
    l = torch.zeros(qg.shape[:3])
    acc = torch.zeros(qg.shape)
    for j0 in range(0, Skv, tk):
        s = (qg @ kf[:, :, j0:j0 + tk].transpose(-1, -2)) * (1.0 / math.sqrt(hd))
        dist = qa[:, None] - torch.arange(j0, min(j0 + tk, Skv))[None]
        ok = (dist >= 0) & ((dist < window) if window > 0 else True)
        s = torch.where(ok, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        hi = p.bfloat16().float()
        pv = hi + (p - hi).bfloat16().float() if split else hi
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + pv @ vf[:, :, j0:j0 + tk]
        m = m_new
    o = acc / l.clamp_min(1e-30)[..., None]
    return o.reshape(B, Hkv, Sq, G, hd).permute(0, 2, 1, 3, 4).reshape(
        B, Sq, Hq, hd).bfloat16()


def _bf16_qkv(seed, *shape):
    q, k, v = (t.bfloat16() for t in _real_qkv(seed, *shape))
    return q, k, v


def _tol_ratio(got, want, tol):
    return float(((got.double() - want.double()).abs() / tol).max())


@pytest.mark.parametrize("b,sq,skv,hq,hkv,hd,win", [
    (2, 96, 96, 4, 4, 64, -1),  # G = 1
    (2, 80, 80, 8, 4, 128, 33),  # G = 2, window
    (1, 40, 150, 8, 2, 64, -1),  # G = 4, Sq < Skv
    (1, 70, 200, 8, 4, 256, 1),  # window 1: one key a row
    (3, 5, 5, 4, 2, 64, -1),  # rows with few keys
])
def test_tc_emulation_within_bf16_tol(b, sq, skv, hq, hkv, hd, win):
    """The kernel's rounding (p split into two bf16 terms) stays within
    attention_bf16_tol of the port's plain version and of the JAX
    package's flash_attention_ref on the same bf16 inputs."""
    q, k, v = _bf16_qkv(12, b, sq, skv, hq, hkv, hd)
    got = _tc_emulation(q, k, v, win)
    tol = fp32_bound.attention_bf16_tol(q, k, v, window=win)
    assert _tol_ratio(got, flash_attention_ref(q, k, v, window=win), tol) <= 1.0
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v))
    want = torch.as_tensor(np.asarray(j_flash_ref(jq, jk, jv, window=win), np.float32))
    assert _tol_ratio(got, want, tol) <= 1.0


def test_single_bf16_rounding_of_p_breaks_the_tol():
    """Why the kernel splits p: rounded once to bf16, the unnormalised
    weights carry a second rounding beside the plain version's, and the
    gap leaves attention_bf16_tol (batch 8 gives the few-key rows enough
    samples); the split holds it with room."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(4, 8, 64, 64, 8, 4, 64))
    q = q / q.pow(2).mean(-1, keepdim=True).sqrt()
    k = k / k.pow(2).mean(-1, keepdim=True).sqrt()
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    want = flash_attention_ref(q, k, v)
    tol = fp32_bound.attention_bf16_tol(q, k, v)
    assert _tol_ratio(_tc_emulation(q, k, v, split=False), want, tol) > 1.0
    assert _tol_ratio(_tc_emulation(q, k, v), want, tol) <= 0.8


# ---------------------------------------------------------------------------
# the CUDA kernels against the plain version (on the card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


CUDA_SHAPES = [  # b, sq, skv, hq, hkv, hd, win
    *[s[:7] for s in SHAPES],
    (2, 200, 200, 8, 4, 128, -1),  # lengths off the 64 tile
    (1, 77, 333, 6, 2, 128, 1),  # Sq < Skv, window 1
    (2, 130, 1100, 8, 4, 256, 1024),  # gemma3's local window, history
    (1, 1100, 1100, 8, 4, 256, -1),  # gemma3's global layers
    (1, 3, 90, 24, 8, 128, 1024),  # llama's 3 query heads per KV head
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,hq,hkv,hd,win", CUDA_SHAPES)
def test_cuda_bf16_matches_plain(cuda, b, sq, skv, hq, hkv, hd, win):
    q, k, v = (t.bfloat16().to(cuda) for t in _real_qkv(9, b, sq, skv, hq, hkv, hd))
    before = flash_attention.launches
    got = flash_attention(q, k, v, window=win)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, window=win)
    tol = fp32_bound.attention_bf16_tol(q, k, v, window=win)
    assert got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got).all())
    assert float(((got.double() - want.double()).abs() / tol).max()) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,hq,hkv,hd,win", CUDA_SHAPES)
def test_cuda_fp32_within_bound(cuda, b, sq, skv, hq, hkv, hd, win):
    q, k, v = (t.to(cuda) for t in _real_qkv(10, b, sq, skv, hq, hkv, hd))
    exact, tol = fp32_bound.attention_f64(q, k, v, window=win)
    got = flash_attention(q, k, v, window=win)
    torch.cuda.synchronize()
    assert fp32_bound.attention_error_ratio(got, exact, tol) <= 1.0
    np.testing.assert_allclose(_f32(got), _f32(flash_attention_ref(q, k, v, window=win)),
                               rtol=2e-4, atol=2e-4)
    if min(win if win > 0 else skv, skv - sq + 1) > 64:
        # Every row spreads over many keys, where TF32's errors cancel: the
        # control runs on a peaked copy (q x 8, exact in fp32), which rests
        # each row on a few keys, and the kernel must hold the bound there too.
        q = q * 8
        exact, tol = fp32_bound.attention_f64(q, k, v, window=win)
        got = flash_attention(q, k, v, window=win)
        torch.cuda.synchronize()
        assert fp32_bound.attention_error_ratio(got, exact, tol) <= 1.0
    # TF32 rounding emulated: cuBLAS keeps small products (a few query rows)
    # in fp32 even with allow_tf32 set, so the flag is no control there.
    assert fp32_bound.attention_error_ratio(_ref_tf32(q, k, v, win), exact, tol) > 1.0


@pytest.mark.cuda
def test_cuda_reads_strided_cache_views(cuda):
    """q, k, v as views of larger tensors (a KV cache's leading rows, heads
    of a fused projection) give what dense copies give."""
    L, B, S_max, Hkv, hd = 2, 2, 160, 2, 128
    g = torch.Generator().manual_seed(11)
    cache = torch.randn((L, B, S_max, Hkv, hd), generator=g).bfloat16().to(cuda)
    qkv = torch.randn((B, 100, 6, hd), generator=g).bfloat16().to(cuda)
    q, k, v = qkv[:, :, :4], cache[0, :, :130], cache[1, :, :130]
    got = flash_attention(q, k, v, window=50)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), window=50)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 2, 24), device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :, :1], q[:, :, :1])  # hd 24
    q = torch.zeros((1, 8, 3, 16), device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :, :2], q[:, :, :2])  # 3 heads over 2
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :4, :1], q[:, :4, :1])  # Sq > Skv
    with pytest.raises(TypeError):
        h = q.half()
        flash_attention(h, h[:, :, :1], h[:, :, :1])


TC_CASES = [  # b, sq, skv, hq, hkv, hd, win
    *[(2, 150, 150, hkv * g, hkv, hd, -1) for hd in (64, 128, 256)
      for g, hkv in ((1, 4), (2, 2), (4, 1))],
    (2, 300, 300, 8, 4, 256, 64),  # window shorter than the prompt
    (1, 70, 333, 4, 2, 128, 1),  # Sq < Skv, window 1
    (1, 3, 90, 24, 8, 128, 1024),  # three decode tokens on a cache
    (2, 5, 5, 8, 4, 64, -1),  # rows with few keys
    (1, 1, 1, 2, 1, 256, -1),  # one key
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,hq,hkv,hd,win", TC_CASES)
def test_cuda_tensor_core_matches_plain(cuda, b, sq, skv, hq, hkv, hd, win):
    """The tensor-core kernel (the rule's choice for bf16 at these head
    dimensions) within attention_bf16_tol of the plain version, as the
    CUDA-core kernel is on the same inputs."""
    q, k, v = (t.to(cuda) for t in _bf16_qkv(13, b, sq, skv, hq, hkv, hd))
    want = flash_attention_ref(q, k, v, window=win)
    tol = fp32_bound.attention_bf16_tol(q, k, v, window=win)
    before = dict(flash_attention.variant_launches)
    got = flash_attention(q, k, v, window=win)
    torch.cuda.synchronize()
    assert flash_attention.variant_launches["tensor_core"] == before["tensor_core"] + 1
    assert flash_attention.variant_launches["cuda_core"] == before["cuda_core"]
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    assert _tol_ratio(got, want, tol) <= 1.0
    other = flash_attention(q, k, v, window=win, kernel="cuda_core")
    torch.cuda.synchronize()
    assert _tol_ratio(other, want, tol) <= 1.0


@pytest.mark.cuda
def test_cuda_tensor_core_reads_strided_views(cuda):
    """A KV cache's leading rows and heads of a fused projection, read
    through their strides, give what dense copies give."""
    g = torch.Generator().manual_seed(14)
    cache = torch.randn((2, 2, 300, 4, 256), generator=g).bfloat16().to(cuda)
    qkv = torch.randn((2, 3, 16, 256), generator=g).bfloat16().to(cuda)
    q, k, v = qkv[:, :, :8], cache[0, :, :203], cache[1, :, :203]
    got = flash_attention(q, k, v, window=1024)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), window=1024)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_tensor_core_rejects_misaligned_rows(cuda):
    base = torch.zeros(8 * 2 * 132, dtype=torch.bfloat16, device=cuda)
    odd = base.as_strided((1, 8, 2, 64), (8 * 132, 132, 64, 1))  # stride 132
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(odd, odd, odd)
    shifted = base[1:1 + 8 * 2 * 64].view(1, 8, 2, 64)  # 2 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(shifted, shifted, shifted)
    with pytest.raises(ValueError, match="tensor-core"):
        flash_attention(odd.float(), odd.float(), odd.float(), kernel="tensor_core")


# ---------------------------------------------------------------------------
# the gradient: FlashAttention, the plain backward and its bounds
# ---------------------------------------------------------------------------


def _dout(seed, q):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(tuple(q.shape)).astype(np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_cpu_gradient_matches_jax_vjp(shape, dtype):
    """The wrapper on tensors that require grad (plain forward with lse,
    then ``flash_attention_bwd_ref``) against ``jax.vjp`` of the reference's
    ``flash_attention_ref``: within 1e-5 x the gradient's largest entry in
    fp32 (sums in another order), 2e-2 x in bf16 (the reference rounds its
    weights and their gradient to bf16 inside the vjp; the port sums in
    fp32 and rounds each gradient once)."""
    b, sq, skv, hq, hkv, hd, win, _, _ = shape
    tdt, jdt, _ = DTYPES[dtype]
    arrays = (*_qkv(21, b, sq, skv, hq, hkv, hd), _dout(22, torch.zeros(b, sq, hq, hd)).numpy())
    (jq, jk, jv, jg), (q, k, v, g) = _both(arrays, tdt, jdt)
    _, vjp = jax.vjp(lambda q_, k_, v_: j_flash_ref(q_, k_, v_, window=win), jq, jk, jv)
    wants = vjp(jg)
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    out = flash_attention(q, k, v, window=win)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    np.testing.assert_allclose(_f32(out.detach()), _f32(flash_attention_ref(
        q.detach(), k.detach(), v.detach(), window=win)), rtol=0, atol=0)
    out.backward(g)
    rel = 1e-5 if dtype == "float32" else 2e-2
    for got, want in zip((q.grad, k.grad, v.grad), wants):
        assert got.dtype == tdt
        want = _f32(want)
        np.testing.assert_allclose(_f32(got), want, rtol=0,
                                   atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_ref_equals_float64_autograd(shape):
    """The explicit formulas on float64 inputs equal torch autograd of the
    plain forward in float64 (within 1e-12 x the gradient's scale)."""
    b, sq, skv, hq, hkv, hd, win, _, _ = shape
    q, k, v = (torch.as_tensor(a).double() for a in _qkv(23, b, sq, skv, hq, hkv, hd))
    g = _dout(24, q).double()
    out, lse = flash_attention_lse_ref(q, k, v, window=win)
    got = flash_attention_bwd_ref(q, k, v, out, lse, g, window=win)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    flash_attention_ref(qa, ka, va, window=win).backward(g)
    for a, want in zip(got, (qa.grad, ka.grad, va.grad)):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, want, rtol=0,
                                   atol=1e-12 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_lse_matches_float64_logsumexp(dtype):
    """``lse`` is the log-sum-exp of the forward's own fp32 scores: within
    1e-6 x (1 + |lse|) of float64's (the scores' and the sum's roundings)."""
    q, k, v = (torch.as_tensor(a).to(dtype) for a in _qkv(25, 2, 40, 72, 6, 2, 16))
    out, lse = flash_attention_lse_ref(q, k, v, window=20)
    assert lse.shape == (2, 6, 40) and lse.dtype == torch.float32
    torch.testing.assert_close(out, flash_attention_ref(q, k, v, window=20), rtol=0, atol=0)
    s = torch.einsum("bqkgh,bskh->bkgqs", q.double().reshape(2, 40, 2, 3, 16),
                     k.double()) / math.sqrt(16)
    s = torch.where(attention_mask(40, 72, 20, "cpu"), s, -math.inf)
    want = torch.logsumexp(s, -1).reshape(2, 6, 40)
    assert float(((lse.double() - want).abs() / (1 + want.abs())).max()) <= 1e-6


def _bwd_tf32(q, k, v, out, lse, dout, window):
    """The plain backward with every product's inputs rounded to TF32."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = _tf32(q).reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, _tf32(k)) * (1.0 / math.sqrt(hd))
    s = torch.where(attention_mask(Sq, Skv, window, q.device), s, -1e30)
    p = torch.exp(s - lse.reshape(B, Hkv, G, Sq, 1))
    dog = dout.float().reshape(B, Sq, Hkv, G, hd)
    d = (dog * out.float().reshape(B, Sq, Hkv, G, hd)).sum(-1)
    dp = torch.einsum("bqkgh,bskh->bkgqs", _tf32(dog), _tf32(v))
    ds = p * (dp - d.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskh->bqkgh", _tf32(ds), _tf32(k)) * (1.0 / math.sqrt(hd))
    dk = torch.einsum("bkgqs,bqkgh->bskh", _tf32(ds), qg) * (1.0 / math.sqrt(hd))
    dv = torch.einsum("bkgqs,bqkgh->bskh", _tf32(p), _tf32(dog))
    return dq.reshape(B, Sq, Hq, hd), dk, dv


@pytest.mark.parametrize("b,sq,skv,hq,hkv,hd,win", [
    (1, 64, 64, 4, 2, 8, -1), (1, 48, 96, 4, 2, 32, 20), (1, 128, 128, 4, 2, 128, -1),
    (2, 96, 96, 8, 4, 64, 33)])
def test_grads_fp32_bound_holds_plain_and_breaks_tf32(b, sq, skv, hq, hkv, hd, win):
    """The plain backward in fp32 within half the fp32 bound of the float64
    gradient; the same formulas with TF32-rounded products break it."""
    q, k, v = _real_qkv(26, b, sq, skv, hq, hkv, hd)
    g = _dout(27, q)
    out, lse = flash_attention_lse_ref(q, k, v, window=win)
    exact, tol, _ = fp32_bound.attention_grads_f64(q, k, v, g, window=win, rows=40)
    got = flash_attention_bwd_ref(q, k, v, out, lse, g, window=win)
    assert fp32_bound.grads_error_ratio(got, exact, tol) <= 0.5
    tf = _bwd_tf32(q, k, v, out, lse, g, win)
    assert fp32_bound.grads_error_ratio(tf, exact, tol) > 4.0


def test_grads_oracle_row_chunks_agree():
    q, k, v = _real_qkv(28, 2, 40, 56, 4, 2, 16)
    g = _dout(29, q)
    a = fp32_bound.attention_grads_f64(q, k, v, g, window=9, rows=7)
    b = fp32_bound.attention_grads_f64(q, k, v, g, window=9, rows=64)
    for x3, y3 in zip(a, b):
        for x, y in zip(x3, y3):
            torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-300)


def _grad_variants(q, k, v, out, lse, g, win):
    """Plain backward variants that must fail the bf16 check, each built
    from ``flash_attention_bwd_ref``: the causal diagonal one key back (the
    last key dropped, so key j stands where j + 1 did; its dk and dv rows
    zero), (with a window) the window one longer, the GQA head map shifted
    by one, dk and dv taken from each group's first query head alone."""
    G = q.shape[2] // k.shape[2]
    dq = flash_attention_bwd_ref(q, k, v, out, lse, g, window=win)[0]
    sq, sk, sv = flash_attention_bwd_ref(q, k[:, :-1], v[:, :-1], out, lse, g, window=win)
    hq, hk, hv = flash_attention_bwd_ref(q, k.roll(1, dims=2), v.roll(1, dims=2), out,
                                         lse, g, window=win)
    first = flash_attention_bwd_ref(q[:, :, ::G], k, v, out[:, :, ::G], lse[:, ::G],
                                    g[:, :, ::G], window=win)
    out_v = {
        "diagonal_off_by_one": (sq, *(torch.cat([t, torch.zeros_like(t[:, :1])], 1)
                                      for t in (sk, sv))),
        "heads_shifted": (hq, hk.roll(-1, dims=2), hv.roll(-1, dims=2)),
        "dk_not_summed_over_group": (dq, first[1], first[2]),
    }
    if win > 0:
        out_v["window_plus_one"] = flash_attention_bwd_ref(q, k, v, out, lse, g,
                                                           window=win + 1)
    return out_v


@pytest.mark.parametrize("b,sq,skv,hq,hkv,hd,win", [
    (1, 64, 64, 4, 2, 8, -1), (1, 48, 96, 4, 2, 32, 20), (2, 96, 96, 8, 4, 64, 33),
    (1, 80, 80, 8, 4, 128, -1)])
def test_grads_bf16_tol_holds_plain_and_separates_faults(b, sq, skv, hq, hkv, hd, win):
    """The plain backward on bf16 inputs, from the bf16 forward's out and
    lse, within the bf16 tolerance of the float64 gradient; each broken
    variant outside it."""
    q, k, v = (t.bfloat16() for t in _real_qkv(30, b, sq, skv, hq, hkv, hd))
    g = _dout(31, q).bfloat16()
    out, lse = flash_attention_lse_ref(q, k, v, window=win)
    exact, _, tol = fp32_bound.attention_grads_f64(q, k, v, g, window=win)
    got = flash_attention_bwd_ref(q, k, v, out, lse, g, window=win)
    assert all(t.dtype == torch.bfloat16 for t in got)
    assert fp32_bound.grads_error_ratio(got, exact, tol) <= 1.0
    for name, bad in _grad_variants(q, k, v, out, lse, g, win).items():
        assert fp32_bound.grads_error_ratio(bad, exact, tol) > 1.0, name


def _terms(x, split):
    """``x`` as the kernel feeds it to an mma: hi = bf16(x) plus, with
    ``split``, lo = bf16(x - hi)."""
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float() if split else hi


def _tc_bwd_emulation(q, k, v, out, lse, dout, window=-1, *, split=("p", "ds")):
    """The tensor-core backward's arithmetic on the CPU: D in fp32; the
    dk/dv pass over 64-key tiles, each walking the flattened (position,
    head-in-group) rows that see it from its first in steps of 32, fp32
    scores S^T and dP^T from the bf16 inputs, P = exp(s * scale - lse)
    (exactly 0 where masked) and dS = P (dP - D) in fp32, then fp32 tile
    sums dV += P^T dout and dK += dS^T Q; the dq pass over 64-key tiles,
    dQ += dS K. P and dS enter the sums as bf16 terms (hi + lo for the names
    in ``split``, else hi alone); each gradient is scaled and rounded to
    bf16 once."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G, N, qoff = Hq // Hkv, Sq * Hq // Hkv, Skv - Sq
    scale = 1.0 / math.sqrt(hd)
    bc, br = 64, 32  # keys a dk/dv block and a dq step, rows a dk/dv step

    def rows(t):  # (B, Sq, Hq, x) -> (B, Hkv, Sq * G, x): the kernel's row order
        return t.float().reshape(B, Sq, Hkv, G, -1).permute(0, 2, 1, 3, 4).reshape(
            B, Hkv, N, -1)

    qg, gg = rows(q), rows(dout)
    dd = (gg * rows(out)).sum(-1)
    ll = rows(lse.permute(0, 2, 1)[..., None])[..., 0]
    kf, vf = k.float().permute(0, 2, 1, 3), v.float().permute(0, 2, 1, 3)
    pos = torch.arange(N) // G + qoff

    def p_ds(n0, n1, j0, j1):
        s = qg[:, :, n0:n1] @ kf[:, :, j0:j1].transpose(-1, -2)
        dp = gg[:, :, n0:n1] @ vf[:, :, j0:j1].transpose(-1, -2)
        dist = pos[n0:n1, None] - torch.arange(j0, j1)[None]
        ok = (dist >= 0) & ((dist < window) if window > 0 else True)
        p = torch.exp(torch.where(ok, s * scale, -1e30) - ll[:, :, n0:n1, None])
        return p, p * (dp - dd[:, :, n0:n1, None])

    dk, dv, dq = torch.zeros(kf.shape), torch.zeros(vf.shape), torch.zeros(qg.shape)
    for j0 in range(0, Skv, bc):
        j1 = min(j0 + bc, Skv)
        n_lo = max(0, j0 - qoff) * G
        n_hi = min(N, max(0, (j0 + bc - 1 + window - qoff) * G)) if window > 0 else N
        for n0 in range(n_lo, n_hi, br):
            n1 = min(n0 + br, n_hi)
            p, ds = p_ds(n0, n1, j0, j1)
            dv[:, :, j0:j1] += _terms(p, "p" in split).transpose(-1, -2) @ gg[:, :, n0:n1]
            dk[:, :, j0:j1] += _terms(ds, "ds" in split).transpose(-1, -2) @ qg[:, :, n0:n1]
        dq += _terms(p_ds(0, N, j0, j1)[1], "ds" in split) @ kf[:, :, j0:j1]
    dq = (dq * scale).reshape(B, Hkv, Sq, G, hd).permute(0, 2, 1, 3, 4).reshape(
        B, Sq, Hq, hd)
    return (dq.bfloat16(), (dk * scale).permute(0, 2, 1, 3).bfloat16(),
            dv.permute(0, 2, 1, 3).bfloat16())


@pytest.mark.parametrize("b,sq,skv,hq,hkv,hd,win", [
    (2, 96, 96, 4, 4, 64, -1),  # G = 1
    (2, 80, 80, 8, 4, 128, 33),  # G = 2, window
    (1, 40, 150, 8, 2, 64, -1),  # G = 4, Sq < Skv
    (1, 70, 200, 8, 4, 256, 1),  # window 1: one key a row
    (3, 5, 5, 4, 2, 64, -1),  # rows with few keys
])
def test_tc_bwd_emulation_within_bf16_tol(b, sq, skv, hq, hkv, hd, win):
    """The tensor-core backward's rounding (P and dS split into two bf16
    terms) within attention_grads_f64's bf16 tolerance, from the bf16
    forward's out and lse, as the plain backward is."""
    q, k, v = _bf16_qkv(12, b, sq, skv, hq, hkv, hd)
    g = _dout(33, q).bfloat16()
    out, lse = flash_attention_lse_ref(q, k, v, window=win)
    exact, _, tol = fp32_bound.attention_grads_f64(q, k, v, g, window=win)
    got = _tc_bwd_emulation(q, k, v, out, lse, g, win)
    assert fp32_bound.grads_error_ratio(got, exact, tol) <= 1.0
    plain = flash_attention_bwd_ref(q, k, v, out, lse, g, window=win)
    assert fp32_bound.grads_error_ratio(plain, exact, tol) <= 1.0


@pytest.mark.parametrize("b,sq,skv,hq,hkv,hd,win", [
    (2, 80, 80, 8, 4, 128, 33), (1, 40, 150, 8, 2, 64, -1)])
def test_tc_bwd_emulation_matches_jax_vjp(b, sq, skv, hq, hkv, hd, win):
    """The emulation against ``jax.vjp`` of the JAX package's
    flash_attention_ref on the same bf16 inputs, as the CPU path is held
    (``test_cpu_gradient_matches_jax_vjp``: 2e-2 x the gradient's largest
    entry), at two of the shapes above (a window with G = 2; G = 4 with
    Sq < Skv): each vjp compiles for a few seconds."""
    q, k, v = _bf16_qkv(12, b, sq, skv, hq, hkv, hd)
    g = _dout(33, q).bfloat16()
    out, lse = flash_attention_lse_ref(q, k, v, window=win)
    got = _tc_bwd_emulation(q, k, v, out, lse, g, win)
    jq, jk, jv, jg = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                      for t in (q, k, v, g))
    _, vjp = jax.vjp(lambda q_, k_, v_: j_flash_ref(q_, k_, v_, window=win), jq, jk, jv)
    for a, want in zip(got, vjp(jg)):
        want = _f32(want)
        np.testing.assert_allclose(_f32(a), want, rtol=0,
                                   atol=2e-2 * float(np.abs(want).max()))


def test_single_bf16_rounding_of_p_and_ds_breaks_the_tol():
    """Why the backward splits P and dS: rounded once to bf16, P carries a
    second rounding into every term of dv's sums, and dS into dk's, which
    leave the bf16 tolerance where the sums cancel (batch 8 gives enough
    samples); the split holds it."""
    q, k, v = _bf16_qkv(12, 8, 64, 64, 8, 4, 64)
    g = _dout(34, q).bfloat16()
    out, lse = flash_attention_lse_ref(q, k, v)
    exact, _, tol = fp32_bound.attention_grads_f64(q, k, v, g)

    def ratios(**kw):  # (dq, dk, dv)
        return [fp32_bound.grads_error_ratio((a,), (e,), (t,)) for a, e, t in zip(
            _tc_bwd_emulation(q, k, v, out, lse, g, **kw), exact, tol)]

    assert max(ratios()) <= 1.0
    assert ratios(split=("ds",))[2] > 1.0  # P rounded once: dv
    assert ratios(split=("p",))[1] > 1.0  # dS rounded once: dk


def test_no_grad_keeps_the_plain_call():
    """Without grad (or with grad off) the wrapper returns a plain result."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(32, 1, 8, 8, 2, 1, 8))
    assert flash_attention(q, k, v).grad_fn is None
    qr = q.clone().requires_grad_()
    with torch.no_grad():
        assert flash_attention(qr, k, v).grad_fn is None
    assert flash_attention(q, k, v.clone().requires_grad_()).grad_fn is not None


def _chunked_layer_grads(device, flash):
    """Gradients of one chunked layer's weights through the transformer's
    attention (``_attend_flash`` when ``flash``, else the chunked plain
    path) at a smoke size."""
    cfg = tfm.TransformerConfig(name="t", n_layers=1, d_model=32, n_heads=4,
                                n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
                                dtype="float32", attn_impl="chunked", attn_chunk=8)
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models.module import init_params
    params = init_params(cfg.param_specs(), gen, device="cpu")
    params = {"embed": params["embed"], "final_norm": params["final_norm"],
              "layers": {key: t.to(device).requires_grad_() for key, t in
                         params["layers"].items()}}
    params["embed"] = params["embed"].to(device)
    params["final_norm"] = params["final_norm"].to(device)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, 64, (2, 24)),
                             device=device)
    real = tfm.attend_chunked

    def via_flash(q, k, v, *, q_pos, kv_pos, window, kv_valid_len=None, chunk=1024):
        return tfm._attend_flash(q, k, v, window=window, kv_valid_len=kv_valid_len)

    if flash:  # through the backward too: remat runs the layers again there
        tfm.attend_chunked = via_flash
    try:
        logits, _ = tfm.forward(params, cfg, tokens, device=device)
        logits.square().mean().backward()
    finally:
        tfm.attend_chunked = real
    return {name: params["layers"][name].grad for name in ("wq", "wk", "wv", "wo")}


def test_chunked_layer_projections_get_gradients():
    """A chunked layer's wq, wk and wv receive gradients: through the plain
    chunked path, and through ``_attend_flash`` (``FlashAttention`` on the
    CPU), where they agree with it."""
    plain = _chunked_layer_grads("cpu", flash=False)
    flash = _chunked_layer_grads("cpu", flash=True)
    for name in ("wq", "wk", "wv", "wo"):
        assert plain[name] is not None and flash[name] is not None, name
        assert float(flash[name].abs().max()) > 0, name
        torch.testing.assert_close(flash[name], plain[name], rtol=1e-4,
                                   atol=1e-6 * float(plain[name].abs().max()))


@pytest.mark.cuda
def test_cuda_chunked_layer_projections_get_gradients(cuda):
    """On the card the chunked path is K6 with its kernel backward: the
    projections get the gradients the CPU's plain path gives."""
    from repro_torch.kernels import _build  # noqa: F401  (builds on first launch)

    before = flash_attention_bwd.launches
    got = _chunked_layer_grads(cuda, flash=False)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = _chunked_layer_grads("cpu", flash=False)
    for name in ("wq", "wk", "wv", "wo"):
        torch.testing.assert_close(got[name].cpu(), want[name], rtol=1e-3,
                                   atol=1e-4 * float(want[name].abs().max()))


BWD_CASES = [  # b, sq, skv, hq, hkv, hd, win
    (2, 64, 64, 4, 2, 16, -1), (1, 32, 64, 6, 2, 8, 12), (2, 128, 128, 8, 8, 32, -1),
    (1, 64, 64, 4, 1, 16, 7), (2, 200, 200, 8, 4, 128, -1), (1, 77, 333, 6, 2, 128, 1),
    (1, 130, 300, 8, 4, 256, 100), (2, 150, 150, 4, 4, 64, -1), (1, 3, 90, 24, 8, 128, 1024),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["tensor_core", "cuda_core"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,hd,win", BWD_CASES)
def test_cuda_backward_matches_plain(cuda, kernel, dtype, b, sq, skv, hq, hkv, hd, win):
    """Each variant, forced with ``kernel=`` (``FlashAttention`` hands it to
    the backward): the forward's lse and the backward against the plain
    versions on the same inputs: lse within 1e-5 x (1 + |lse|); fp32
    gradients within the fp32 bound of the float64 oracle, bf16 ones within
    its bf16 tolerance; two runs bit-identical. The tensor-core variant
    raises on what it does not take (fp32, hd below 64)."""
    q, k, v = (t.to(cuda, dtype) for t in _real_qkv(40, b, sq, skv, hq, hkv, hd))
    g = _dout(41, q).to(cuda, dtype)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    if kernel == "tensor_core" and variant(dtype, hd) != "tensor_core":
        with pytest.raises(ValueError, match="tensor-core"):
            flash_attention(qr, kr, vr, window=win, kernel=kernel)
        _, lse = flash_attention_lse_ref(q, k, v, window=win)
        with pytest.raises(ValueError, match="tensor-core"):
            flash_attention_bwd(q, k, v, q, lse, g, window=win, kernel=kernel)
        return
    before = dict(flash_attention_bwd.variant_launches)
    out = flash_attention(qr, kr, vr, window=win, kernel=kernel)
    out.backward(g, retain_graph=True)
    assert flash_attention_bwd.variant_launches[kernel] == before[kernel] + 1
    _, lse = flash_attention_lse_ref(q, k, v, window=win)
    exact, tol32, tol16 = fp32_bound.attention_grads_f64(q, k, v, g, window=win)
    got = (qr.grad, kr.grad, vr.grad)
    torch.cuda.synchronize()
    assert all(t.dtype == dtype for t in got)
    assert fp32_bound.grads_error_ratio(got, exact, tol32 if dtype == torch.float32
                                        else tol16) <= 1.0
    # lse of the kernel's forward
    saved = out.grad_fn.saved_tensors
    assert float(((saved[4].double() - lse.double()).abs() / (1 + lse.double().abs()))
                 .max()) <= 1e-5
    again = flash_attention_bwd(q, k, v, saved[3], saved[4], g, window=win, kernel=kernel)
    again2 = flash_attention_bwd(q, k, v, saved[3], saved[4], g, window=win, kernel=kernel)
    torch.cuda.synchronize()
    for a, b_, c in zip(got, again, again2):
        assert torch.equal(a, b_) and torch.equal(b_, c)


@pytest.mark.cuda
def test_cuda_tensor_core_backward_reads_strided_views(cuda):
    """q, k, v as views (a fused projection's heads, a cache's leading
    rows) give the gradients dense copies give, bit for bit."""
    gen = torch.Generator().manual_seed(42)
    cache = torch.randn((2, 2, 300, 4, 128), generator=gen).bfloat16().to(cuda)
    qkv = torch.randn((2, 203, 16, 128), generator=gen).bfloat16().to(cuda)
    q, k, v = qkv[:, :, :8], cache[0, :, :203], cache[1, :, :203]
    dout = torch.randn((2, 203, 8, 128), generator=gen).bfloat16().to(cuda)
    out, lse = fa_forward(q, k, v, 64, None)
    got = flash_attention_bwd(q, k, v, out, lse, dout, window=64)
    want = flash_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(), out, lse,
                               dout, window=64)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_cuda_tensor_core_backward_rejects_misaligned_rows(cuda):
    base = torch.zeros(8 * 2 * 132 + 8, dtype=torch.bfloat16, device=cuda)
    lse = torch.zeros((1, 2, 8), device=cuda)
    good = base[:8 * 2 * 64].view(1, 8, 2, 64)
    odd = base.as_strided((1, 8, 2, 64), (8 * 132, 132, 64, 1))  # stride 132
    shifted = base[1:1 + 8 * 2 * 64].view(1, 8, 2, 64)  # 2 bytes off
    for q, out in ((odd, good), (shifted, good), (good, shifted)):
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention_bwd(q, good, good, out, lse, good)
    with pytest.raises(ValueError, match="tensor-core"):
        flash_attention_bwd(good.float(), good.float(), good.float(), good.float(), lse,
                            good.float(), kernel="tensor_core")
