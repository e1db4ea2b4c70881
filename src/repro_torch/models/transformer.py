"""Decoder-only dense transformer (dense / GQA / sliding-window) in PyTorch.

The dense part of the JAX package's ``models/transformer.py``, with its
names, its ``(B, S, H, hd)`` layout and its fp32 -> compute-dtype cast
points: ``forward``, ``prefill`` and ``decode_step`` over a dict of
stacked ``(L, ...)`` weights. Layers run as a Python loop (the reference
scans them). Where the reference asks for fp32 products of bf16 operands
(``preferred_element_type``: the attention logits, the chunked PV sums
and the lm head), both operands are upcast and multiplied in fp32 with
TF32 off; a bf16 product is exact in fp32, so this computes the same sums.
The projections and the FFN stay in the compute dtype, as XLA leaves them.

``attn_impl="chunked"`` with more than one query runs the flash dataflow:
on a CUDA tensor the K6 kernel (``kernels.flashattn.ops.flash_attention``,
``csrc/flashattn.cu``), on a CPU tensor the plain ``attend_chunked``.
``attn_impl="full"`` and single-token decode run ``attend``, as the
reference does. MoE (``cfg.moe``) is not ported yet (ROADMAP M14).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve
from repro_torch.kernels.flashattn.ops import flash_attention
from repro_torch.models.module import ParamSpec, param_count

torch.backends.cuda.matmul.allow_tf32 = False  # fp32 products stay fp32

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden dim
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    window: int = 0  # 0 = all layers global attention
    global_every: int = 0  # >0: layer i is global iff (i+1) % global_every == 0
    moe: Optional[MoEConfig] = None
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-6
    scale_embed: bool = False  # gemma-style sqrt(d_model) input scaling
    qk_norm: bool = False
    dtype: str = "bfloat16"
    remat: str = "dots"  # kept for parity; the port has no backward yet
    moe_impl: str = "global"
    # "full": one (Sq, Skv) logits tensor; "chunked": the flash dataflow
    # (K6 on the card, attend_chunked's KV-chunk loop on the CPU)
    attn_impl: str = "full"
    attn_chunk: int = 1024

    def __post_init__(self):
        if self.moe is not None:
            raise NotImplementedError(
                "repro_torch: MoE layers are not ported yet (ROADMAP M14)")

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def window_sizes(self) -> list[int]:
        """Per-layer attention window; -1 = unbounded (global)."""
        if self.window <= 0:
            return [-1] * self.n_layers
        return [-1 if self.global_every > 0 and (i + 1) % self.global_every == 0
                else self.window for i in range(self.n_layers)]

    def param_specs(self):
        L, D, V = self.n_layers, self.d_model, self.vocab_size
        qd, kvd, hd, Fd = self.q_dim, self.kv_dim, self.head_dim, self.d_ff
        layer = {
            "attn_norm": ParamSpec((L, D), ("layers", "embed"), init="ones"),
            "wq": ParamSpec((L, D, qd), ("layers", "embed", "qkv")),
            "wk": ParamSpec((L, D, kvd), ("layers", "embed", "qkv")),
            "wv": ParamSpec((L, D, kvd), ("layers", "embed", "qkv")),
            "wo": ParamSpec((L, qd, D), ("layers", "qkv", "embed")),
            "mlp_norm": ParamSpec((L, D), ("layers", "embed"), init="ones"),
            "w_gate": ParamSpec((L, D, Fd), ("layers", "embed", "ffn")),
            "w_up": ParamSpec((L, D, Fd), ("layers", "embed", "ffn")),
            "w_down": ParamSpec((L, Fd, D), ("layers", "ffn", "embed")),
        }
        if self.qk_norm:
            layer["q_norm"] = ParamSpec((L, hd), ("layers", "head_dim"), init="ones")
            layer["k_norm"] = ParamSpec((L, hd), ("layers", "head_dim"), init="ones")
        return {
            "embed": ParamSpec((V, D), ("vocab", "embed"), scale=1.0),
            "layers": layer,
            "final_norm": ParamSpec((D,), ("embed",), init="ones"),
        }

    def param_count(self) -> int:
        return param_count(self.param_specs())


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _f32_product(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` with fp32 products and sums, whatever the operand dtype
    (the reference's ``preferred_element_type=jnp.float32``)."""
    return torch.einsum(eq, a.float(), b.float())


def rms_norm(x, w, eps):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def rope(x, positions, theta):
    """x: (..., S, H, hd); positions broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(
        -math.log(theta) * torch.arange(0, half, dtype=torch.float32, device=x.device)
        / half)
    angles = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


def _mask(q_pos, kv_pos, window: int, kv_valid_len):
    dist = q_pos[:, None] - kv_pos[None, :]  # (Sq, Skv)
    mask = (dist >= 0) & (dist < (window if window > 0 else 2**30))
    if kv_valid_len is not None:
        mask &= (kv_pos < kv_valid_len)[None, :]
    return mask


def attend(q, k, v, *, q_pos, kv_pos, window: int, kv_valid_len=None):
    """Grouped-query attention with causal + sliding-window mask.

    q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd); window: int (-1 =
    unbounded). kv_valid_len: mask kv positions >= it (decode).
    """
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd)
    logits = _f32_product("bqkgh,bskh->bkgqs", qg, k) * (1.0 / math.sqrt(hd))
    mask = _mask(q_pos, kv_pos, window, kv_valid_len)
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Sq, Hq * hd)


def attend_chunked(q, k, v, *, q_pos, kv_pos, window: int, kv_valid_len=None,
                   chunk=1024):
    """Flash-attention dataflow: loop over KV chunks with a running
    (max, denominator, accumulator) -- the (Sq, Skv) score matrix never
    exists; only (Sq, chunk) tiles do. Same signature/semantics as
    ``attend``."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    Skv = k.shape[1]
    if Skv % chunk:
        chunk = Skv  # degenerate fallback, as the reference
    qg = q.reshape(B, Sq, Hkv, G, hd)
    scale = 1.0 / math.sqrt(hd)
    m = torch.full((B, Hkv, G, Sq), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, hd), dtype=torch.float32, device=q.device)
    for c0 in range(0, Skv, chunk):
        k_i, v_i = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = _f32_product("bqkgh,bskh->bkgqs", qg, k_i) * scale  # (B,Hkv,G,Sq,chunk)
        mask = _mask(q_pos, kv_pos[c0:c0 + chunk], window, kv_valid_len)
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _f32_product(
            "bkgqs,bskh->bkgqh", p.to(v_i.dtype), v_i)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    # (B, Hkv, G, Sq, hd) -> (B, Sq, Hq*hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq * hd)
    return out.to(q.dtype)


def _attend_flash(q, k, v, *, window: int, kv_valid_len):
    """K6 on the card. It takes positions as arange with the query offset
    Skv - Sq, which is what every caller of the chunked path has: prefill
    and forward (q_pos = kv_pos = arange(S)), and a decode step of Sq
    tokens at cache position pos, whose keys are cut (a view, no copy) to
    the pos + Sq valid ones."""
    if kv_valid_len is not None:
        k, v = k[:, :kv_valid_len], v[:, :kv_valid_len]
    B, Sq, Hq, hd = q.shape
    return flash_attention(q, k, v, window=window).reshape(B, Sq, Hq * hd)


def _dense_ffn(x, layer):
    h = F.silu(x @ layer["w_gate"].to(x.dtype)) * (x @ layer["w_up"].to(x.dtype))
    return h @ layer["w_down"].to(x.dtype)


def _layer_body(x, layer, cfg: TransformerConfig, *, q_pos, kv_pos,
                cache_kv=None, cache_pos=None):
    """One transformer block. Returns (x, new_cache_kv, moe_drops, kv).

    ``layer`` holds one layer's weights and its ``"window"`` (an int).
    ``cache_kv`` is written in place at ``cache_pos`` (the reference
    returns an updated copy)."""
    B, Sq, D = x.shape
    h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    q = (h @ layer["wq"].to(h.dtype)).reshape(B, Sq, cfg.n_heads, cfg.head_dim)
    k = (h @ layer["wk"].to(h.dtype)).reshape(B, Sq, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ layer["wv"].to(h.dtype)).reshape(B, Sq, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, layer["q_norm"], cfg.norm_eps)
        k = rms_norm(k, layer["k_norm"], cfg.norm_eps)
    q = rope(q, q_pos, cfg.rope_theta)
    k = rope(k, q_pos, cfg.rope_theta)
    fresh_kv = (k, v)

    kv_valid_len = None
    new_cache = None
    if cache_kv is not None:
        ck, cv = cache_kv
        ck[:, cache_pos:cache_pos + Sq] = k.to(ck.dtype)
        cv[:, cache_pos:cache_pos + Sq] = v.to(cv.dtype)
        k, v = ck, cv
        new_cache = (ck, cv)
        kv_valid_len = cache_pos + Sq

    k, v = k.to(q.dtype), v.to(q.dtype)
    window = layer["window"]
    if cfg.attn_impl == "chunked" and Sq > 1:
        if q.device.type == "cuda":
            attn = _attend_flash(q, k, v, window=window, kv_valid_len=kv_valid_len)
        else:
            attn = attend_chunked(q, k, v, q_pos=q_pos, kv_pos=kv_pos, window=window,
                                  kv_valid_len=kv_valid_len, chunk=cfg.attn_chunk)
    else:
        attn = attend(q, k, v, q_pos=q_pos, kv_pos=kv_pos, window=window,
                      kv_valid_len=kv_valid_len)
    x = x + attn @ layer["wo"].to(attn.dtype)
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    x = x + _dense_ffn(h, layer)
    return x, new_cache, 0, fresh_kv


def _layers(params, cfg: TransformerConfig):
    """Each layer's weights (views of the stacked tensors) and window."""
    stacked = params["layers"]
    for i, window in enumerate(cfg.window_sizes()):
        layer = {name: t[i] for name, t in stacked.items()}
        layer["window"] = window
        yield layer


def _start(params, cfg: TransformerConfig, tokens, device):
    """Check where the weights live, move the tokens there, embed them."""
    dev = resolve(device)
    if params["embed"].device != dev:
        raise ValueError(f"params on {params['embed'].device}, run on {dev}")
    tokens = torch.as_tensor(tokens, device=dev).long()
    x = params["embed"].to(cfg.compute_dtype)[tokens]
    if cfg.scale_embed:
        # the reference's weakly typed scalar takes x's dtype before the product
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return tokens, x


def _logits(params, cfg: TransformerConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _f32_product("bsd,vd->bsv", x, params["embed"].to(x.dtype))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def forward(params, cfg: TransformerConfig, tokens, *,
            device: str | torch.device | None = "cuda"):
    """Scoring forward: tokens (B, S) -> logits (B, S, V) fp32.

    Returns (logits, aux) with aux = {"moe_drops": 0} (dense layers only).
    ``params`` must live on ``device``.
    """
    tokens, x = _start(params, cfg, tokens, device)
    pos = torch.arange(tokens.shape[1], dtype=torch.int32, device=x.device)
    for layer in _layers(params, cfg):
        x = _layer_body(x, layer, cfg, q_pos=pos, kv_pos=pos)[0]
    return _logits(params, cfg, x), {"moe_drops": 0}


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int, dtype=None, *,
               device: str | torch.device | None = "cuda"):
    """Stacked (L, B, S, Hkv, hd) KV cache (zeros)."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve(device)
    dtype = dtype or cfg.compute_dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def decode_step(params, cfg: TransformerConfig, tokens, cache, pos: int, *,
                device: str | torch.device | None = "cuda"):
    """One decode step. tokens (B, Sq); pos: the current length (an int).

    Returns (logits (B, Sq, V) fp32, cache). The cache is updated in place
    (the reference returns a new one): a step writes only its own Sq rows.
    """
    tokens, x = _start(params, cfg, tokens, device)
    S_max = cache["k"].shape[2]
    q_pos = pos + torch.arange(tokens.shape[1], dtype=torch.int32, device=x.device)
    kv_pos = torch.arange(S_max, dtype=torch.int32, device=x.device)
    for i, layer in enumerate(_layers(params, cfg)):
        x = _layer_body(x, layer, cfg, q_pos=q_pos, kv_pos=kv_pos,
                        cache_kv=(cache["k"][i], cache["v"][i]), cache_pos=pos)[0]
    return _logits(params, cfg, x), cache


def prefill(params, cfg: TransformerConfig, tokens, max_seq: int, *,
            device: str | torch.device | None = "cuda"):
    """Prefill: run the full prompt, materialising the KV cache.

    tokens (B, S); returns (logits (B, S, V) fp32, cache with S_max=max_seq).
    """
    tokens, x = _start(params, cfg, tokens, device)
    B, S = tokens.shape
    pos = torch.arange(S, dtype=torch.int32, device=x.device)
    cache = init_cache(cfg, B, max_seq, dtype=x.dtype, device=x.device)
    for i, layer in enumerate(_layers(params, cfg)):
        x, _, _, (k, v) = _layer_body(x, layer, cfg, q_pos=pos, kv_pos=pos)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    return _logits(params, cfg, x), cache
