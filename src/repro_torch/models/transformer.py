"""Decoder-only transformer (dense / GQA / sliding-window / MoE) in PyTorch.

The JAX package's ``models/transformer.py``, with its names, its
``(B, S, H, hd)`` layout and its fp32 -> compute-dtype cast points:
``forward``, ``prefill`` and ``decode_step`` over a dict of stacked
``(L, ...)`` weights. Layers run as a Python loop (the reference scans
them). Where the reference asks for fp32 products of bf16 operands
(``preferred_element_type``: the attention logits, the chunked PV sums,
the router and the lm head), both operands are upcast and multiplied in
fp32 with TF32 off; a bf16 product is exact in fp32, so this computes the
same sums. The projections, the FFN and the expert products stay in the
compute dtype, as XLA leaves them.

``attn_impl="chunked"`` with more than one query runs the flash dataflow:
on a CUDA tensor the K6 kernel (``kernels.flashattn.ops.flash_attention``,
``csrc/flashattn.cu``; with its kernel backward, ``csrc/flashattn_bwd.cu``,
when it is differentiated), on a CPU tensor the plain ``attend_chunked``.
``attn_impl="full"`` and single-token decode run ``attend``, as the
reference does.

Training: ``loss_fn`` is the reference's next-token cross entropy on the
fp32 logits. Under grad, ``cfg.remat`` runs each layer as the reference's
``jax.checkpoint`` policies do: ``"none"`` keeps every activation,
``"full"`` recomputes the layer in the backward, ``"dots"`` keeps the
outputs of the layer's plain matrix products (``aten.mm``: projections,
FFN, router; the reference's ``dots_with_no_batch_dims_saveable``) and
recomputes the rest (attention, norms, the expert ``bmm``s). The three
give bit-identical gradients. MoE layers train through the global
dispatch.

MoE layers (``cfg.moe``) route each token to its top-k experts through
``core.dispatch`` (the lookup table's counting sort, applied to experts):
the global variant dispatches every token on one device; with
``moe_impl="routed"`` and a ``DeviceMesh`` of S > 1 shards, tokens split
over the shards and each (token, expert) row travels to the shard owning
its expert and back (``collectives.all_to_all``), as the reference's
``shard_map`` variant does over its ``model`` axis. The router's logits
are computed in products of exactly :data:`ROUTER_CHUNK` rows, so a row's
logits, and so its experts, are the same whatever the call's row count.
Ties between experts go to the lower index, as ``jax.lax.top_k`` gives
them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.core.dispatch import combine_rows, dispatch_rows, make_dispatch
from repro_torch.core.route import counting_layout, scatter_to_slots
from repro_torch.device import resolve
from repro_torch.distributed import collectives
from repro_torch.distributed.meshutil import DeviceMesh
from repro_torch.kernels.flashattn.ops import flash_attention
from repro_torch.models.module import ParamSpec, param_count

torch.backends.cuda.matmul.allow_tf32 = False  # fp32 products stay fp32

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
ROUTER_CHUNK = 1024  # rows of every router product (the last chunk padded)


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
    remat: str = "dots"  # none | full | dots (under grad; see the module docstring)
    # "global": every token dispatched on one device; "routed": over the
    # shards of a mesh given to the entry points (all_to_all to the
    # experts' owners and back)
    moe_impl: str = "global"
    # "full": one (Sq, Skv) logits tensor; "chunked": the flash dataflow
    # (K6 on the card, attend_chunked's KV-chunk loop on the CPU)
    attn_impl: str = "full"
    attn_chunk: int = 1024

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
        qd, kvd, hd = self.q_dim, self.kv_dim, self.head_dim
        layer = {
            "attn_norm": ParamSpec((L, D), ("layers", "embed"), init="ones"),
            "wq": ParamSpec((L, D, qd), ("layers", "embed", "qkv")),
            "wk": ParamSpec((L, D, kvd), ("layers", "embed", "qkv")),
            "wv": ParamSpec((L, D, kvd), ("layers", "embed", "qkv")),
            "wo": ParamSpec((L, qd, D), ("layers", "qkv", "embed")),
            "mlp_norm": ParamSpec((L, D), ("layers", "embed"), init="ones"),
        }
        if self.qk_norm:
            layer["q_norm"] = ParamSpec((L, hd), ("layers", "head_dim"), init="ones")
            layer["k_norm"] = ParamSpec((L, hd), ("layers", "head_dim"), init="ones")
        if self.moe is None:
            Fd = self.d_ff
            layer["w_gate"] = ParamSpec((L, D, Fd), ("layers", "embed", "ffn"))
            layer["w_up"] = ParamSpec((L, D, Fd), ("layers", "embed", "ffn"))
            layer["w_down"] = ParamSpec((L, Fd, D), ("layers", "ffn", "embed"))
        else:
            E, Fe = self.moe.n_experts, self.moe.d_ff
            layer["router"] = ParamSpec((L, D, E), ("layers", "embed", "experts"))
            layer["w_gate"] = ParamSpec((L, E, D, Fe),
                                        ("layers", "experts", "embed", "ffn"))
            layer["w_up"] = ParamSpec((L, E, D, Fe),
                                      ("layers", "experts", "embed", "ffn"))
            layer["w_down"] = ParamSpec((L, E, Fe, D),
                                        ("layers", "experts", "ffn", "embed"))
        return {
            "embed": ParamSpec((V, D), ("vocab", "embed"), scale=1.0),
            "layers": layer,
            "final_norm": ParamSpec((D,), ("embed",), init="ones"),
        }

    def param_count(self) -> int:
        return param_count(self.param_specs())

    def active_param_count(self) -> int:
        """6*N*D bookkeeping for MoE rooflines: only routed experts count."""
        total = self.param_count()
        if self.moe is None:
            return total
        E, k, Fe = self.moe.n_experts, self.moe.top_k, self.moe.d_ff
        expert_params = self.n_layers * E * 3 * self.d_model * Fe
        return total - expert_params + self.n_layers * k * 3 * self.d_model * Fe


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


def router_logits(x2d: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """fp32 ``(T, E)`` router logits of ``(T, D)`` tokens (operands upcast,
    TF32 off), each row's in a product of exactly :data:`ROUTER_CHUNK`
    rows: cuBLAS picks its algorithm, and so a row's summation order, by
    the row count, and a pick must not depend on how many tokens share the
    call (global over T rows against routed over T / S a shard)."""
    w = router.float()
    out = torch.empty((x2d.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x2d.device)
    for s in range(0, x2d.shape[0], ROUTER_CHUNK):
        x = x2d[s:s + ROUTER_CHUNK].float()
        m = x.shape[0]
        if m < ROUTER_CHUNK:
            x = torch.cat([x, x.new_zeros((ROUTER_CHUNK - m, x.shape[1]))])
        out[s:s + m] = (x @ w)[:m]
    return out


def top_k(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of each row and their indices, ties to the lower
    index (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _expert_ffn(xd, wg, wu, wd):
    """``(e, c, D)`` rows through their experts' SwiGLU, in ``xd``'s dtype."""
    dt = xd.dtype
    h = F.silu(torch.bmm(xd, wg.to(dt))) * torch.bmm(xd, wu.to(dt))
    return torch.bmm(h, wd.to(dt))


def _gate_sum(per_k, gates):
    """``(T, k, D)`` expert outputs weighted by their ``(T, k)`` gates: the
    gates cast to the outputs' dtype (the reference's einsum operands), the
    products summed over k in fp32 in one order whatever the token count
    (elementwise, no GEMM to pick an algorithm by shape), rounded once."""
    g = gates.to(per_k.dtype).float()
    acc = per_k[:, 0].float() * g[:, :1]
    for j in range(1, per_k.shape[1]):
        acc += per_k[:, j].float() * g[:, j:j + 1]
    return acc.to(per_k.dtype)


def _route(x2d, router, k):
    """Each token's top-k experts (flat ``(T*k,)`` int32) and gates."""
    top_vals, top_idx = top_k(router_logits(x2d, router), k)
    return top_idx.reshape(-1).to(torch.int32), torch.softmax(top_vals, dim=-1)


def _moe_ffn(x2d, layer, cfg: TransformerConfig, capacity: int):
    """Expert FFN via the dispatch substrate. x2d: (T, D). Returns the
    output and the rows dropped at ``capacity``."""
    moe = cfg.moe
    T, k = x2d.shape[0], moe.top_k
    flat_e, gates = _route(x2d, layer["router"], k)
    disp = make_dispatch(flat_e, moe.n_experts, capacity)
    # row r of the flattened (T*k) space is token r // k
    xd = x2d[(disp.gather_idx // k).long()]
    xd = xd * disp.slot_valid[..., None].to(xd.dtype)
    y = _expert_ffn(xd, layer["w_gate"], layer["w_up"], layer["w_down"])
    per_k = combine_rows(disp, y).reshape(T, k, -1)
    return _gate_sum(per_k, gates), disp.overflow


def routed_capacities(cfg: TransformerConfig, n_tokens: int, n_shards: int
                      ) -> tuple[int, int]:
    """The routed variant's send capacity a (source, destination) pair and
    its per-expert capacity on the owner (0 with one expert a shard), the
    reference's rules (``_moe_ffn_routed``)."""
    moe = cfg.moe
    e_loc, t_loc = moe.n_experts // n_shards, n_tokens // n_shards
    cap = max(8, -(-t_loc * moe.top_k // n_shards))
    cap = ((int(cap * moe.capacity_factor) + 7) // 8) * 8
    cap2 = ((int(n_shards * cap / e_loc * 1.25) + 7) // 8) * 8 if e_loc > 1 else 0
    return cap, cap2


def _moe_ffn_routed(x2d, layer, cfg: TransformerConfig, capacity: int,
                    mesh: DeviceMesh):
    """Expert FFN routed over the S shards of ``mesh`` (the paper's
    shuffle applied to experts; the reference's ``shard_map`` over its
    ``model`` axis, the S shards playing that axis).

    Tokens split over the shards; each shard routes its (token, expert)
    rows to the shard owning the expert (E / S experts a shard) through a
    capacity-padded counting sort and ``all_to_all``, computes there (a
    second dispatch over its experts when it owns more than one) and
    routes the outputs back through the same slots. Falls back to the
    global variant when the tokens or the experts do not split over the
    shards. Expert weights are read on each shard's device (a copy where
    they live elsewhere). Returns the output, on ``x2d``'s device, and the
    drops summed over the shards.
    """
    moe = cfg.moe
    S = mesh.n_shards
    T, D = x2d.shape
    if T % S or moe.n_experts % S:
        return _moe_ffn(x2d, layer, cfg, capacity)
    e_loc, t_loc, k = moe.n_experts // S, T // S, moe.top_k
    cap, cap2 = routed_capacities(cfg, T, S)
    dt = x2d.dtype

    sends_x, sends_e, lays, gates = [], [], [], []
    for s, dev in enumerate(mesh.devices):
        x_loc = x2d[s * t_loc:(s + 1) * t_loc].to(dev)
        flat_e, g = _route(x_loc, layer["router"].to(dev, dt), k)
        lay = counting_layout(torch.div(flat_e, e_loc, rounding_mode="floor"), S, cap)
        rows = x_loc[torch.arange(t_loc * k, device=dev) // k]
        send_e = scatter_to_slots(lay, flat_e, S, cap, fill=-1)
        used = scatter_to_slots(lay, torch.ones((t_loc * k,), dtype=torch.int8,
                                                device=dev), S, cap)
        sends_x.append(scatter_to_slots(lay, rows, S, cap))
        sends_e.append(torch.where(used > 0, send_e, -1))
        lays.append(lay)
        gates.append(g)
    recv_x = collectives.all_to_all(sends_x, mesh)
    recv_e = collectives.all_to_all(sends_e, mesh)

    ys, drops = [], []
    for m, dev in enumerate(mesh.devices):
        w = [layer[n][m * e_loc:(m + 1) * e_loc].to(dev, dt)
             for n in ("w_gate", "w_up", "w_down")]
        local_e = recv_e[m] - m * e_loc
        valid = (recv_e[m] >= 0) & (local_e >= 0) & (local_e < e_loc)
        xr = recv_x[m]
        if e_loc == 1:
            keep = valid[:, None].to(dt)
            y = _expert_ffn((xr * keep)[None], *w)[0] * keep
            drops2 = torch.zeros((), dtype=torch.int32, device=dev)
        else:
            disp2 = make_dispatch(torch.where(valid, local_e, e_loc), e_loc, cap2)
            y = combine_rows(disp2, _expert_ffn(dispatch_rows(disp2, xr), *w))
            drops2 = disp2.overflow - (~valid).sum().to(torch.int32)
        ys.append(y)
        # the reference's count: this shard's send drops, and its owner-side
        # drops less its empty slots, floored at 0
        drops.append(lays[m].overflow + drops2.clamp_min(0))
    back = collectives.all_to_all(ys, mesh)

    outs = []
    for s, dev in enumerate(mesh.devices):
        lay = lays[s]
        out_rows = back[s][lay.slot_of_row.clamp(0, S * cap - 1)]
        out_rows = out_rows * lay.fits[:, None].to(out_rows.dtype)
        outs.append(_gate_sum(out_rows.reshape(t_loc, k, D), gates[s])
                    .to(x2d.device))
    return torch.cat(outs), collectives.psum(drops, mesh).to(x2d.device)


def _dense_ffn(x, layer):
    h = F.silu(x @ layer["w_gate"].to(x.dtype)) * (x @ layer["w_up"].to(x.dtype))
    return h @ layer["w_down"].to(x.dtype)


def moe_capacity_for(cfg: TransformerConfig, n_tokens: int,
                     capacity_factor: float | None = None) -> int:
    """Rows an expert takes from ``n_tokens`` tokens (0 for a dense
    model): the reference's rule, rounded up to 32 and at most the token
    count."""
    if cfg.moe is None:
        return 0
    cf = capacity_factor or cfg.moe.capacity_factor
    cap = int(math.ceil(n_tokens * cfg.moe.top_k / cfg.moe.n_experts * cf))
    cap = ((max(cap, 32) + 31) // 32) * 32
    return min(n_tokens, cap)


def _layer_body(x, layer, cfg: TransformerConfig, *, q_pos, kv_pos,
                cache_kv=None, cache_pos=None, moe_capacity: int = 0,
                mesh: DeviceMesh | None = None):
    """One transformer block. Returns (x, new_cache_kv, moe_drops, kv).

    ``layer`` holds one layer's weights and its ``"window"`` (an int).
    ``cache_kv`` is written in place at ``cache_pos`` (the reference
    returns an updated copy). ``moe_drops`` is 0 for a dense layer, else
    an int32 tensor; the routed MoE runs over ``mesh`` when it has more
    than one shard and ``cfg.moe_impl == "routed"``."""
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
    if cfg.moe is None:
        ffn, drops = _dense_ffn(h, layer), 0
    else:
        h2d = h.reshape(B * Sq, D)
        if cfg.moe_impl == "routed" and mesh is not None and mesh.n_shards > 1:
            ffn2d, drops = _moe_ffn_routed(h2d, layer, cfg, moe_capacity, mesh)
        else:
            ffn2d, drops = _moe_ffn(h2d, layer, cfg, moe_capacity)
        ffn = ffn2d.reshape(B, Sq, D)
    return x + ffn, new_cache, drops, fresh_kv


REMAT_MODES = ("none", "full", "dots")


def _save_mm(ctx, op, *args, **kwargs):
    """``"dots"``: keep the plain matrix products' outputs, recompute the
    rest."""
    if op is torch.ops.aten.mm.default:
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return torch_checkpoint.create_selective_checkpoint_contexts(_save_mm)


def _remat(fn, mode: str):
    """``fn`` (one layer) under the remat ``mode``, when grad is enabled."""
    if mode not in REMAT_MODES:
        raise ValueError(f"unknown remat {mode!r}; want {REMAT_MODES}")
    if mode == "none":
        return fn

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if mode == "full":
            return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False)
        return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                           context_fn=_dots_context)

    return wrapped


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
            device: str | torch.device | None = "cuda",
            mesh: DeviceMesh | None = None, capacity_factor=None):
    """Scoring forward: tokens (B, S) -> logits (B, S, V) fp32.

    Returns (logits, aux) with aux = {"moe_drops": total dropped rows}
    (0 for a dense model, else an int32 tensor). ``params`` must live on
    ``device``; ``mesh`` carries the routed MoE variant.
    """
    tokens, x = _start(params, cfg, tokens, device)
    B, S = tokens.shape
    pos = torch.arange(S, dtype=torch.int32, device=x.device)
    cap = moe_capacity_for(cfg, B * S, capacity_factor)

    def body(x, layer):
        y, _, d, _ = _layer_body(x, layer, cfg, q_pos=pos, kv_pos=pos,
                                 moe_capacity=cap, mesh=mesh)
        return y, d

    body = _remat(body, cfg.remat)
    drops = 0
    for layer in _layers(params, cfg):
        x, d = body(x, layer)
        drops = drops + d
    return _logits(params, cfg, x), {"moe_drops": drops}


def loss_fn(params, cfg: TransformerConfig, batch, *,
            device: str | torch.device | None = "cuda",
            mesh: DeviceMesh | None = None, capacity_factor=None):
    """Next-token cross entropy of ``batch = {"tokens", "labels"}`` (each
    ``(B, S)``) on the fp32 logits, the reference's ``loss_fn``. Returns
    ``(loss, aux)``: ``aux["loss"]`` the loss, ``aux["moe_drops"]`` the
    rows the MoE layers dropped (an int32 tensor, 0 for a dense model)."""
    logits, aux = forward(params, cfg, batch["tokens"], device=device, mesh=mesh,
                          capacity_factor=capacity_factor)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    logz = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels[..., None])[..., 0]
    loss = (logz - label_logit).mean()
    aux["loss"] = loss
    aux["moe_drops"] = torch.as_tensor(aux["moe_drops"], dtype=torch.int32,
                                       device=logits.device)
    return loss, aux


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int, dtype=None, *,
               device: str | torch.device | None = "cuda"):
    """Stacked (L, B, S, Hkv, hd) KV cache (zeros)."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve(device)
    dtype = dtype or cfg.compute_dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def decode_step(params, cfg: TransformerConfig, tokens, cache, pos: int, *,
                device: str | torch.device | None = "cuda",
                mesh: DeviceMesh | None = None, capacity_factor=None):
    """One decode step. tokens (B, Sq); pos: the current length (an int).

    Returns (logits (B, Sq, V) fp32, cache). The cache is updated in place
    (the reference returns a new one): a step writes only its own Sq rows.
    MoE layers take a capacity factor of 4.0 unless one is given, as the
    reference's do.
    """
    tokens, x = _start(params, cfg, tokens, device)
    S_max = cache["k"].shape[2]
    q_pos = pos + torch.arange(tokens.shape[1], dtype=torch.int32, device=x.device)
    kv_pos = torch.arange(S_max, dtype=torch.int32, device=x.device)
    cap = moe_capacity_for(cfg, tokens.numel(), capacity_factor or 4.0)
    for i, layer in enumerate(_layers(params, cfg)):
        x = _layer_body(x, layer, cfg, q_pos=q_pos, kv_pos=kv_pos,
                        cache_kv=(cache["k"][i], cache["v"][i]), cache_pos=pos,
                        moe_capacity=cap, mesh=mesh)[0]
    return _logits(params, cfg, x), cache


def prefill(params, cfg: TransformerConfig, tokens, max_seq: int, *,
            device: str | torch.device | None = "cuda",
            mesh: DeviceMesh | None = None, capacity_factor=None,
            aux: dict | None = None):
    """Prefill: run the full prompt, materialising the KV cache.

    tokens (B, S); returns (logits (B, S, V) fp32, cache with S_max=max_seq),
    as the reference's does. ``aux``, when given, receives ``"moe_drops"``
    (as ``forward``'s).
    """
    tokens, x = _start(params, cfg, tokens, device)
    B, S = tokens.shape
    pos = torch.arange(S, dtype=torch.int32, device=x.device)
    cap = moe_capacity_for(cfg, B * S, capacity_factor)
    cache = init_cache(cfg, B, max_seq, dtype=x.dtype, device=x.device)
    drops = 0
    for i, layer in enumerate(_layers(params, cfg)):
        x, _, d, (k, v) = _layer_body(x, layer, cfg, q_pos=pos, kv_pos=pos,
                                      moe_capacity=cap, mesh=mesh)
        drops = drops + d
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    if aux is not None:
        aux["moe_drops"] = drops
    return _logits(params, cfg, x), cache
