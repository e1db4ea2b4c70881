"""LM configurations and their cells: the JAX package's
``configs/{gemma3_4b,llama32_3b,internlm2_18b,moonshot_v1_16b,phi35_moe}.py``
(``CONFIG`` and ``SMOKE_CONFIG`` of each, the numbers as the repository
has them, and each one's ``ArchDef``) and ``configs/lm_common.py``
(``lm_model_flops``, the four shapes, ``make_{train,prefill,decode}_cell``,
``lm_cells``, ``lm_smoke``), and the training launcher's map from
``--arch`` to the reduced config it trains (``launch/train.py``).

LM shapes (assigned): train_4k (4096 x 256, train step), prefill_32k
(32768 x 32, prefill), decode_32k (one token, 32768-cache, batch 128),
long_500k (one token, 524288-cache, batch 1 -- hybrid/sub-quadratic archs
only; pure full-attention archs record a documented skip).

On the card a cell is cut along its sequences only, and runs attention
through K6 (``attn_impl="chunked"``, the flash dataflow): the plain
``attn_impl="full"`` would hold (B, H, S, S) fp32 logits, 103 GB a
sequence of llama3.2-3b at 32k. Inference cells hold their weights in the
compute dtype (the reference casts its fp32 weights at every use: the
same bits); train cells keep fp32 master weights and AdamW's fp32 moments.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ArchDef, Cell, register
from repro_torch.data.batches import lm_batch
from repro_torch.device import resolve
from repro_torch.distributed.shardutil import Arg, abstract_opt_state, abstract_params
from repro_torch.models import transformer as tfm
from repro_torch.models.module import init_one, init_params
from repro_torch.models.transformer import MoEConfig, TransformerConfig
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train.step import init_train_state

GEMMA3_4B = TransformerConfig(
    name="gemma3-4b", n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
    head_dim=256, d_ff=10240, vocab_size=262144, window=1024,
    global_every=6,  # 5 local : 1 global
    rope_theta=1_000_000.0, scale_embed=True, qk_norm=True,
)
GEMMA3_4B_SMOKE = TransformerConfig(
    name="gemma3-4b-smoke", n_layers=6, d_model=32, n_heads=4, n_kv_heads=2,
    head_dim=8, d_ff=64, vocab_size=256, window=4, global_every=6,
    scale_embed=True, qk_norm=True, dtype="float32",
)
LLAMA32_3B = TransformerConfig(
    name="llama3.2-3b", n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
    head_dim=128, d_ff=8192, vocab_size=128256, rope_theta=500_000.0,
)
LLAMA32_3B_SMOKE = TransformerConfig(
    name="llama3.2-3b-smoke", n_layers=2, d_model=48, n_heads=6, n_kv_heads=2,
    head_dim=8, d_ff=96, vocab_size=256, dtype="float32",
)
INTERNLM2_18B = TransformerConfig(
    name="internlm2-1.8b", n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    head_dim=128, d_ff=8192, vocab_size=92544, rope_theta=1_000_000.0,
)
INTERNLM2_18B_SMOKE = TransformerConfig(
    name="internlm2-1.8b-smoke", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
    head_dim=8, d_ff=64, vocab_size=256, dtype="float32",
)

# moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16) d_ff=1408 (per
# expert), vocab=163840, MoE 64 experts top-6 [hf:moonshotai/Moonlight-16B-A3B]
MOONSHOT_V1_16B = TransformerConfig(
    name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16,
    n_kv_heads=16, head_dim=128, d_ff=1408, vocab_size=163840,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff=1408, capacity_factor=1.25),
    rope_theta=500_000.0,
)
MOONSHOT_V1_16B_SMOKE = TransformerConfig(
    name="moonshot-smoke", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
    head_dim=8, d_ff=48, vocab_size=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=48, capacity_factor=2.0),
    dtype="float32",
)
# phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=6400 (per
# expert), vocab=32064, MoE 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct]
PHI35_MOE = TransformerConfig(
    name="phi3.5-moe-42b-a6.6b", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, head_dim=128, d_ff=6400, vocab_size=32064,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=6400, capacity_factor=1.25),
    rope_theta=10_000.0,
)
PHI35_MOE_SMOKE = TransformerConfig(
    name="phi35-moe-smoke", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
    head_dim=8, d_ff=64, vocab_size=256,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff=64, capacity_factor=2.0),
    dtype="float32",
)

#: the ``train_4k`` cell's step: seq 4096, batch 256,
#: ``AdamWConfig(weight_decay=0.1)``, no compression
TRAIN_4K = dict(seq=4096, batch=256)
PREFILL_32K = dict(seq=32768, batch=32)
DECODE_32K = dict(seq=32768, batch=128)
LONG_500K = dict(seq=524288, batch=1)
#: the KV cache's logical axes ((L, B, S, Hkv, hd), the reference's)
CACHE_AXES = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")

#: ``--arch`` -> the reduced config the training launcher trains
SMOKE_BY_ARCH = {
    "llama3.2-3b": LLAMA32_3B_SMOKE,
    "gemma3-4b": GEMMA3_4B_SMOKE,
    "internlm2-1.8b": INTERNLM2_18B_SMOKE,
    "moonshot-v1-16b-a3b": MOONSHOT_V1_16B_SMOKE,
    "phi3.5-moe-42b-a6.6b": PHI35_MOE_SMOKE,
}


def _attn_eff_context(cfg: TransformerConfig, seq: int, *, decode: bool):
    """Per-layer average attended context length (window-aware)."""
    wins = []
    for i in range(cfg.n_layers):
        is_global = cfg.window <= 0 or (
            cfg.global_every > 0 and (i + 1) % cfg.global_every == 0
        )
        w = seq if is_global else min(cfg.window, seq)
        if not decode and w == seq:
            w = seq / 2  # causal averaging over query positions
        wins.append(w)
    return wins


def lm_model_flops(cfg: TransformerConfig, batch: int, seq: int, mode: str):
    """Useful-FLOPs bookkeeping: 6ND (train) / 2ND (inference) + lm-head +
    window-aware attention term. N excludes the embedding table (its only
    compute is the tied lm-head matmul, counted separately) and, for MoE,
    the experts a token is not routed to."""
    V, D = cfg.vocab_size, cfg.d_model
    n_active = cfg.active_param_count() - V * D
    if mode == "decode":
        toks = batch
        ctx = _attn_eff_context(cfg, seq, decode=True)
        attn = sum(4.0 * toks * w * cfg.q_dim for w in ctx)
        return 2.0 * toks * (n_active + D * V) + attn
    toks = batch * seq
    ctx = _attn_eff_context(cfg, seq, decode=False)
    attn = sum(4.0 * toks * w * cfg.q_dim for w in ctx)
    fwd = 2.0 * toks * (n_active + D * V) + attn
    return 3.0 * fwd if mode == "train" else fwd


# ---------------------------------------------------------------------------
# cells (the reference's configs/lm_common.py)
# ---------------------------------------------------------------------------


def _batch_args(batch: int, seq: int) -> dict:
    tok = Arg((batch, seq), torch.int32, ("batch", None))
    return {"tokens": tok, "labels": tok}


def _ffn_width(cfg: TransformerConfig) -> float:
    """A token's FFN width: ``d_ff``, or for MoE its top-k experts' at the
    capacity factor (the dispatch buffers' rows)."""
    if cfg.moe is None:
        return cfg.d_ff
    return cfg.moe.top_k * cfg.moe.d_ff * cfg.moe.capacity_factor


def _layer_bytes(cfg: TransformerConfig, tokens: int) -> float:
    """One layer's transient tensors on ``tokens`` tokens, counted in fp32:
    the norms and rope upcast their operands, the projections' and the
    FFN's outputs."""
    D, F = cfg.d_model, _ffn_width(cfg)
    return tokens * (4 * D + 4 * cfg.q_dim + 4 * cfg.kv_dim + 3 * F) * 4.0


def _head_bytes(cfg: TransformerConfig, tokens: int, *, train: bool) -> float:
    """The LM head: fp32 logits ``B x S x V x 4`` (kept with the
    log-softmax's gradient of the same size under training), and the fp32
    copy of the embedding its product upcasts (``transformer._logits``)."""
    V, D = cfg.vocab_size, cfg.d_model
    return tokens * V * 4.0 * (3 if train else 1) + V * D * 4.0


def lm_work_bytes(cfg: TransformerConfig, kind: str, batch: int, seq: int) -> float:
    """The step's bytes on the card beyond its arguments (the cell's
    activation estimate).

    train: the fp32 gradients (4 bytes a parameter), AdamW's slice
    temporaries (2 GiB), the activations remat ``"dots"`` keeps (each
    layer's projection and FFN outputs in bf16), one layer recomputed in
    fp32, and the head. prefill: the KV cache it returns, one layer's
    transients and the head. decode: one layer's keys upcast to fp32 by
    ``attend`` and its (B, H, S) fp32 logits, and the head.
    """
    L, D = cfg.n_layers, cfg.d_model
    if kind == "train":
        tokens = batch * seq
        kept = tokens * L * (2 * cfg.q_dim + 2 * cfg.kv_dim + 3 * D
                             + 2 * _ffn_width(cfg)) * 2.0
        return (cfg.param_count() * 4.0 + 2 * 2**30 + kept
                + _layer_bytes(cfg, tokens) + _head_bytes(cfg, tokens, train=True))
    if kind == "prefill":
        tokens = batch * seq
        cache = L * tokens * cfg.kv_dim * 2 * cfg.compute_dtype.itemsize
        return cache + _layer_bytes(cfg, tokens) + _head_bytes(cfg, tokens, train=False)
    attend = batch * seq * (cfg.kv_dim * 4.0 + cfg.n_heads * 4.0 * 3)
    return attend + _layer_bytes(cfg, batch) + _head_bytes(cfg, batch, train=False)


def card_config(cfg: TransformerConfig, dev: torch.device) -> TransformerConfig:
    """``cfg`` as a card build runs it: attention through K6 (the flash
    dataflow computes the same function as ``"full"``)."""
    if dev.type == "cuda" and cfg.attn_impl == "full":
        return dataclasses.replace(cfg, attn_impl="chunked")
    return cfg


def _generator(dev: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def _tokens(batch: int, seq: int, vocab: int, g: torch.Generator) -> dict:
    """Uniform token ids on the generator's device, with next-token labels."""
    toks = torch.randint(0, vocab, (batch, seq + 1), generator=g, device=g.device,
                         dtype=torch.int32)
    return {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}


def layered_params(cfg: TransformerConfig, seed: int, device,
                   n_layers: int | None = None) -> dict:
    """Weights of ``cfg``'s first ``n_layers`` layers (all when None) in its
    compute dtype, drawn on ``device`` from ``seed``: each layer of each
    stacked weight from a generator of its own, so a shallower model holds
    a deeper one's first layers, and the fp32 draw takes one layer's room at
    a time (moonshot's stacked expert weights are 35 GB in fp32)."""
    dev = resolve(device)
    specs, dt = cfg.param_specs(), cfg.compute_dtype
    n_layers = cfg.n_layers if n_layers is None else n_layers

    def gen(j, i):
        return torch.Generator(device=dev).manual_seed(seed * 1_000_003 + j * 1009 + i)

    out = {"embed": init_one(specs["embed"], gen(0, 0), dev, dt),
           "final_norm": init_one(specs["final_norm"], gen(1, 0), dev, dt),
           "layers": {}}
    for j, (name, spec) in enumerate(sorted(specs["layers"].items())):
        one = dataclasses.replace(spec, shape=spec.shape[1:], axes=spec.axes[1:])
        t = torch.empty((n_layers,) + tuple(spec.shape[1:]), dtype=dt, device=dev)
        for i in range(n_layers):
            t[i] = init_one(one, gen(j + 2, i), dev, dt)
        out["layers"][name] = t
    return out


def _params_args(cfg: TransformerConfig, on_card: bool, train: bool):
    """fp32 weights (the reference's, and a train cell's master weights on
    the card), or the compute dtype an inference cell holds on the card."""
    dtype = None if train or not on_card else cfg.compute_dtype
    return abstract_params(cfg.param_specs(), dtype)


def make_train_cell(name: str, cfg: TransformerConfig, *, seq: int, batch: int,
                    shape_name: str = "train_4k", microbatches: int = 1) -> Cell:
    def args_fn(b, layout, on_card):
        p = _params_args(cfg, on_card, train=True)
        return (p, abstract_opt_state(p), _batch_args(b, seq))

    def build_fn(dev, b, seed):
        run = card_config(cfg, dev)
        params = init_params(cfg.param_specs(), _generator(dev, seed), device=dev)
        opt = init_train_state(params)
        # a cut batch below the microbatch count splits into as many as it can
        step = make_train_step(lambda p, bb: tfm.loss_fn(p, run, bb, device=dev),
                               AdamWConfig(weight_decay=0.1),
                               microbatches=math.gcd(microbatches, b))
        return step, (params, opt, _tokens(b, seq, cfg.vocab_size,
                                           _generator(dev, seed + 1)))

    return Cell(
        arch=name, shape=shape_name, kind="train", args_fn=args_fn,
        flops_fn=lambda b: lm_model_flops(cfg, b, seq, "train"),
        work_fn=lambda b: (lm_work_bytes(cfg, "train", max(1, b // microbatches), seq)
                           + (cfg.param_count() * 4.0 if microbatches > 1 else 0.0)),
        build_fn=build_fn, batch=("sequences", batch), donate=(0, 1), config=cfg,
        compute_dtype=cfg.compute_dtype)


def make_prefill_cell(name: str, cfg: TransformerConfig, *, seq: int, batch: int,
                      shape_name: str = "prefill_32k") -> Cell:
    def args_fn(b, layout, on_card):
        return (_params_args(cfg, on_card, train=False),
                Arg((b, seq), torch.int32, ("batch", None)))

    def build_fn(dev, b, seed):
        run = card_config(cfg, dev)
        params = layered_params(cfg, seed, dev)
        tokens = _tokens(b, seq, cfg.vocab_size, _generator(dev, seed + 1))["tokens"]

        @torch.no_grad()
        def fn(params, tokens):
            return tfm.prefill(params, run, tokens, seq, device=dev)

        return fn, (params, tokens)

    return Cell(
        arch=name, shape=shape_name, kind="prefill", args_fn=args_fn,
        flops_fn=lambda b: lm_model_flops(cfg, b, seq, "prefill"),
        work_fn=lambda b: lm_work_bytes(cfg, "prefill", b, seq),
        build_fn=build_fn, batch=("sequences", batch), config=cfg,
        compute_dtype=cfg.compute_dtype)


def make_decode_cell(name: str, cfg: TransformerConfig, *, seq: int, batch: int,
                     shape_name: str, skip: str | None = None) -> Cell:
    """One decode step at position ``seq - 1`` of a full ``seq`` cache (every
    cached key attended, as ``model_flops`` counts)."""
    def args_fn(b, layout, on_card):
        cache = Arg((cfg.n_layers, b, seq, cfg.n_kv_heads, cfg.head_dim),
                    cfg.compute_dtype, CACHE_AXES)
        return (_params_args(cfg, on_card, train=False),
                Arg((b, 1), torch.int32, ("batch", None)),
                {"k": cache, "v": cache}, Arg((), torch.int32, ()))

    def build_fn(dev, b, seed):
        params = layered_params(cfg, seed, dev)
        g = _generator(dev, seed + 1)
        tokens = _tokens(b, 1, cfg.vocab_size, g)["tokens"]
        cache = tfm.init_cache(cfg, b, seq, device=dev)
        for t in (cache["k"], cache["v"]):
            for layer in t:  # a layer at a time: no fp32 temporary of the whole
                layer.normal_(generator=g)

        @torch.no_grad()
        def fn(params, tokens, cache, pos):
            return tfm.decode_step(params, cfg, tokens, cache, pos, device=dev)

        return fn, (params, tokens, cache, seq - 1)

    return Cell(
        arch=name, shape=shape_name, kind="decode", args_fn=args_fn,
        flops_fn=lambda b: lm_model_flops(cfg, b, seq, "decode"),
        work_fn=lambda b: lm_work_bytes(cfg, "decode", b, seq),
        build_fn=build_fn, batch=("sequences", batch), donate=(2,), skip=skip,
        config=cfg, compute_dtype=cfg.compute_dtype)


def lm_cells(name: str, cfg: TransformerConfig, *, long_ok: bool) -> dict:
    skip = (
        None
        if long_ok
        else "pure full-attention arch: 512k-context decode skipped per shape "
        "spec (sub-quadratic/hybrid archs only); see DESIGN.md §5"
    )
    return {
        "train_4k": lambda: make_train_cell(name, cfg, **TRAIN_4K),
        "prefill_32k": lambda: make_prefill_cell(name, cfg, **PREFILL_32K),
        "decode_32k": lambda: make_decode_cell(name, cfg, shape_name="decode_32k",
                                               **DECODE_32K),
        "long_500k": lambda: make_decode_cell(name, cfg, shape_name="long_500k",
                                              skip=skip, **LONG_500K),
    }


def lm_smoke(cfg: TransformerConfig, *, batch: int = 2, seq: int = 16,
             device: str | torch.device | None = "cuda") -> dict:
    """Reduced-config end-to-end on ``device`` (the card unless the caller
    passes ``"cpu"``): one train step, a prefill, a decode step.

    Raises:
      AssertionError: a loss or logits not finite, or of the wrong shape.
    """
    dev = resolve(device)
    params = init_params(cfg.param_specs(), _generator(dev, 0), device=dev)
    opt = init_train_state(params)
    step = make_train_step(lambda p, b: tfm.loss_fn(p, cfg, b, device=dev),
                           AdamWConfig())
    b = lm_batch(batch, seq, cfg.vocab_size, seed=1)
    params, opt, metrics = step(params, opt, b)
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"{cfg.name}: train loss {loss}")
    with torch.no_grad():
        logits, cache = tfm.prefill(params, cfg, b["tokens"], seq + 4, device=dev)
        if (tuple(logits.shape) != (batch, seq, cfg.vocab_size)
                or not bool(torch.isfinite(logits).all())):
            raise AssertionError(f"{cfg.name}: prefill logits {tuple(logits.shape)}")
        nxt = logits[:, -1:].argmax(-1).to(torch.int32)
        dl, _ = tfm.decode_step(params, cfg, nxt, cache, seq, device=dev)
    if tuple(dl.shape) != (batch, 1, cfg.vocab_size) or not bool(torch.isfinite(dl).all()):
        raise AssertionError(f"{cfg.name}: decode logits {tuple(dl.shape)}")
    return {"loss": loss, "params": cfg.param_count()}


# the reference's registration order (configs/__init__.py); gemma3-4b, the
# hybrid 5 local : 1 global arch, is the one that runs long_500k
for _cfg, _smoke in ((LLAMA32_3B, LLAMA32_3B_SMOKE), (GEMMA3_4B, GEMMA3_4B_SMOKE),
                     (INTERNLM2_18B, INTERNLM2_18B_SMOKE),
                     (MOONSHOT_V1_16B, MOONSHOT_V1_16B_SMOKE), (PHI35_MOE, PHI35_MOE_SMOKE)):
    register(ArchDef(
        name=_cfg.name, family="lm", config=_cfg,
        cells=lm_cells(_cfg.name, _cfg, long_ok=_cfg is GEMMA3_4B),
        smoke=lambda device="cuda", cfg=_smoke: lm_smoke(cfg, device=device)))

#: ``--arch`` -> the full config (``configs/variants.py``)
CONFIG_BY_ARCH = {cfg.name: cfg for cfg in (LLAMA32_3B, GEMMA3_4B, INTERNLM2_18B,
                                             MOONSHOT_V1_16B, PHI35_MOE)}
