"""LM configurations, copied from the JAX package's
``configs/{gemma3_4b,llama32_3b,internlm2_18b,moonshot_v1_16b,phi35_moe}.py``
(``CONFIG`` and ``SMOKE_CONFIG`` of each, the numbers as the repository
has them), ``lm_model_flops`` and the ``train_4k`` step's shape
(``TRAIN_4K``) from ``configs/lm_common.py``, and the training launcher's
map from ``--arch`` to the reduced config it trains
(``launch/train.py``). The reference's ``ArchDef`` registry and cells are
not copied: they import jax.
"""

from __future__ import annotations

from repro_torch.models.transformer import MoEConfig, TransformerConfig

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

#: the ``train_4k`` cell's step (``configs/lm_common.py``): seq 4096, batch
#: 256, ``AdamWConfig(weight_decay=0.1)``, no compression
TRAIN_4K = dict(seq=4096, batch=256)

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
