"""Recsys configurations, copied from the JAX package's
``configs/{recsys_common,dlrm_rm2,din,dien,two_tower}.py``: the four full
configurations (``CONFIG`` of each, the numbers as the repository has
them), the assigned shapes' batch sizes, the per-sample FLOP counts and
the smoke entry points, which run one train step and one forward at a
reduced size on ``device`` (the card unless the caller passes
``device="cpu"``). The reference's ``Cell`` / ``ArchDef`` registry is not
copied: it describes a TPU mesh.

Shapes (assigned): train_batch (B = 65,536, train), serve_p99 (B = 512,
online inference), serve_bulk (B = 262,144, offline scoring),
retrieval_cand (one query scored against 1M candidates).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.data.batches import din_batch, dlrm_batch, twotower_batch
from repro_torch.device import resolve
from repro_torch.models import recsys
from repro_torch.models.module import init_params
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train.step import init_train_state

TRAIN_B = 65536
P99_B = 512
BULK_B = 262144
CAND_N = 1_000_000


def mlp_flops(dims) -> float:
    return 2.0 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


# dlrm-rm2 [recsys] n_dense=13 n_sparse=26 embed_dim=64
# bot_mlp=13-512-256-64 top_mlp=512-512-256-1 interaction=dot
# [arXiv:1906.00091; paper]. Tables: 26 x 1M rows x 64.
DLRM_RM2 = recsys.DLRMConfig(
    name="dlrm-rm2",
    n_dense=13,
    n_sparse=26,
    embed_dim=64,
    vocab_per_field=1_000_000,
    bot_mlp=(512, 256, 64),
    top_mlp=(512, 512, 256, 1),
)
_N_PAIRS = (DLRM_RM2.n_sparse + 1) * DLRM_RM2.n_sparse // 2
DLRM_FLOPS_PER_SAMPLE = (
    mlp_flops((DLRM_RM2.n_dense, *DLRM_RM2.bot_mlp))
    + 2.0 * (DLRM_RM2.n_sparse + 1) ** 2 * DLRM_RM2.embed_dim  # dot interaction
    + mlp_flops((DLRM_RM2.bot_mlp[-1] + _N_PAIRS, *DLRM_RM2.top_mlp))
)

# din [recsys] embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80
# interaction=target-attn [arXiv:1706.06978; paper]. Item table 10M x 18.
DIN = recsys.DINConfig(
    name="din",
    embed_dim=18,
    seq_len=100,
    vocab=10_000_000,
    attn_mlp=(80, 40),
    mlp=(200, 80),
)

# dien [recsys] embed_dim=18 seq_len=100 gru_dim=108 mlp=200-80
# interaction=augru [arXiv:1809.03672; unverified]. DIN + GRU interest
# extraction + AUGRU interest evolution.
DIEN = recsys.DINConfig(
    name="dien",
    embed_dim=18,
    seq_len=100,
    vocab=10_000_000,
    attn_mlp=(80, 40),
    mlp=(200, 80),
    gru_dim=108,
)


def din_flops_per_sample(cfg: recsys.DINConfig) -> float:
    D, T = cfg.embed_dim, cfg.seq_len
    att = T * mlp_flops((4 * D, *cfg.attn_mlp, 1))
    pool = 2.0 * T * D
    fin = mlp_flops((3 * D, *cfg.mlp, 1))
    return att + pool + fin


def dien_flops_per_sample(cfg: recsys.DINConfig) -> float:
    D, T, H = cfg.embed_dim, cfg.seq_len, cfg.gru_dim
    gru = 2.0 * T * (3 * (D * H + H * H))
    augru = 2.0 * T * (3 * (H * H + H * H))
    att = T * mlp_flops((H + D, *cfg.attn_mlp, 1))
    fin = mlp_flops((H + D, *cfg.mlp, 1))
    return gru + augru + att + fin


# two-tower-retrieval [recsys] embed_dim=256 tower_mlp=1024-512-256
# interaction=dot, sampled-softmax retrieval [RecSys'19 (YouTube);
# unverified]. retrieval_cand scores one user against 1M candidates: the
# batch k-NN problem, dense or through the vocabulary-tree index.
TWO_TOWER = recsys.TwoTowerConfig(
    name="two-tower-retrieval",
    embed_dim=256,
    field_dim=64,
    n_user_fields=4,
    n_item_fields=4,
    vocab_per_field=1_000_000,
    tower_mlp=(1024, 512, 256),
)
TOWER_FLOPS = mlp_flops((TWO_TOWER.n_user_fields * TWO_TOWER.field_dim,
                         *TWO_TOWER.tower_mlp))


def twotower_train_flops(b: int) -> float:
    """A train step's FLOPs a sample, the (B, B) in-batch logits included."""
    return 3.0 * (2 * TOWER_FLOPS + 2.0 * b * TWO_TOWER.embed_dim)


TWOTOWER_SERVE_FLOPS = 2 * TOWER_FLOPS + 2 * TWO_TOWER.embed_dim  # a pair
TWOTOWER_RETRIEVAL_FLOPS = TOWER_FLOPS + 2 * TWO_TOWER.embed_dim  # a candidate


def _smoke_step(loss, cfg, params, batch, dev):
    opt = init_train_state(params)
    step = make_train_step(lambda p, b: loss(p, cfg, b, device=dev), AdamWConfig())
    params, opt, m = step(params, opt, batch)
    if not math.isfinite(float(m["loss"])):
        raise AssertionError(f"{cfg.name}: loss {float(m['loss'])}")
    return params, float(m["loss"])


def _finite(scores, n: int, what: str) -> None:
    if tuple(scores.shape) != (n,) or not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"{what}: scores {tuple(scores.shape)} not finite")


def dlrm_smoke(device: str | torch.device | None = "cuda") -> dict:
    dev = resolve(device)
    cfg = recsys.DLRMConfig(name="dlrm-smoke", vocab_per_field=1000,
                            embed_dim=16, bot_mlp=(32, 16), top_mlp=(32, 16, 1))
    params = init_params(cfg.param_specs(), torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    b = dlrm_batch(64, 13, 26, 1000, seed=1)
    params, loss = _smoke_step(recsys.dlrm_loss, cfg, params, b, dev)
    with torch.no_grad():
        scores = recsys.dlrm_forward(params, cfg, {k: v for k, v in b.items()
                                                   if k != "label"}, device=dev)
    _finite(scores, 64, cfg.name)
    return {"loss": loss, "params": cfg.param_count()}


def din_smoke(gru_dim: int = 0, device: str | torch.device | None = "cuda") -> dict:
    """DIN (``gru_dim`` 0) or DIEN (the reference's DIEN smoke: 16)."""
    dev = resolve(device)
    cfg = recsys.DINConfig(name="din-smoke", vocab=2000, seq_len=20,
                           gru_dim=gru_dim, attn_mlp=(16, 8), mlp=(24, 12))
    params = init_params(cfg.param_specs(), torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    b = din_batch(64, 20, 2000, seed=1)
    params, loss = _smoke_step(recsys.din_loss, cfg, params, b, dev)
    with torch.no_grad():
        scores = recsys.din_forward(params, cfg, {k: v for k, v in b.items()
                                                  if k != "label"}, device=dev)
    _finite(scores, 64, cfg.name)
    return {"loss": loss, "params": cfg.param_count()}


def twotower_smoke(device: str | torch.device | None = "cuda") -> dict:
    dev = resolve(device)
    cfg = recsys.TwoTowerConfig(name="tt-smoke", vocab_per_field=1000,
                                field_dim=16, tower_mlp=(64, 32), embed_dim=32)
    params = init_params(cfg.param_specs(), torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    b = twotower_batch(64, 4, 4, 1000, seed=1)
    params, loss = _smoke_step(recsys.twotower_loss, cfg, params, b, dev)
    cand = np.random.default_rng(2).integers(0, 1000, (256, 4), dtype=np.int32)
    with torch.no_grad():
        scores = recsys.twotower_score(params, cfg, {"user_ids": b["user_ids"][:1],
                                                     "cand_ids": cand}, device=dev)
    _finite(scores, 256, cfg.name)
    return {"loss": loss, "params": cfg.param_count()}
