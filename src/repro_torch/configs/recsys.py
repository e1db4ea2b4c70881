"""Recsys configurations, copied from the JAX package's
``configs/{recsys_common,dlrm_rm2,din,dien,two_tower}.py``: the four full
configurations (``CONFIG`` of each, the numbers as the repository has
them), the assigned shapes' batch sizes, the per-sample FLOP counts and
the smoke entry points, which run one train step and one forward at a
reduced size on ``device`` (the card unless the caller passes
``device="cpu"``), and the sixteen cells with their ``ArchDef``s
(``configs/recsys_common.py``'s ``standard_recsys_cells``; two-tower's
own). On the card a cell is cut along its samples only; its batch is
drawn there from the seed, in the numpy generators' distributions
(``data/batches.py``).

Shapes (assigned): train_batch (B = 65,536, train), serve_p99 (B = 512,
online inference), serve_bulk (B = 262,144, offline scoring),
retrieval_cand (one query scored against 1M candidates).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ArchDef, Cell, register
from repro_torch.data.batches import din_batch, dlrm_batch, twotower_batch
from repro_torch.device import resolve
from repro_torch.distributed.shardutil import Arg, abstract_opt_state, abstract_params
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


# ---------------------------------------------------------------------------
# cells (the reference's configs/recsys_common.py and the four configs)
# ---------------------------------------------------------------------------


def zipf_ids(a: float, vocab: int, shape, g: torch.Generator) -> torch.Tensor:
    """``min(zipf(a), vocab - 1)`` int32 ids drawn on the generator's device
    by the inverse CDF: the distribution ``data/batches.py`` draws, not its
    numbers. The tail past ``vocab - 2`` lands on ``vocab - 1``; zeta(a)
    from Euler-Maclaurin at ``vocab - 1``."""
    dev = g.device
    k = torch.arange(1, vocab - 1, dtype=torch.float64, device=dev)
    w = k ** -a
    n = float(vocab - 1)
    zeta = (float(w.sum()) + n ** (1 - a) / (a - 1) + 0.5 * n ** -a
            + a * n ** (-a - 1) / 12)
    cdf = torch.cumsum(w, 0) / zeta
    del k, w
    u = torch.rand(math.prod(shape), generator=g, dtype=torch.float64, device=dev)
    ids = torch.searchsorted(cdf, u, right=True) + 1
    return ids.clamp_(max=vocab - 1).reshape(shape).int()


def dlrm_batch_on(cfg: recsys.DLRMConfig, b: int, g: torch.Generator) -> dict:
    """``dlrm_batch``'s distributions on the card (its planted label)."""
    dense = torch.randn((b, cfg.n_dense), generator=g, device=g.device)
    sparse = zipf_ids(1.2, cfg.vocab_per_field, (b, cfg.n_sparse), g)
    logit = dense[:, 0] + 0.5 * ((sparse[:, 0] % 2) * 2 - 1)
    noise = torch.randn((b,), generator=g, device=g.device)
    return {"dense": dense, "sparse": sparse, "label": (logit + noise > 0).float()}


def din_batch_on(cfg: recsys.DINConfig, b: int, g: torch.Generator) -> dict:
    """``din_batch``'s distributions on the card: half positives, whose
    target comes from the history."""
    dev = g.device
    hist = zipf_ids(1.3, cfg.vocab, (b, cfg.seq_len), g)
    pos = hist[torch.arange(b, device=dev),
               torch.randint(0, cfg.seq_len, (b,), generator=g, device=dev)]
    neg = zipf_ids(1.3, cfg.vocab, (b,), g)
    label = (torch.rand((b,), generator=g, device=dev) < 0.5).float()
    target = torch.where(label > 0, pos, neg).clamp(min=1)
    return {"hist": hist, "target": target, "label": label}


def twotower_batch_on(cfg: recsys.TwoTowerConfig, b: int, g: torch.Generator) -> dict:
    """``twotower_batch``'s distribution on the card: uniform ids, the
    positive item's first field tied to the user's first."""
    dev, v = g.device, cfg.vocab_per_field
    user = torch.randint(0, v, (b, cfg.n_user_fields), generator=g, device=dev,
                         dtype=torch.int32)
    item = torch.randint(0, v, (b, cfg.n_item_fields), generator=g, device=dev,
                         dtype=torch.int32)
    item[:, 0] = ((user[:, 0].long() * 7919 + 13) % v).int()
    return {"user_ids": user, "item_ids": item}


def _args(**leaves) -> dict:
    """Batch leaves ``name=(shape, dtype)``, each leading dim on the batch
    axes (the reference's ``batch_tree_shardings``)."""
    return {k: Arg(shape, dt, ("batch",) + (None,) * (len(shape) - 1))
            for k, (shape, dt) in leaves.items()}


def _dlrm_args(b: int, serve: bool) -> dict:
    c = DLRM_RM2
    out = _args(dense=((b, c.n_dense), torch.float32),
                sparse=((b, c.n_sparse), torch.int32), label=((b,), torch.float32))
    if serve:
        del out["label"]
    return out


def _din_args(cfg):
    def fn(b: int, serve: bool) -> dict:
        out = _args(hist=((b, cfg.seq_len), torch.int32), target=((b,), torch.int32),
                    label=((b,), torch.float32))
        if serve:
            del out["label"]
        return out
    return fn


def _tt_args(b: int, serve: bool) -> dict:
    c = TWO_TOWER
    return _args(user_ids=((b, c.n_user_fields), torch.int32),
                 item_ids=((b, c.n_item_fields), torch.int32))


def _tt_retrieval_args(n: int, serve: bool) -> dict:
    c = TWO_TOWER
    return _args(user_ids=((1, c.n_user_fields), torch.int32),
                 cand_ids=((n, c.n_item_fields), torch.int32))


def sample_floats(cfg) -> float:
    """fp32 values a sample's forward holds at once (its activation
    estimate): the gathered embeddings and every layer's input and output."""
    if isinstance(cfg, recsys.DLRMConfig):
        n_vec = cfg.n_sparse + 1
        return (cfg.n_sparse * cfg.embed_dim + cfg.n_dense + sum(cfg.bot_mlp)
                + n_vec * cfg.embed_dim + n_vec * n_vec
                + cfg.bot_mlp[-1] + n_vec * (n_vec - 1) / 2 + sum(cfg.top_mlp))
    if isinstance(cfg, recsys.DINConfig):
        # the attention MLP's input width as the FLOP counts take it: DIN's
        # [hist, target, hist - target, hist * target], DIEN's GRU state and target
        T, D, H = cfg.seq_len, cfg.embed_dim, cfg.gru_dim
        att_in = H + D if H else 4 * D
        att = T * (att_in + sum(cfg.attn_mlp) + 1)
        return T * D + att + T * 2 * H + 3 * (H + D) + sum(cfg.mlp)
    return 2 * (cfg.n_user_fields * cfg.field_dim + sum(cfg.tower_mlp))


def recsys_work_bytes(cfg, kind: str, b: int) -> float:
    """A step's bytes beyond its arguments: each sample's forward values
    (twice over, for the products' temporaries); a train step keeps them
    for the backward and holds their gradients (twice that), adds the fp32
    gradients (4 bytes a parameter) and AdamW's slice temporaries (2 GiB),
    and two-tower's in-batch softmax five (B, B) fp32 tensors (logits,
    their softmax, its gradient and the loss's temporaries)."""
    per = sample_floats(cfg) * 4.0 * 2
    if kind != "train":
        return b * per
    extra = 5.0 * b * b * 4 if isinstance(cfg, recsys.TwoTowerConfig) else 0.0
    return 2 * b * per + cfg.param_count() * 4.0 + 2 * 2**30 + extra


_BATCH_ON = {"dlrm-rm2": dlrm_batch_on, "din": din_batch_on, "dien": din_batch_on,
             "two-tower-retrieval": twotower_batch_on}


def _batch_on(arch: str, cfg, b: int, g, serve: bool, retrieval: bool) -> dict:
    if retrieval and arch == "two-tower-retrieval":
        items = twotower_batch_on(cfg, b, g)
        return {"user_ids": items["user_ids"][:1], "cand_ids": items["item_ids"]}
    batch = _BATCH_ON[arch](cfg, b, g)
    if serve:
        batch.pop("label", None)
    return batch


def make_recsys_train_cell(arch: str, cfg, loss_fn, batch_args, flops_fn, *,
                           batch: int = TRAIN_B, shape_name: str = "train_batch",
                           step_flops_fn=None) -> Cell:
    """``flops_fn(b)``: the cell's model FLOPs at ``b`` samples;
    ``step_flops_fn(b)`` a step's, where they differ."""
    def args_fn(b, layout, on_card):
        p = abstract_params(cfg.param_specs())
        return (p, abstract_opt_state(p), batch_args(b, False))

    def build_fn(dev, b, seed):
        params = init_params(cfg.param_specs(), torch.Generator(device=dev).manual_seed(seed),
                             device=dev)
        step = make_train_step(lambda p, bb: loss_fn(p, cfg, bb, device=dev),
                               AdamWConfig())
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        return step, (params, init_train_state(params),
                      _batch_on(arch, cfg, b, g, False, False))

    return Cell(arch=arch, shape=shape_name, kind="train", args_fn=args_fn,
                flops_fn=flops_fn, work_fn=lambda b: recsys_work_bytes(cfg, "train", b),
                build_fn=build_fn, batch=("samples", batch), donate=(0, 1), config=cfg,
                step_flops_fn=step_flops_fn)


def make_recsys_serve_cell(arch: str, cfg, forward, batch_args, flops_per_sample: float,
                           *, batch: int, shape_name: str) -> Cell:
    retrieval = shape_name == "retrieval_cand"

    def args_fn(b, layout, on_card):
        return (abstract_params(cfg.param_specs()), batch_args(b, True))

    def build_fn(dev, b, seed):
        params = init_params(cfg.param_specs(), torch.Generator(device=dev).manual_seed(seed),
                             device=dev)
        g = torch.Generator(device=dev).manual_seed(seed + 1)

        @torch.no_grad()
        def fn(params, bb):
            return forward(params, cfg, bb, device=dev)

        return fn, (params, _batch_on(arch, cfg, b, g, True, retrieval))

    return Cell(arch=arch, shape=shape_name, kind="serve", args_fn=args_fn,
                flops_fn=lambda b: flops_per_sample * b,
                work_fn=lambda b: recsys_work_bytes(cfg, "serve", b),
                build_fn=build_fn, batch=("candidates" if retrieval else "samples", batch),
                config=cfg)


def standard_recsys_cells(arch, cfg, loss_fn, forward, batch_args,
                          flops_per_sample) -> dict:
    """train_batch / serve_p99 / serve_bulk / retrieval_cand."""
    return {
        "train_batch": lambda: make_recsys_train_cell(
            arch, cfg, loss_fn, batch_args, lambda b: 3.0 * flops_per_sample * b),
        "serve_p99": lambda: make_recsys_serve_cell(
            arch, cfg, forward, batch_args, flops_per_sample, batch=P99_B,
            shape_name="serve_p99"),
        "serve_bulk": lambda: make_recsys_serve_cell(
            arch, cfg, forward, batch_args, flops_per_sample, batch=BULK_B,
            shape_name="serve_bulk"),
        "retrieval_cand": lambda: make_recsys_serve_cell(
            arch, cfg, forward, batch_args, flops_per_sample, batch=CAND_N,
            shape_name="retrieval_cand"),
    }


def _twotower_cells() -> dict:
    a, c = "two-tower-retrieval", TWO_TOWER
    return {
        # train FLOPs include the B x B in-batch softmax logits product.
        # The reference's model FLOPs count the step's factor of 3 twice
        # (``twotower_train_flops`` holds it already); mfu reads the step's
        "train_batch": lambda: make_recsys_train_cell(
            a, c, recsys.twotower_loss, _tt_args,
            lambda b: 3.0 * twotower_train_flops(b) * b,
            step_flops_fn=lambda b: twotower_train_flops(b) * b),
        "serve_p99": lambda: make_recsys_serve_cell(
            a, c, recsys.pair_score, _tt_args, TWOTOWER_SERVE_FLOPS, batch=P99_B,
            shape_name="serve_p99"),
        "serve_bulk": lambda: make_recsys_serve_cell(
            a, c, recsys.pair_score, _tt_args, TWOTOWER_SERVE_FLOPS, batch=BULK_B,
            shape_name="serve_bulk"),
        "retrieval_cand": lambda: make_recsys_serve_cell(
            a, c, recsys.twotower_score, _tt_retrieval_args,
            TWOTOWER_RETRIEVAL_FLOPS,  # item tower + dot per candidate
            batch=CAND_N, shape_name="retrieval_cand"),
    }


register(ArchDef(
    name="dlrm-rm2", family="recsys", config=DLRM_RM2,
    cells=standard_recsys_cells("dlrm-rm2", DLRM_RM2, recsys.dlrm_loss,
                                recsys.dlrm_forward, _dlrm_args, DLRM_FLOPS_PER_SAMPLE),
    smoke=dlrm_smoke))
register(ArchDef(
    name="din", family="recsys", config=DIN,
    cells=standard_recsys_cells("din", DIN, recsys.din_loss, recsys.din_forward,
                                _din_args(DIN), din_flops_per_sample(DIN)),
    smoke=lambda device="cuda": din_smoke(0, device=device)))
register(ArchDef(
    name="dien", family="recsys", config=DIEN,
    cells=standard_recsys_cells("dien", DIEN, recsys.din_loss, recsys.din_forward,
                                _din_args(DIEN), dien_flops_per_sample(DIEN)),
    smoke=lambda device="cuda": din_smoke(16, device=device)))
register(ArchDef(
    name="two-tower-retrieval", family="recsys", config=TWO_TOWER,
    cells=_twotower_cells(), smoke=twotower_smoke))
