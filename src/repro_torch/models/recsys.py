"""RecSys family in PyTorch: DLRM (arXiv:1906.00091), DIN
(arXiv:1706.06978), DIEN (arXiv:1809.03672), two-tower retrieval (Yi et
al., RecSys'19) -- the JAX package's ``models/recsys.py``, with its names,
configs and cast points, and ``pair_score`` from its
``configs/two_tower.py``.

The hot path is the sparse embedding lookup. Every gather is
``F.embedding``: its backward on the card sums each row's gradient in a
fixed order (a sort of the ids, or one block a column slice), so a train
step gives the same bits on every run without torch's deterministic mode,
where ``table[ids]``'s backward would add with atomics. ``field_lookup``
is one gather into the ``(F * V, D)`` view of the stacked tables, each
field's ids offset by ``f * V`` (the reference vmaps ``jnp.take`` over the
fields). The tables' gradients are dense, as the reference's are, and
AdamW updates every row.

DLRM's dot interaction takes the fp32 Gram of the 27 vectors and its
upper triangle (``k = 1``, row-major: ``np.triu_indices``' order) as one
slice a row, concatenated: a gather-free form whose backward has no
scatter. DIEN's GRU and AUGRU run as a Python loop over the T steps (the
reference's ``lax.scan``), with the cell's arithmetic as the reference
writes it; under grad the loop keeps only every ``GRU_REMAT``-th step's
state and recomputes the steps between in the backward
(``torch.utils.checkpoint``), which gives the same bits and lets DIEN's
train step hold B = 65,536 on one card.

Entry points take ``params`` on ``device`` (the card unless the caller
passes ``device="cpu"``) and batches as numpy arrays or tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.device import resolve
from repro_torch.models.module import ParamSpec, param_count

GRU_REMAT = 10  # under grad, the GRU loops keep every 10th step's state

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def _on(params, device):
    """The run's device, after checking that the weights live there."""
    dev = resolve(device)
    first = next(iter(params.values()))
    if first.device != dev:
        raise ValueError(f"params on {first.device}, run on {dev}")
    return dev


def _ids(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, device=dev).long()


def _values(x, dev, dtype) -> torch.Tensor:
    return torch.as_tensor(x, device=dev).to(dtype)


# ---------------------------------------------------------------------------
# shared substrate
# ---------------------------------------------------------------------------


def embedding_bag(table, ids, *, mode="sum", valid=None):
    """EmbeddingBag: table (V, D), ids (..., nnz) -> (..., D).

    ``valid`` masks padding ids; mean mode divides by the bag size."""
    ids = torch.as_tensor(ids, device=table.device).long()
    emb = F.embedding(ids, table)  # (..., nnz, D)
    if valid is not None:
        valid = torch.as_tensor(valid, device=table.device)
        emb = emb * valid[..., None].to(emb.dtype)
    out = emb.sum(dim=-2)
    if mode == "mean":
        denom = (valid.sum(dim=-1, keepdim=True) if valid is not None
                 else torch.tensor(ids.shape[-1], device=table.device))
        out = out / torch.clamp(denom, min=1).to(out.dtype)
    return out


def field_lookup(tables, ids):
    """tables (F, V, D), ids (B, F) -> (B, F, D) one-hot-per-field lookup."""
    n_fields, vocab, dim = tables.shape
    ids = torch.as_tensor(ids, device=tables.device).long()
    offs = torch.arange(n_fields, device=tables.device) * vocab
    return F.embedding(ids + offs, tables.reshape(n_fields * vocab, dim))


def mlp_specs(dims: Sequence[int], prefix: str, axes=(None, "ffn")):
    specs = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        specs[f"{prefix}_w{i}"] = ParamSpec((a, b), axes)
        specs[f"{prefix}_b{i}"] = ParamSpec((b,), (None,), init="zeros")
    return specs


def mlp_apply(params, prefix: str, x, n: int, *, final_act=False):
    for i in range(n):
        x = x @ params[f"{prefix}_w{i}"].to(x.dtype) + params[f"{prefix}_b{i}"].to(x.dtype)
        if i + 1 < n or final_act:
            x = torch.relu(x)
    return x


def bce_loss(logit, label):
    """Numerically stable sigmoid BCE. logit (B,), label (B,) in {0,1}."""
    logit = logit.float()
    label = torch.as_tensor(label, device=logit.device).float()
    return (torch.clamp(logit, min=0) - logit * label
            + torch.log1p(torch.exp(-logit.abs()))).mean()


# ---------------------------------------------------------------------------
# DLRM
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    vocab_per_field: int = 1_000_000
    bot_mlp: tuple = (512, 256, 64)
    top_mlp: tuple = (512, 512, 256, 1)
    dtype: str = "float32"

    def __post_init__(self):
        if self.bot_mlp[-1] != self.embed_dim:
            raise ValueError(
                f"DLRM bottom MLP must end at embed_dim "
                f"({self.bot_mlp[-1]} != {self.embed_dim})"
            )

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def param_specs(self):
        specs = {
            "tables": ParamSpec(
                (self.n_sparse, self.vocab_per_field, self.embed_dim),
                (None, "table_rows", "embed"),
                scale=0.01,
            )
        }
        specs.update(mlp_specs((self.n_dense, *self.bot_mlp), "bot"))
        n_pairs = (self.n_sparse + 1) * self.n_sparse // 2
        top_in = self.bot_mlp[-1] + n_pairs
        specs.update(mlp_specs((top_in, *self.top_mlp), "top"))
        return specs

    def param_count(self) -> int:
        return param_count(self.param_specs())


def dot_interaction(z):
    """z (B, F+1, D) -> (B, pairs): the fp32 Gram's upper triangle (k = 1)
    in ``np.triu_indices`` order, in z's dtype."""
    zf = z if z.dtype in (torch.float32, torch.float64) else z.float()
    gram = torch.bmm(zf, zf.transpose(1, 2))
    n = z.shape[1]
    return torch.cat([gram[:, i, i + 1:] for i in range(n - 1)], dim=1).to(z.dtype)


def dlrm_forward(params, cfg: DLRMConfig, batch, *,
                 device: str | torch.device | None = "cuda"):
    """batch: dense (B, 13) float, sparse (B, 26) int -> logits (B,)."""
    dev = _on(params, device)
    dense = _values(batch["dense"], dev, cfg.compute_dtype)
    d0 = mlp_apply(params, "bot", dense, len(cfg.bot_mlp), final_act=True)
    embs = field_lookup(params["tables"].to(cfg.compute_dtype), _ids(batch["sparse"], dev))
    z = torch.cat([d0[:, None, :], embs], dim=1)  # (B, F+1, D)
    x = torch.cat([d0, dot_interaction(z)], dim=1)
    out = mlp_apply(params, "top", x, len(cfg.top_mlp))
    return out[:, 0]


def dlrm_loss(params, cfg: DLRMConfig, batch, *,
              device: str | torch.device | None = "cuda"):
    logit = dlrm_forward(params, cfg, batch, device=device)
    loss = bce_loss(logit, batch["label"])
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# DIN / DIEN
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    embed_dim: int = 18
    seq_len: int = 100
    vocab: int = 500_000
    attn_mlp: tuple = (80, 40)
    mlp: tuple = (200, 80)
    gru_dim: int = 0  # >0 switches on the DIEN interest-evolution path
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def param_specs(self):
        D = self.embed_dim
        specs = {
            "item_table": ParamSpec((self.vocab, D), ("table_rows", "embed"), scale=0.01)
        }
        if self.gru_dim:  # DIEN: GRU + AUGRU over the behaviour sequence
            H = self.gru_dim
            specs["gru_wx"] = ParamSpec((D, 3 * H), (None, "ffn"))
            specs["gru_wh"] = ParamSpec((H, 3 * H), (None, "ffn"))
            specs["gru_b"] = ParamSpec((3 * H,), (None,), init="zeros")
            specs["augru_wx"] = ParamSpec((H, 3 * H), (None, "ffn"))
            specs["augru_wh"] = ParamSpec((H, 3 * H), (None, "ffn"))
            specs["augru_b"] = ParamSpec((3 * H,), (None,), init="zeros")
            att_in = H + D
            final_in = H + D
        else:  # DIN: target attention over raw behaviour embeddings
            att_in = 4 * D
            final_in = 3 * D
        specs.update(mlp_specs((att_in, *self.attn_mlp, 1), "att"))
        specs.update(mlp_specs((final_in, *self.mlp, 1), "fin"))
        return specs

    def param_count(self) -> int:
        return param_count(self.param_specs())


def _gru_cell(h, x, a, wx, wh, b):
    """One GRU step (AUGRU when ``a`` (B,) is given), as the reference's
    ``cell``: the 3H-wide gates, then the candidate recomputed from the
    last H columns of ``wx`` and ``wh``."""
    H = h.shape[-1]
    gates = x @ wx + h @ wh + b
    r = torch.sigmoid(gates[..., :H])
    u = torch.sigmoid(gates[..., H:2 * H])
    cand = torch.tanh(x @ wx[:, 2 * H:] + (r * h) @ wh[:, 2 * H:] + b[2 * H:])
    if a is not None:
        u = u * a[..., None]  # attentional update gate (AUGRU)
    return (1.0 - u) * h + u * cand


def _gru_steps(h, x_seq, a_seq, wx, wh, b, keep: bool):
    """The states after each of ``x_seq``'s steps from ``h``, or (with
    ``keep`` False) the last one alone."""
    outs = []
    for t in range(x_seq.shape[0]):
        h = _gru_cell(h, x_seq[t], None if a_seq is None else a_seq[t], wx, wh, b)
        if keep:
            outs.append(h)
    return tuple(outs) if keep else (h,)


def _gru_scan(x_seq, h0, wx, wh, b, *, a_seq=None, keep_all: bool = True):
    """x_seq (T, B, D) -> h_seq (T, B, H), or the last state (B, H) when
    ``keep_all`` is False. AUGRU when a_seq (T, B) is given. Under grad,
    each ``GRU_REMAT`` steps are one checkpoint; the graph, and so the
    order in which the backward sums each state's gradients, stays the
    plain loop's (the states are stacked once, after the loop)."""
    T = x_seq.shape[0]
    if not torch.is_grad_enabled():
        outs = _gru_steps(h0, x_seq, a_seq, wx, wh, b, keep_all)
    else:
        outs, h = [], h0
        for t0 in range(0, T, GRU_REMAT):
            t1 = min(T, t0 + GRU_REMAT)
            a = None if a_seq is None else a_seq[t0:t1]
            chunk = torch_checkpoint.checkpoint(
                _gru_steps, h, x_seq[t0:t1], a, wx, wh, b, keep_all,
                use_reentrant=False)
            h = chunk[-1]
            if keep_all:
                outs.extend(chunk)
        if not keep_all:
            outs = [h]
    return torch.stack(outs) if keep_all else outs[-1]


def din_forward(params, cfg: DINConfig, batch, *,
                device: str | torch.device | None = "cuda"):
    """batch: hist (B, T) int (0 = pad), target (B,) int -> logits (B,)."""
    dev = _on(params, device)
    dt = cfg.compute_dtype
    table = params["item_table"].to(dt)
    hist = _ids(batch["hist"], dev)
    target = _ids(batch["target"], dev)
    B, T = hist.shape
    h_emb = F.embedding(hist, table)  # (B, T, D)
    t_emb = F.embedding(target, table)  # (B, D)
    valid = (hist > 0).to(dt)  # (B, T)

    if cfg.gru_dim:
        H = cfg.gru_dim
        hs = _gru_scan(
            h_emb.transpose(0, 1),
            torch.zeros((B, H), dtype=dt, device=dev),
            params["gru_wx"].to(dt), params["gru_wh"].to(dt), params["gru_b"].to(dt),
        )  # (T, B, H)
        att_in = torch.cat([hs, t_emb[None].expand(T, B, t_emb.shape[-1])], dim=-1)
        scores = mlp_apply(params, "att", att_in, len(cfg.attn_mlp) + 1)[..., 0]
        scores = torch.sigmoid(scores) * valid.transpose(0, 1)  # (T, B)
        h_final = _gru_scan(
            hs,
            torch.zeros((B, H), dtype=dt, device=dev),
            params["augru_wx"].to(dt), params["augru_wh"].to(dt),
            params["augru_b"].to(dt),
            a_seq=scores, keep_all=False,
        )  # (B, H): the reference's h_seq[-1]
        x = torch.cat([h_final, t_emb], dim=-1)
    else:
        tb = t_emb[:, None].expand(h_emb.shape)
        att_in = torch.cat([h_emb, tb, h_emb - tb, h_emb * tb], dim=-1)
        scores = mlp_apply(params, "att", att_in, len(cfg.attn_mlp) + 1)[..., 0]
        scores = torch.sigmoid(scores) * valid  # DIN: no softmax (paper §4)
        pooled = torch.einsum("btd,bt->bd", h_emb, scores.to(h_emb.dtype))
        x = torch.cat([pooled, t_emb, pooled * t_emb], dim=-1)
    out = mlp_apply(params, "fin", x, len(cfg.mlp) + 1)
    return out[:, 0]


def din_loss(params, cfg: DINConfig, batch, *,
             device: str | torch.device | None = "cuda"):
    logit = din_forward(params, cfg, batch, device=device)
    loss = bce_loss(logit, batch["label"])
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# two-tower retrieval
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    embed_dim: int = 256  # final tower output dim
    field_dim: int = 64
    n_user_fields: int = 4
    n_item_fields: int = 4
    vocab_per_field: int = 100_000
    tower_mlp: tuple = (1024, 512, 256)
    temperature: float = 0.05
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def param_specs(self):
        specs = {
            "user_tables": ParamSpec(
                (self.n_user_fields, self.vocab_per_field, self.field_dim),
                (None, "table_rows", "embed"),
                scale=0.01,
            ),
            "item_tables": ParamSpec(
                (self.n_item_fields, self.vocab_per_field, self.field_dim),
                (None, "table_rows", "embed"),
                scale=0.01,
            ),
        }
        u_in = self.n_user_fields * self.field_dim
        i_in = self.n_item_fields * self.field_dim
        specs.update(mlp_specs((u_in, *self.tower_mlp), "user"))
        specs.update(mlp_specs((i_in, *self.tower_mlp), "item"))
        return specs

    def param_count(self) -> int:
        return param_count(self.param_specs())


def tower(params, cfg: TwoTowerConfig, prefix: str, ids, *,
          device: str | torch.device | None = "cuda"):
    """One tower: (B, F) ids -> (B, embed_dim), L2-normalised with the
    norm floored at 1e-6."""
    dev = _on(params, device)
    ids = _ids(ids, dev)
    embs = field_lookup(params[f"{prefix}_tables"].to(cfg.compute_dtype), ids)
    x = embs.reshape(ids.shape[0], -1)
    x = mlp_apply(params, prefix, x, len(cfg.tower_mlp))
    norm = x.square().sum(dim=-1, keepdim=True).sqrt()
    return x / torch.clamp(norm, min=1e-6)


def twotower_loss(params, cfg: TwoTowerConfig, batch, *,
                  device: str | torch.device | None = "cuda"):
    """In-batch sampled softmax (negatives = other rows of the batch)."""
    u = tower(params, cfg, "user", batch["user_ids"], device=device)
    it = tower(params, cfg, "item", batch["item_ids"], device=device)
    logits = (u @ it.T).float() / cfg.temperature  # (B, B)
    labels = torch.arange(u.shape[0], device=u.device)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.diagonal(logits)
    loss = (logz - ll).mean()
    acc = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, {"loss": loss, "acc": acc}


def twotower_score(params, cfg: TwoTowerConfig, batch, *,
                   device: str | torch.device | None = "cuda"):
    """Retrieval scoring: one user against (Nc,) candidate items -> (Nc,)."""
    u = tower(params, cfg, "user", batch["user_ids"], device=device)  # (1, D)
    it = tower(params, cfg, "item", batch["cand_ids"], device=device)  # (Nc, D)
    return (it @ u[0]).float()


def pair_score(params, cfg: TwoTowerConfig, batch, *,
               device: str | torch.device | None = "cuda"):
    """Online serving: score (user, item) pairs row-wise (the reference's
    ``configs/two_tower.py::pair_score``)."""
    u = tower(params, cfg, "user", batch["user_ids"], device=device)
    it = tower(params, cfg, "item", batch["item_ids"], device=device)
    return (u * it).sum(dim=-1).float()

