"""GIN (Graph Isomorphism Network, arXiv:1810.00826) in PyTorch: the JAX
package's ``models/gnn.py``, with its names, its stacked ``(L-1, h, h)``
weights for layers 1..L-1 and its masked cross entropy.

Message passing sums ``edge_w * h[src]`` into each destination. The
reference gathers the (E, d) messages and scatter-adds them
(``jax.ops.segment_sum``); here ``kernels.segsum.segment_sum`` sums each
destination's edges in their list order without the (E, d) tensor: on
the card the ``segsum`` kernel (``csrc/segsum.cu``), whose backward runs
the same kernel over the edges sorted by source, deterministic and free
of atomics; on the CPU its plain version. The two sorted orders of a
graph's edges (``kernels.segsum.edge_graph``) are built once per graph by
:func:`prepare` and reused by every step; a batch without them is sorted
on each call. Layers 1..L-1 run as a Python loop over the stacked weights
(the reference's ``lax.scan``).

Padding convention (the reference's): padded edges carry weight 0 (they
still point at node 0, but contribute nothing); padded nodes carry label
-1 (masked out of the loss).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve
from repro_torch.kernels.segsum import EdgeGraph, edge_graph, segment_sum
from repro_torch.models.module import ParamSpec, param_count

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str
    n_layers: int = 5
    d_in: int = 1433
    d_hidden: int = 64
    n_classes: int = 7
    train_eps: bool = True  # learnable eps (GIN-eps)
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def param_specs(self):
        L, h = self.n_layers, self.d_hidden
        return {
            "in_w1": ParamSpec((self.d_in, h), ("feat", "ffn")),
            "in_b1": ParamSpec((h,), (None,), init="zeros"),
            "in_w2": ParamSpec((h, h), (None, "ffn")),
            "in_b2": ParamSpec((h,), (None,), init="zeros"),
            # layers 1..L-1 stacked (uniform dims)
            "w1": ParamSpec((L - 1, h, h), ("layers", None, "ffn")),
            "b1": ParamSpec((L - 1, h), ("layers", None), init="zeros"),
            "w2": ParamSpec((L - 1, h, h), ("layers", None, "ffn")),
            "b2": ParamSpec((L - 1, h), ("layers", None), init="zeros"),
            "eps": ParamSpec((L,), (None,), init="zeros"),
            "out_w": ParamSpec((h, self.n_classes), (None, None)),
            "out_b": ParamSpec((self.n_classes,), (None,), init="zeros"),
        }

    def param_count(self) -> int:
        return param_count(self.param_specs())


def _graph(batch, n_nodes: int, dev) -> EdgeGraph:
    """The batch's edges sorted both ways: ``batch["graph"]`` if
    :func:`prepare` made it, else sorted now."""
    if "graph" in batch:
        return batch["graph"]
    edges = torch.as_tensor(batch["edges"], device=dev).long()
    w = batch.get("edge_w")
    w = (torch.ones(edges.shape[1], dtype=torch.float32, device=dev) if w is None
         else torch.as_tensor(w, device=dev))
    return edge_graph(edges[0], edges[1], w, n_nodes)


def prepare(batch, *, device: str | torch.device | None = "cuda") -> dict:
    """``batch`` (``feats``, ``edges`` (2, E), optional ``edge_w``,
    ``labels``) as tensors on ``device``, with ``graph``: its edges sorted
    by destination and by source, once for every step that reuses it."""
    dev = resolve(device)
    out = {key: torch.as_tensor(v, device=dev) for key, v in batch.items()
           if key != "graph"}
    out["graph"] = _graph(out, out["feats"].shape[0], dev)
    return out


def forward(params, cfg: GINConfig, batch, *,
            device: str | torch.device | None = "cuda"):
    """batch: feats (N, d_in), edges (2, E) int, edge_w (E,) -- logits (N, C)."""
    dev = resolve(device)
    if params["eps"].device != dev:
        raise ValueError(f"params on {params['eps'].device}, run on {dev}")
    dt = cfg.compute_dtype
    feats = torch.as_tensor(batch["feats"], device=dev).to(dt)
    graph = _graph(batch, feats.shape[0], dev)

    eps = params["eps"].to(dt)
    h = feats
    # layer 0 (input dims differ)
    z = (1.0 + eps[0]) * h + segment_sum(h, graph)
    h = torch.relu(z @ params["in_w1"].to(dt) + params["in_b1"].to(dt))
    h = torch.relu(h @ params["in_w2"].to(dt) + params["in_b2"].to(dt))
    for i in range(cfg.n_layers - 1):
        z = (1.0 + eps[i + 1]) * h + segment_sum(h, graph)
        y = torch.relu(z @ params["w1"][i].to(dt) + params["b1"][i].to(dt))
        h = torch.relu(y @ params["w2"][i].to(dt) + params["b2"][i].to(dt))
    return h @ params["out_w"].to(dt) + params["out_b"].to(dt)


def loss_fn(params, cfg: GINConfig, batch, *,
            device: str | torch.device | None = "cuda"):
    """Node-classification CE over labels >= 0 (padding/masked = -1)."""
    logits = forward(params, cfg, batch, device=device).float()
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    valid = labels >= 0
    safe = torch.clamp(labels, min=0)
    logz = torch.logsumexp(logits, dim=-1)
    # the label's logit, without a gather (whose backward scatters)
    classes = torch.arange(logits.shape[-1], device=logits.device)
    ll = torch.where(classes == safe[:, None], logits, 0.0).sum(dim=-1)
    per_node = (logz - ll) * valid
    n_valid = torch.clamp(valid.sum(), min=1)
    loss = per_node.sum() / n_valid
    acc = ((logits.argmax(dim=-1) == labels) * valid).sum() / n_valid
    return loss, {"loss": loss, "acc": acc}
