"""gin-tu [gnn] n_layers=5 d_hidden=64 aggregator=sum eps=learnable
[arXiv:1810.00826; paper] -- the numbers of the JAX package's
``configs/gin_tu.py``: the four shape regimes, their padded sizes, the
FLOP count and the smoke entry point (on ``device``: the card unless the
caller passes ``device="cpu"``). The reference's cells are not copied:
they describe a TPU mesh.

  full_graph_sm -- Cora-scale full batch (2708 nodes / 10556 edges / 1433 f)
  minibatch_lg  -- Reddit-scale sampled training (fanout 15-10, batch 1024)
  ogb_products  -- 2.45M nodes / 61.9M edges full batch (d_feat 100)
  molecule      -- 128 graphs x 30 nodes x 64 edges (disjoint union)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.data import graph as gd
from repro_torch.device import resolve
from repro_torch.distributed.meshutil import round_up
from repro_torch.models import gnn
from repro_torch.models.module import init_params
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train.step import init_train_state

#: (shape name, d_in, n_classes, nodes, edges) -- padded to mesh-safe sizes
SHAPES = {
    "full_graph_sm": dict(d_in=1433, n_classes=7, nodes=2708, edges=10556),
    "minibatch_lg": dict(d_in=602, n_classes=41, nodes=169984, edges=168960),
    "ogb_products": dict(d_in=100, n_classes=47, nodes=2449029, edges=61859140),
    "molecule": dict(d_in=16, n_classes=2, nodes=30 * 128, edges=64 * 128),
}


def padded(spec: dict) -> dict:
    """A shape with its nodes padded to a multiple of 256 and its edges to
    one of 1024 (the reference's ``_padded``)."""
    return dict(spec, nodes=round_up(spec["nodes"], 256),
                edges=round_up(spec["edges"], 1024))


def gin_config(shape_name: str) -> gnn.GINConfig:
    """gin-tu at ``shape_name``'s input width and class count."""
    spec = SHAPES[shape_name]
    return gnn.GINConfig(name="gin-tu", n_layers=5, d_hidden=64,
                         d_in=spec["d_in"], n_classes=spec["n_classes"])


def gin_flops(cfg: gnn.GINConfig, n_nodes: int, n_edges: int) -> float:
    """A forward's FLOPs (the reference's ``_mlp_flops_gin``); a train step
    counts three times this."""
    h = cfg.d_hidden
    per_layer = 2.0 * n_nodes * (h * h * 2)
    l0 = 2.0 * n_nodes * (cfg.d_in * h + h * h)
    agg = cfg.n_layers * n_edges * h  # segment-sum adds
    out = 2.0 * n_nodes * h * cfg.n_classes
    return l0 + (cfg.n_layers - 1) * per_layer + agg + out


def gin_smoke(device: str | torch.device | None = "cuda") -> dict:
    """Reduced GIN: a full-batch step, then a neighbor-sampled minibatch
    step (the minibatch_lg path, reduced)."""
    dev = resolve(device)
    cfg = gnn.GINConfig(name="gin-smoke", n_layers=3, d_in=12, d_hidden=16,
                        n_classes=4)
    params = init_params(cfg.param_specs(), torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    opt = init_train_state(params)
    step = make_train_step(lambda p, b: gnn.loss_fn(p, cfg, b, device=dev),
                           AdamWConfig())
    g = gd.random_graph(300, 6.0, seed=1)
    feats = np.random.default_rng(2).standard_normal((300, 12)).astype(np.float32)
    labels = np.random.default_rng(3).integers(0, 4, 300).astype(np.int32)
    edges = gd.to_edge_list(g)
    batch = gd.pad_graph_batch(feats, edges, labels, n_nodes_pad=384,
                               n_edges_pad=round_up(edges.shape[1], 256))
    params, opt, m = step(params, opt, gnn.prepare(batch, device=dev))
    loss = float(m["loss"])
    seeds = np.arange(32)
    sub, sedges, n_seed = gd.neighbor_sample(g, seeds, (5, 3), seed=4)
    sl = np.full(len(sub), -1, np.int32)
    sl[:n_seed] = labels[sub[:n_seed]]
    sb = gd.pad_graph_batch(feats[sub], sedges, sl, n_nodes_pad=640, n_edges_pad=640)
    params, _, m2 = step(params, opt, gnn.prepare(sb, device=dev))
    mb_loss = float(m2["loss"])
    if not (math.isfinite(loss) and math.isfinite(mb_loss)):
        raise AssertionError(f"gin smoke: losses {loss}, {mb_loss}")
    return {"loss": loss, "mb_loss": mb_loss, "params": cfg.param_count()}
