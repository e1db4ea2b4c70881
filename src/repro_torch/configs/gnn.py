"""gin-tu [gnn] n_layers=5 d_hidden=64 aggregator=sum eps=learnable
[arXiv:1810.00826; paper] -- the numbers of the JAX package's
``configs/gin_tu.py``: the four shape regimes, their padded sizes, the
FLOP count, the four cells (one train step each, never cut: a graph is
one batch) and the smoke entry point (on ``device``: the card unless the
caller passes ``device="cpu"``).

  full_graph_sm -- Cora-scale full batch (2708 nodes / 10556 edges / 1433 f)
  minibatch_lg  -- Reddit-scale sampled training (fanout 15-10, batch 1024)
  ogb_products  -- 2.45M nodes / 61.9M edges full batch (d_feat 100)
  molecule      -- 128 graphs x 30 nodes x 64 edges (disjoint union)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ArchDef, Cell, register
from repro_torch.data import graph as gd
from repro_torch.device import resolve
from repro_torch.distributed.meshutil import round_up
from repro_torch.distributed.shardutil import Arg, abstract_opt_state, abstract_params
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


#: minibatch_lg's base graph: Reddit's nodes and mean degree, its seed
#: nodes and the sampling fanout (15-10)
REDDIT = (232965, 492)
MB_SEEDS = 1024
MB_FANOUT = (15, 10)


def gin_batch(shape_name: str, seed: int, device, *, prepare: bool = True
              ) -> tuple[dict, dict]:
    """gin-tu's ``shape_name`` as a padded batch on ``device``: the real
    sizes, then ``pad_graph_batch``'s padding (padded edges of weight 0
    into node 0, padded labels -1), its edges sorted both ways unless
    ``prepare`` is False (``gnn.prepare``). Structures from
    ``data/graph.py`` (molecules; a neighbour sample of a Reddit-sized
    graph; a random graph of the shape's sizes), features and labels drawn
    on the device from ``seed``. Returns (batch, its real and padded
    sizes)."""
    dev = resolve(device)
    spec = SHAPES[shape_name]
    pad = padded(spec)
    g = torch.Generator(device=dev).manual_seed(seed + 31)
    n_classes = spec["n_classes"]
    if shape_name == "molecule":
        mb = gd.molecule_batch(128, 30, 64, spec["d_in"], n_classes, seed=seed)
        feats = torch.as_tensor(mb["feats"], device=dev)
        edges = torch.as_tensor(mb["edges"], device=dev)
        labels = torch.as_tensor(mb["labels"], device=dev)
    elif shape_name == "minibatch_lg":
        base = gd.random_graph(*REDDIT, seed=seed)
        seeds = np.random.default_rng(seed + 32).choice(base.n_nodes, MB_SEEDS,
                                                        replace=False)
        sub, e, n_seed = gd.neighbor_sample(base, seeds, MB_FANOUT, seed=seed)
        del base
        feats = torch.randn((len(sub), spec["d_in"]), generator=g, device=dev)
        edges = torch.as_tensor(e, device=dev)
        labels = torch.full((len(sub),), -1, dtype=torch.int32, device=dev)
        labels[:n_seed] = torch.randint(0, n_classes, (n_seed,), generator=g,
                                        device=dev, dtype=torch.int32)
    else:
        base = gd.random_graph(spec["nodes"], spec["edges"] / spec["nodes"], seed=seed)
        edges = torch.as_tensor(gd.to_edge_list(base), device=dev)
        del base
        feats = torch.randn((spec["nodes"], spec["d_in"]), generator=g, device=dev)
        labels = torch.randint(0, n_classes, (spec["nodes"],), generator=g, device=dev,
                               dtype=torch.int32)
    n, e = feats.shape[0], edges.shape[1]
    if n > pad["nodes"] or e > pad["edges"]:
        raise ValueError(f"gin {shape_name}: ({n}, {e}) exceeds the pad {pad}")
    batch = {"feats": torch.zeros((pad["nodes"], spec["d_in"]), device=dev),
             "edges": torch.zeros((2, pad["edges"]), dtype=torch.int32, device=dev),
             "edge_w": torch.zeros((pad["edges"],), device=dev),
             "labels": torch.full((pad["nodes"],), -1, dtype=torch.int32, device=dev)}
    batch["feats"][:n] = feats
    batch["edges"][:, :e] = edges
    batch["edge_w"][:e] = 1.0
    batch["labels"][:n] = labels
    sizes = dict(nodes=n, edges=e, padded=pad)
    return (gnn.prepare(batch, device=dev) if prepare else batch), sizes


def gin_work_bytes(cfg: gnn.GINConfig, nodes: int, edges: int) -> float:
    """A train step's bytes beyond its arguments (the cell's activation
    estimate): the edges sorted both ways (``gnn.prepare``: int64 rows and
    columns, fp32 weights, twice), and each layer's fp32 node tensors (the
    aggregate, two MLP outputs, their activations) kept for the backward,
    with as much again while it runs."""
    per_node = 3 * cfg.d_in + 6 * cfg.n_layers * cfg.d_hidden
    return 2 * edges * 20.0 + nodes * per_node * 4.0 * 2


def make_gin_cell(shape_name: str) -> Cell:
    spec = padded(SHAPES[shape_name])
    cfg = gin_config(shape_name)
    N, E = spec["nodes"], spec["edges"]

    def args_fn(b, layout, on_card):
        p = abstract_params(cfg.param_specs())
        batch = {"feats": Arg((N, spec["d_in"]), torch.float32, ("nodes", None)),
                 "edges": Arg((2, E), torch.int32, (None, "edges")),
                 "edge_w": Arg((E,), torch.float32, ("edges",)),
                 "labels": Arg((N,), torch.int32, ("nodes",))}
        return (p, abstract_opt_state(p), batch)

    def build_fn(dev, b, seed):
        params = init_params(cfg.param_specs(), torch.Generator(device=dev).manual_seed(seed),
                             device=dev)
        step = make_train_step(lambda p, bb: gnn.loss_fn(p, cfg, bb, device=dev),
                               AdamWConfig())
        return step, (params, init_train_state(params), gin_batch(shape_name, seed, dev)[0])

    return Cell(
        arch="gin-tu", shape=shape_name, kind="train", args_fn=args_fn,
        flops_fn=lambda b: 3.0 * gin_flops(cfg, N, E),
        work_fn=lambda b: gin_work_bytes(cfg, N, E), build_fn=build_fn,
        donate=(0, 1), config=cfg)


register(ArchDef(
    name="gin-tu", family="gnn",
    config=gnn.GINConfig(name="gin-tu", n_layers=5, d_hidden=64),
    cells={s: (lambda s=s: make_gin_cell(s)) for s in SHAPES},
    smoke=gin_smoke))
