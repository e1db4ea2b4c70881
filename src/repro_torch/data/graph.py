"""Graph data substrate: generators, CSR, and a real neighbor sampler --
a numpy copy of the JAX package's ``data/graph.py``: the same outputs, bit
for bit, for the same seeds.

``minibatch_lg`` (GraphSAGE-style sampled training) needs an actual
neighbor sampler, not a stub: ``neighbor_sample`` draws a fanout-bounded
k-hop subgraph from a CSR adjacency, relabels nodes compactly (seeds
first), and pads to static shapes so one jitted train step serves every
batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray  # (N+1,)
    indices: np.ndarray  # (E,) neighbor ids (out-edges)
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return int(self.indices.shape[0])


def random_graph(n_nodes: int, avg_degree: float, *, seed: int = 0,
                 power_law: bool = True) -> CSRGraph:
    """Random directed graph with (optionally) power-law out-degrees."""
    rng = np.random.default_rng(seed)
    if power_law:
        raw = rng.pareto(1.5, n_nodes) + 1.0
        deg = np.minimum(
            (raw / raw.mean() * avg_degree).astype(np.int64), n_nodes - 1
        )
    else:
        deg = np.full(n_nodes, int(avg_degree), np.int64)
    deg = np.maximum(deg, 1)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n_nodes, size=int(indptr[-1]), dtype=np.int64)
    return CSRGraph(indptr=indptr, indices=indices, n_nodes=n_nodes)


def to_edge_list(g: CSRGraph):
    """(2, E) [src, dst] int32 edge list from CSR (src = row owner)."""
    src = np.repeat(np.arange(g.n_nodes, dtype=np.int64), np.diff(g.indptr))
    return np.stack([src, g.indices]).astype(np.int64)


def neighbor_sample(g: CSRGraph, seeds: np.ndarray, fanouts, *, seed: int = 0):
    """GraphSAGE sampling: per hop, draw <= fanout neighbors of the frontier.

    Returns (sub_nodes, edges (2, E_sub) *relabelled*, n_seeds) with seeds
    occupying rows [0, n_seeds). Edges point child -> parent (message flows
    sampled-neighbor -> frontier node), matching GIN aggregation.
    """
    rng = np.random.default_rng(seed)
    id_of = {int(s): i for i, s in enumerate(seeds)}
    sub_nodes = list(int(s) for s in seeds)
    edges_src, edges_dst = [], []
    frontier = list(int(s) for s in seeds)
    for fanout in fanouts:
        nxt = []
        for u in frontier:
            lo, hi = g.indptr[u], g.indptr[u + 1]
            nbrs = g.indices[lo:hi]
            if len(nbrs) == 0:
                continue
            take = min(fanout, len(nbrs))
            picks = rng.choice(nbrs, size=take, replace=False)
            for v in picks:
                v = int(v)
                if v not in id_of:
                    id_of[v] = len(sub_nodes)
                    sub_nodes.append(v)
                    nxt.append(v)
                edges_src.append(id_of[v])
                edges_dst.append(id_of[u])
        frontier = nxt
    edges = np.stack(
        [np.asarray(edges_src, np.int64), np.asarray(edges_dst, np.int64)]
    ) if edges_src else np.zeros((2, 0), np.int64)
    return np.asarray(sub_nodes, np.int64), edges, len(seeds)


def pad_graph_batch(feats, edges, labels, *, n_nodes_pad: int, n_edges_pad: int):
    """Pad to static shapes: padded edges get weight 0, padded labels -1."""
    n, e = feats.shape[0], edges.shape[1]
    if n > n_nodes_pad or e > n_edges_pad:
        raise ValueError(f"batch ({n},{e}) exceeds pad ({n_nodes_pad},{n_edges_pad})")
    f = np.zeros((n_nodes_pad, feats.shape[1]), feats.dtype)
    f[:n] = feats
    ee = np.zeros((2, n_edges_pad), np.int32)
    ee[:, :e] = edges
    w = np.zeros(n_edges_pad, np.float32)
    w[:e] = 1.0
    ll = np.full(n_nodes_pad, -1, np.int32)
    ll[:n] = labels
    return {"feats": f, "edges": ee, "edge_w": w, "labels": ll}


def molecule_batch(n_graphs: int, nodes_per_graph: int, edges_per_graph: int,
                   d_feat: int, n_classes: int, *, seed: int = 0):
    """Disjoint union of small graphs (graph classification -> node-level
    labels on a virtual readout node kept simple: label every node with the
    graph label; loss masking handles the rest)."""
    rng = np.random.default_rng(seed)
    N = n_graphs * nodes_per_graph
    feats = rng.standard_normal((N, d_feat)).astype(np.float32)
    src = rng.integers(0, nodes_per_graph, (n_graphs, edges_per_graph))
    dst = rng.integers(0, nodes_per_graph, (n_graphs, edges_per_graph))
    offs = (np.arange(n_graphs) * nodes_per_graph)[:, None]
    edges = np.stack([(src + offs).reshape(-1), (dst + offs).reshape(-1)])
    labels = np.repeat(rng.integers(0, n_classes, n_graphs), nodes_per_graph)
    return {
        "feats": feats,
        "edges": edges.astype(np.int32),
        "edge_w": np.ones(edges.shape[1], np.float32),
        "labels": labels.astype(np.int32),
    }
