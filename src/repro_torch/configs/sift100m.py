"""sift100m -- the paper's own deployment: vocabulary-tree index build +
batch search over SIFT descriptors (d = 128), the numbers of the JAX
package's ``configs/sift100m.py``.

The paper streams 4 TB (30 B descriptors) from HDFS; the reference's
cells size one step at 2^28 descriptors and a 256 x 256 = 65,536-leaf
tree. Shapes:
  index_wave   -- one index-creation wave (map + shuffle + reduce), 2^28 rows
  search_1m    -- 2^20-descriptor query batch (the "12k image" batch analog)
  search_32k   -- 2^15-descriptor batch (the Copydays batch analog)
  tree_build   -- sampling + hierarchy construction on a 2^22-row sample

The cells keep the reference's arguments, shardings and ``model_flops``.
On the card a cell is cut along the rows of its corpus only, which is
made there from the seed: SIFT-like rows of :func:`corpus_on`, a
256-component mixture (``data/synth.py``'s) drawn with a
``torch.Generator`` on the card. The index is built with the port's
4,096-row waves (every wave size gives the same index, bit for bit) and
searched at :data:`SEARCH_IMPL`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ArchDef, Cell, register
from repro_torch.core.index_build import routing_capacity
from repro_torch.device import resolve
from repro_torch.distributed.partitioning import DEFAULT_RULES
from repro_torch.distributed.shardutil import Arg

DIM = 128
FANOUTS = (256, 256)
N_LEAVES = 65536
INDEX_ROWS = 2**28
WAVE_ROWS = 1024  # the reference's index_wave cell (the port's builds take 4096)
CAPACITY_FACTOR = 2.0
K = 20

#: batch-search shapes: query rows, lookup slab budget, wave rows
SEARCH_32K = dict(q_total=2**15, q_cap=1024, block_rows=4096)
SEARCH_1M = dict(q_total=2**20, q_cap=4096, block_rows=4096)


def sift_smoke(device="cuda") -> dict:
    """Reduced end-to-end: build tree + index + search, check exactness
    (top-1 equal to a brute-force scan of the query's leaf for at least
    62 of 64 queries).

    Raises:
      AssertionError: routing or slab overflow, or too few exact top-1s.
    """
    from repro_torch.core.index_build import build_index
    from repro_torch.core.search import batch_search
    from repro_torch.core.tree import build_tree, tree_assign
    from repro_torch.data import synth

    dev = resolve(device)
    vecs_np, _ = synth.sample_descriptors(2048, 32, seed=0, n_centers=40)
    vecs = torch.as_tensor(vecs_np, device=dev)
    tree = build_tree(vecs, (8, 8), generator=torch.Generator().manual_seed(1),
                      device=dev)
    index = build_index(vecs, tree, wire_dtype=torch.float32, device=dev)
    if int(index.overflow) != 0:
        raise AssertionError(f"routing overflow {int(index.overflow)}")
    queries = vecs[:64] + 0.5
    res = batch_search(index, tree, queries, k=5, q_cap=64, device=dev)
    if int(res.q_cap_overflow) != 0:
        raise AssertionError(f"q_cap overflow {int(res.q_cap_overflow)}")
    top1 = res.ids[:, 0].cpu().numpy()
    # oracle: brute-force within-leaf
    leaves = tree_assign(tree, vecs).cpu().numpy()
    qleaves = tree_assign(tree, queries).cpu().numpy()
    q = queries.cpu().numpy()
    correct = 0
    for i in range(64):
        cand = np.flatnonzero(leaves == qleaves[i])
        d2 = ((vecs_np[cand] - q[i]) ** 2).sum(1)
        if cand[np.argmin(d2)] == top1[i]:
            correct += 1
    if correct < 62:
        raise AssertionError(f"in-leaf nearest mismatch: {correct}/64")
    return {"top1_exact": correct / 64.0, "leaves": tree.n_leaves}


# ---------------------------------------------------------------------------
# cells (the reference's make_{index,search,tree}_cell)
# ---------------------------------------------------------------------------

SAMPLE_ROWS = 2**22  # tree_build's sample
TREE_SAMPLE = 2**20  # the sample a search or index cell's tree is built on
#: the point-major executor a search cell runs on the card: ``"fused"``
#: (K2, one launch over the shard). ``"xla"`` and ``"pallas"`` sweep the
#: shard in 4,096-row waves through K1 from the host (8,192 waves at 2^24
#: rows, whose trace alone takes minutes); every impl gives the same ids.
SEARCH_IMPL = "fused"
#: the flat-mesh variants shard rows over every mesh axis
FLAT_RULES = DEFAULT_RULES.extend(rows=("pod", "data", "model"))


def n_shards_for(layout: dict, rules=DEFAULT_RULES) -> int:
    """Row shards of ``layout``: the product of the axes ``rows`` maps to."""
    return math.prod(layout.get(a, 1) for a in rules.mesh_axes("rows"))


def tree_args() -> tuple:
    return (Arg((FANOUTS[0], DIM), torch.float32),
            Arg((FANOUTS[0], FANOUTS[1], DIM), torch.float32))


def index_args(layout: dict, rows: int, rules=DEFAULT_RULES,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    """The ``DistributedIndex`` of ``rows`` corpus rows built over
    ``layout``'s row shards (the reference's ``index_abstract``): each
    shard receives ``n_shards x capacity`` rows."""
    n = n_shards_for(layout, rules)
    capacity = routing_capacity(rows // n, n, CAPACITY_FACTOR)
    r = n * capacity
    return {"vecs": Arg((n * r, DIM), dtype, ("rows", None)),
            "ids": Arg((n * r,), torch.int32, ("rows",)),
            "leaves": Arg((n * r,), torch.int32, ("rows",)),
            "offsets": Arg((n, N_LEAVES // n + 1), torch.int32, ("rows", None)),
            "n_valid": Arg((n,), torch.int32, ("rows",)),
            "overflow": Arg((), torch.int32, ())}


def lookup_args(q_total: int) -> dict:
    return {"vecs": Arg((q_total, DIM), torch.float32),
            "qids": Arg((q_total,), torch.int32),
            "leaves": Arg((q_total,), torch.int32),
            "offsets": Arg((N_LEAVES + 1,), torch.int32)}


def corpus_on(rows: int, seed: int, device, dtype=torch.float32,
              chunk: int = 2**22) -> torch.Tensor:
    """(rows, DIM) quantized SIFT-like rows drawn on ``device`` from
    ``seed``: the 256-component mixture of ``data/synth.py`` (its centers
    and scales from numpy, 132 KB), each row a component drawn by its
    power-law mass plus Gaussian noise at its scale, clipped to [0, 255]
    and rounded."""
    from repro_torch.data import synth

    dev = resolve(device)
    centers, scales, weights = (torch.as_tensor(a, device=dev) for a in
                                synth.make_mixture(256, DIM, seed=seed))
    g = torch.Generator(device=dev).manual_seed(seed)
    out = torch.empty((rows, DIM), dtype=dtype, device=dev)
    for s in range(0, rows, chunk):
        m = min(chunk, rows - s)
        comp = torch.multinomial(weights, m, replacement=True, generator=g)
        x = torch.randn((m, DIM), generator=g, device=dev).mul_(scales[comp])
        out[s:s + m] = x.add_(centers[comp]).clamp_(0.0, 255.0).round_()
    return out


def _tree_on(corpus: torch.Tensor, seed: int):
    from repro_torch.core.tree import build_tree

    step = max(1, corpus.shape[0] // TREE_SAMPLE)
    return build_tree(corpus[::step][:TREE_SAMPLE], FANOUTS, device=corpus.device,
                      generator=torch.Generator().manual_seed(seed + 1))


def _build_bytes(rows: int, in_bytes: int) -> float:
    """``build_index``'s working set for ``rows`` corpus rows whose vectors
    take ``in_bytes`` each: the routed send buffer at the wire dtype (bf16,
    ``CAPACITY_FACTOR`` x the rows, with ids and leaves), the sorted index
    in the corpus dtype, the cluster sort's gathered copy before the
    received rows are freed, and the sort's keys and order."""
    padded = CAPACITY_FACTOR * rows
    return padded * ((2 * DIM + 8) + 2 * (in_bytes + 8) + 16)


def make_index_cell(rules=DEFAULT_RULES) -> Cell:
    def args_fn(rows, layout, on_card):
        return (Arg((rows, DIM), torch.bfloat16, ("rows", None)),
                Arg((rows,), torch.int32, ("rows",)), tree_args())

    def build_fn(dev, rows, seed):
        from repro_torch.core.index_build import build_index

        vecs = corpus_on(rows, seed, dev, dtype=torch.bfloat16)
        tree = _tree_on(vecs, seed)
        ids = torch.arange(rows, dtype=torch.int32, device=dev)

        def fn(vecs, ids, tree):
            return build_index(vecs, tree, ids=ids, wire_dtype=torch.bfloat16,
                               capacity_factor=CAPACITY_FACTOR, device=dev)

        return fn, (vecs, ids, tree)

    # useful work: every row 2d-GEMM'd against f0 + f1 centroids
    return Cell(
        arch="sift100m", shape="index_wave", kind="train", args_fn=args_fn,
        flops_fn=lambda rows: rows * 2.0 * DIM * (FANOUTS[0] + FANOUTS[1]),
        work_fn=lambda rows: _build_bytes(rows, 2 * DIM), build_fn=build_fn,
        batch=("rows", INDEX_ROWS), rules=rules)


def search_flops(rows: int, q_total: int) -> float:
    """Expected same-leaf collision pairs x 2d (uniform estimate), plus the
    queries' descent through the tree."""
    pairs = rows * (q_total / N_LEAVES)
    return pairs * 2.0 * DIM + q_total * 2.0 * DIM * sum(FANOUTS)


def make_search_cell(shape_name: str, q_total: int, q_cap: int,
                     block_rows: int = 4096) -> Cell:
    def args_fn(rows, layout, on_card):
        # the card build keeps the corpus's fp32 rows in its index
        dtype = torch.float32 if on_card else torch.bfloat16
        return (index_args(layout, rows, dtype=dtype), lookup_args(q_total))

    def build_fn(dev, rows, seed):
        from repro_torch.core.engine import SearchPlan
        from repro_torch.core.index_build import build_index
        from repro_torch.core.lookup import build_lookup
        from repro_torch.core.search import search_with_lookup

        corpus = corpus_on(rows, seed, dev)
        tree = _tree_on(corpus, seed)
        index = build_index(corpus, tree, wire_dtype=torch.bfloat16,
                            capacity_factor=CAPACITY_FACTOR, device=dev)
        g = torch.Generator(device=dev).manual_seed(seed + 2)
        src = torch.randint(0, rows, (q_total,), generator=g, device=dev)
        noise = torch.randint(-4, 5, (q_total, DIM), generator=g, device=dev)
        queries = (corpus[src] + noise).clamp_(0, 255)  # copy-detection queries
        del corpus
        lookup = build_lookup(tree, queries)
        plan = SearchPlan(layout="point_major", k=K, impl=SEARCH_IMPL,
                          block_rows=block_rows, q_cap=q_cap)

        def fn(index, lookup):
            return search_with_lookup(index, lookup, plan, n_queries=q_total)

        return fn, (index, lookup)

    return Cell(
        arch="sift100m", shape=shape_name, kind="serve", args_fn=args_fn,
        flops_fn=lambda rows: search_flops(rows, q_total),
        # the build's: the fp32 corpus, and build_index's working set
        work_fn=lambda rows: rows * DIM * 4.0 + _build_bytes(rows, 4 * DIM),
        build_fn=build_fn, batch=("rows", INDEX_ROWS))


def make_tree_cell() -> Cell:
    def args_fn(b, layout, on_card):
        return (Arg((SAMPLE_ROWS, DIM), torch.float32, ("rows", None)),
                Arg((2,), torch.uint32))

    def build_fn(dev, b, seed):
        from repro_torch.core.tree import build_tree

        def fn(vecs, key):
            return build_tree(vecs, FANOUTS, device=dev, refine_iters=0,
                              generator=torch.Generator().manual_seed(key))

        return fn, (corpus_on(SAMPLE_ROWS, seed, dev), seed + 1)

    return Cell(
        arch="sift100m", shape="tree_build", kind="train", args_fn=args_fn,
        flops_fn=lambda b: SAMPLE_ROWS * 2.0 * DIM * (FANOUTS[0] + FANOUTS[1]),
        # each row's fp32 distances to a level's centroids, and its leaf
        work_fn=lambda b: SAMPLE_ROWS * (FANOUTS[0] * 4.0 + 16),
        build_fn=build_fn)


register(ArchDef(
    name="sift100m", family="index",
    config=dict(dim=DIM, fanouts=FANOUTS, n_leaves=N_LEAVES,
                index_rows_per_wave=INDEX_ROWS, k=K),
    cells={
        "index_wave": make_index_cell,
        "search_1m": lambda: make_search_cell("search_1m", SEARCH_1M["q_total"],
                                              SEARCH_1M["q_cap"]),
        "search_32k": lambda: make_search_cell("search_32k", SEARCH_32K["q_total"],
                                               SEARCH_32K["q_cap"]),
        "tree_build": make_tree_cell,
    },
    smoke=sift_smoke))
