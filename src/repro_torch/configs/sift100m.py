"""sift100m -- the paper's own deployment: vocabulary-tree index build +
batch search over SIFT descriptors (d = 128), the numbers of the JAX
package's ``configs/sift100m.py``.

The paper streams 4 TB (30 B descriptors) from HDFS; the reference's
cells size one step at 2^28 descriptors and a 256 x 256 = 65,536-leaf
tree. Batch shapes: ``search_32k`` (2^15 query descriptors, the Copydays
batch analog) and ``search_1m`` (2^20, the "12k image" batch analog).
The reference's TPU cells (abstract shapes, shardings, ``model_flops``)
are not copied: they describe a TPU mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve

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
