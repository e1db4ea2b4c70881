"""Hierarchical vocabulary tree (Nister-Stewenius-style unstructured
quantization, paper section 2.3).

The C random representatives are organised in a hierarchy of L levels with
wide fanout (e.g. 256 x 256 = 65k leaves in two levels), so every level's
assignment is a dense ``(n, d) @ (d, fanout)`` product + argmin. Level 0 goes
through the ``l2nn`` kernel (K3 on the card); deeper levels gather each
row's children and take a batched product.

Tree layout (L levels, fanouts ``(f0, f1, ..)``):
  level 0: ``(f0, d)``  roots
  level i: ``(n_nodes_{i-1}, f_i, d)`` children per parent node
Leaf id of a descriptor = mixed-radix path ``((b0*f1)+b1)*f2+...``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.device import resolve
from repro_torch.kernels.l2nn.ops import l2_nearest

# Rows per batched product of a deeper level: bounds the (rows, f, d) gather
# (512 MiB at f = 256, d = 128). Every product runs at exactly this many
# rows (a short chunk is padded): cuBLAS picks its algorithm, and so the
# order of each dot product's sum, by the batch size, so on real-valued
# rows a leaf would otherwise depend on the wave size of the call.
CHUNK_ROWS = 4096


@dataclasses.dataclass
class VocabTree:
    """Index tree: the paper's broadcast auxiliary data (section 2.5)."""

    levels: tuple  # level 0: (f0, d); level i: (nodes_{i-1}, f_i, d)

    @property
    def fanouts(self) -> tuple[int, ...]:
        f = [self.levels[0].shape[0]]
        f.extend(lvl.shape[1] for lvl in self.levels[1:])
        return tuple(f)

    @property
    def n_leaves(self) -> int:
        return math.prod(self.fanouts)

    @property
    def dim(self) -> int:
        return self.levels[0].shape[-1]

    @property
    def nbytes(self) -> int:
        return sum(lvl.numel() * lvl.element_size() for lvl in self.levels)

    @property
    def device(self) -> torch.device:
        return self.levels[0].device


def tree_on(tree: VocabTree, device: torch.device) -> VocabTree:
    """``tree`` on ``device``: itself when it is there, else a copy -- the
    broadcast of the tree to a mesh's devices."""
    if tree.device == device:
        return tree
    return VocabTree(levels=tuple(lvl.to(device) for lvl in tree.levels))


def child_norms(lvl: torch.Tensor) -> torch.Tensor:
    """(nodes, f) squared norms of a deeper level's children."""
    lf = lvl.float()
    return (lf * lf).sum(-1)


def descend(xf: torch.Tensor, lvl: torch.Tensor, cn: torch.Tensor,
            node: torch.Tensor) -> torch.Tensor:
    """Child path ``node * f + argmin_j (||c_j||^2 - 2 x.c_j)`` over the
    children of each row's ``node``, in chunks of :data:`CHUNK_ROWS`, the
    last one padded to that size: every row's arithmetic is the same
    whatever the number of rows of the call."""
    f = lvl.shape[1]
    out = torch.empty_like(node)
    for s in range(0, xf.shape[0], CHUNK_ROWS):
        x, nd = xf[s:s + CHUNK_ROWS], node[s:s + CHUNK_ROWS]
        m = x.shape[0]
        if m < CHUNK_ROWS:
            x = torch.cat([x, x.new_zeros((CHUNK_ROWS - m, x.shape[1]))])
            nd = torch.cat([nd, nd.new_zeros((CHUNK_ROWS - m,))])
        gathered = lvl[nd].float()  # (CHUNK_ROWS, f, d)
        d2 = cn[nd] - 2.0 * torch.einsum("nd,nfd->nf", x, gathered)
        out[s:s + m] = nd[:m] * f + torch.argmin(d2[:m], dim=1)
    return out


def _segmented_pick(order, starts, counts, fanout, fallback, generator):
    """For each of ``n_nodes`` segments pick ``fanout`` member indices.

    Strided picks inside each segment; empty segments fall back to random
    global indices (the paper picks representatives at random, so a sparse
    branch simply re-samples).
    """
    n_nodes = starts.shape[0]
    j = torch.arange(fanout, device=order.device)
    pos = starts[:, None] + (j[None, :] * counts.clamp(min=1)[:, None]) // fanout
    pos = pos.clamp(0, order.shape[0] - 1)
    picked = order[pos]
    rnd = torch.randint(0, fallback, (n_nodes, fanout),
                        generator=generator).to(order.device)
    return torch.where(counts[:, None] > 0, picked, rnd)


def _assign_level(vf, levels, li, node_of):
    """Node path of every sample row after level ``li``."""
    if li == 0:
        return l2_nearest(vf, levels[0])[0].long()
    return descend(vf, levels[li], child_norms(levels[li]), node_of)


def build_tree(
    vecs,
    fanouts: Sequence[int] = (64, 64),
    *,
    generator: torch.Generator,
    refine_iters: int = 0,
    device: str | torch.device | None = "cuda",
) -> VocabTree:
    """Create the index tree from a (sample of a) descriptor collection.

    Paper-faithful mode (``refine_iters=0``): representatives are random
    picks, hierarchically organised. ``refine_iters>0`` adds Lloyd (k-means)
    sweeps per level. Random draws come from ``generator`` (a CPU
    ``torch.Generator``), so the tree is reproducible from its seed but not
    equal to the JAX package's, whose draws use ``jax.random``.
    """
    dev = resolve(device)
    fanouts = tuple(int(f) for f in fanouts)
    vf = torch.as_tensor(vecs, device=dev).float().contiguous()
    n, d = vf.shape

    # ---- level 0: random roots ------------------------------------------
    if n >= fanouts[0]:
        idx0 = torch.randperm(n, generator=generator)[: fanouts[0]]
    else:
        idx0 = torch.randint(0, n, (fanouts[0],), generator=generator)
    levels = [vf[idx0.to(dev)]]
    node_of = torch.zeros((n,), dtype=torch.int64, device=dev)
    n_nodes = 1

    for li, f in enumerate(fanouts):
        last = li + 1 == len(fanouts)
        # the deepest level's paths are needed only by Lloyd refinement
        if not last or refine_iters:
            node_of = _assign_level(vf, levels, li, node_of)
        n_nodes *= f

        # Lloyd refinement of this level's centroids (optional)
        for _ in range(refine_iters):
            sums = torch.zeros((n_nodes, d), device=dev).index_add_(0, node_of, vf)
            cnts = torch.bincount(node_of, minlength=n_nodes).float()
            means = sums / cnts.clamp(min=1.0)[:, None]
            flat_old = levels[li].reshape(n_nodes, d)
            flat_new = torch.where(cnts[:, None] > 0, means, flat_old)
            levels[li] = flat_new.reshape(levels[li].shape).contiguous()
            # re-assign branch within the (unchanged) parent partition
            node_of = _assign_level(vf, levels, li, node_of // f)

        # ---- pick children of every node for the next level --------------
        if not last:
            order = torch.argsort(node_of, stable=True)
            cnts = torch.bincount(node_of, minlength=n_nodes)
            starts = torch.cumsum(cnts, 0) - cnts
            pick = _segmented_pick(order, starts, cnts, fanouts[li + 1], n,
                                   generator)
            levels.append(vf[pick])  # (n_nodes, fnext, d)

    return VocabTree(levels=tuple(levels))


def tree_assign(tree: VocabTree, x: torch.Tensor) -> torch.Tensor:
    """(n,) int32 leaf id per row of x -- the paper's map-side descriptor
    assignment. Level 0 is the ``l2nn`` kernel; deeper levels gather each
    row's branch children and reduce."""
    xf = x.float().contiguous()
    node = l2_nearest(xf, tree.levels[0])[0].long()
    for lvl in tree.levels[1:]:
        node = descend(xf, lvl, child_norms(lvl), node)
    return node.to(torch.int32)


def leaf_centroids(tree: VocabTree) -> torch.Tensor:
    """(n_leaves, d) flattened deepest-level centroids (for diagnostics)."""
    last = tree.levels[-1]
    return last.reshape(-1, last.shape[-1]) if last.ndim == 3 else last
