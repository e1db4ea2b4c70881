"""Segment-sum wrapper: the plain version for a CPU tensor, the segsum
CUDA kernel (``csrc/segsum.cu``) for a CUDA tensor, and GIN's
differentiable aggregation over it.

``edge_graph(src, dst, w, n_nodes)`` sorts a graph's edges once (stably,
so each row keeps the edge list's order): by destination for the
forward's sum, by source for its transpose, the backward's. Each order is
a :class:`SegmentCSR`, which also cuts every row into work items of at
most ``SEG_CHUNK`` edges for the kernel (a long row's items write partial
rows) and plans the tree that adds a long row's partial rows: groups of up
to ``SEG_GROUP`` consecutive nodes, each summed in order into a node of the
next level, until one node, the row's output, remains. Its shape depends on
the row's partial count alone (:func:`tree_plan`); each level is one launch
of a second kernel over every long row's groups. ``segment_sum(h, graph)``
is ``jax.ops.segment_sum(h[src] * w[:, None], dst, n_nodes)`` with that
transpose as its backward: no atomics, one order of adds for every output
on the card, so a rerun gives the same bits. Edge weights are data: no
gradient flows to them.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.device import check_kernel_inputs
from repro_torch.kernels import _build
from repro_torch.kernels.segsum.ref import segsum_ref

SEG_CHUNK = 256  # edges a work item: the kernel's longest serial chain
SEG_GROUP = 32  # nodes of the long rows' tree that one warp adds in order


@dataclasses.dataclass(frozen=True)
class SegmentCSR:
    """Edges sorted by their row: ``indptr`` (n_rows + 1,) int32, ``cols``
    and ``w`` (E,) in that order; ``items`` (I, 4) int32 (row, first edge,
    end, partial slot or -1); ``longs`` (L, 4) int32 (row, first slot,
    slots, 0) for the rows of more than one item, whose ``n_slots``
    partial rows come first in a buffer of ``part_rows``; ``tree`` (T, 4)
    int32 (destination, first source, count, 0), the tree's groups level by
    level (level i is ``tree[tree_levels[i]:tree_levels[i + 1]]``): each
    adds ``count`` partial rows from the first source in order into a
    partial row (destination >= 0) or output row ``-destination - 1``."""

    indptr: torch.Tensor
    cols: torch.Tensor
    w: torch.Tensor
    items: torch.Tensor
    longs: torch.Tensor
    n_slots: int
    tree: torch.Tensor
    tree_levels: tuple
    part_rows: int

    @property
    def n_rows(self) -> int:
        return self.indptr.shape[0] - 1


@dataclasses.dataclass(frozen=True)
class EdgeGraph:
    """A graph's edges sorted both ways: ``fwd`` by destination (rows are
    destination nodes), ``bwd`` by source."""

    fwd: SegmentCSR
    bwd: SegmentCSR


def tree_plan(rows: torch.Tensor, first: torch.Tensor, n: torch.Tensor,
              free: int, group: int = SEG_GROUP):
    """The groups that add each long row's ``n`` partial rows (slots
    ``first ..``) into its output row ``rows``: level by level, node i of
    the next level sums the current level's nodes ``i * group ..`` (up to
    ``group`` of them, in order), its own slot allocated from ``free`` on,
    until a row has one node left, which its last group writes to the
    output. A row's groups (their counts, and which nodes feed which)
    depend on its ``n`` alone. Returns (groups (T, 4) int32 as
    ``SegmentCSR.tree``, level offsets, partial rows in all)."""
    dev = rows.device
    rows, first, n = rows.long(), first.long(), n.long()
    levels, offsets = [], [0]
    while rows.numel():
        g = (n + group - 1) // group  # this level's groups of each row
        row_of = torch.repeat_interleave(torch.arange(rows.numel(), device=dev), g)
        start = torch.cumsum(g, 0) - g
        t = torch.arange(row_of.numel(), device=dev) - start[row_of]
        last = g[row_of] == 1  # the row's one group: into its output row
        slot = free + torch.cumsum(~last, 0) - 1
        dst = torch.where(last, -rows[row_of] - 1, slot)
        cnt = torch.minimum(n[row_of] - t * group, torch.full_like(t, group))
        levels.append(torch.stack([dst, first[row_of] + t * group, cnt,
                                   torch.zeros_like(t)], 1))
        offsets.append(offsets[-1] + row_of.numel())
        more = g > 1
        free += int((~last).sum())
        rows, first, n = rows[more], slot[start[more]], g[more]
    tree = (torch.cat(levels) if levels
            else torch.zeros((0, 4), dtype=torch.long, device=dev))
    return tree.int().contiguous(), tuple(offsets), free


def segment_csr(keys: torch.Tensor, others: torch.Tensor, w: torch.Tensor,
                n_rows: int, chunk: int = SEG_CHUNK,
                group: int = SEG_GROUP) -> SegmentCSR:
    """The CSR of the edges ``(keys[e] -> others[e], w[e])`` by key (a
    stable sort: each row keeps the edges' order), its work items and the
    tree that adds its long rows' partial rows (:func:`tree_plan`)."""
    dev = keys.device
    keys = keys.long()
    order = torch.sort(keys, stable=True).indices
    counts = torch.bincount(keys, minlength=n_rows)
    ends = torch.cumsum(counts, 0)
    indptr = torch.cat([ends.new_zeros(1), ends])
    n_chunks = torch.clamp((counts + chunk - 1) // chunk, min=1)
    row = torch.repeat_interleave(torch.arange(n_rows, device=dev), n_chunks)
    first_item = torch.cumsum(n_chunks, 0) - n_chunks
    k = torch.arange(row.shape[0], device=dev) - first_item[row]
    lo = indptr[row] + k * chunk
    hi = torch.minimum(lo + chunk, indptr[row + 1])
    is_long = n_chunks > 1
    long_item = is_long[row]
    slot = torch.where(long_item, torch.cumsum(long_item, 0) - 1, -1)
    long_rows = torch.nonzero(is_long).flatten()
    longs = torch.stack([long_rows, slot[first_item[long_rows]],
                         n_chunks[long_rows], torch.zeros_like(long_rows)], 1)
    n_slots = int(long_item.sum())
    tree, levels, part_rows = tree_plan(longs[:, 0], longs[:, 1], longs[:, 2],
                                        n_slots, group)
    return SegmentCSR(
        indptr=indptr.int(), cols=others[order].int().contiguous(),
        w=w[order].float().contiguous(),
        items=torch.stack([row, lo, hi, slot], 1).int().contiguous(),
        longs=longs.int().contiguous(), n_slots=n_slots, tree=tree,
        tree_levels=levels, part_rows=part_rows)


def edge_graph(src, dst, w, n_nodes: int) -> EdgeGraph:
    """Both sorted orders of the edge list ``src -> dst`` with weights
    ``w`` (all (E,), on one device)."""
    if w.requires_grad:
        raise ValueError("edge_graph: edge weights take no gradient")
    return EdgeGraph(fwd=segment_csr(dst, src, w, n_nodes),
                     bwd=segment_csr(src, dst, w, n_nodes))


def segsum(h: torch.Tensor, csr: SegmentCSR) -> torch.Tensor:
    """(n_rows, d) float32: each row's edges' ``w * h[col]`` summed; see
    ref.py."""
    if h.device.type == "cpu":
        return segsum_ref(h, csr.indptr, csr.cols, csr.w)
    if h.device.type != "cuda":
        raise ValueError(f"segsum: unsupported device {h.device}")
    check_kernel_inputs("segsum", h, csr.cols, csr.w, csr.items, csr.tree,
                        dtypes=(torch.float32, torch.int32, torch.float32,
                                torch.int32, torch.int32))
    if csr.n_rows == 0 or h.shape[1] == 0:
        return torch.zeros((csr.n_rows, h.shape[1]), dtype=torch.float32,
                           device=h.device)
    out, part = items_pass(h, csr)
    tree_pass(part, out, csr)
    _build.count(segsum, h)
    return out


def items_pass(h: torch.Tensor, csr: SegmentCSR):
    """The kernel's first pass on the card: (out, part), every row of one
    item summed into ``out``, every long row's items into their partial
    rows of ``part``. :func:`segsum` runs it, then :func:`tree_pass`; each
    is callable alone to time it."""
    d = h.shape[1]
    out = torch.empty((csr.n_rows, d), dtype=torch.float32, device=h.device)
    part = torch.empty((max(1, csr.part_rows), d), dtype=torch.float32,
                       device=h.device)
    _build.launch("segsum_items_launch", h,
                  h.data_ptr(), csr.cols.data_ptr(), csr.w.data_ptr(),
                  csr.items.data_ptr(), out.data_ptr(), part.data_ptr(),
                  csr.items.shape[0], d)
    return out, part


def tree_pass(part: torch.Tensor, out: torch.Tensor, csr: SegmentCSR) -> None:
    """The kernel's second pass on the card: the long rows' partial rows
    (``part``, as :func:`items_pass` left them) added by ``csr.tree``, one
    launch a level, into their rows of ``out``. It reads only partial rows
    and writes each row once, so a repeat writes the same bits."""
    n_levels = len(csr.tree_levels) - 1
    if n_levels < 1:
        return
    levels = (ctypes.c_longlong * len(csr.tree_levels))(*csr.tree_levels)
    _build.launch("segsum_tree_launch", part,
                  part.data_ptr(), csr.tree.data_ptr(), levels, out.data_ptr(),
                  n_levels, out.shape[1])


class SegmentSum(torch.autograd.Function):
    """``segsum`` over ``graph.fwd``; its gradient is ``segsum`` of the
    output gradient over ``graph.bwd`` (the transpose)."""

    @staticmethod
    def forward(ctx, h, graph):
        ctx.graph = graph
        return segsum(h.contiguous(), graph.fwd)

    @staticmethod
    def backward(ctx, g):
        return segsum(g.contiguous(), ctx.graph.bwd), None


def segment_sum(h: torch.Tensor, graph: EdgeGraph) -> torch.Tensor:
    """Sum of ``w * h[src]`` into each destination row, differentiable in
    ``h``."""
    return SegmentSum.apply(h, graph)


_build.counters(segsum)
