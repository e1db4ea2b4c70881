"""Segment-sum wrapper: the plain version for a CPU tensor, the segsum
CUDA kernel (``csrc/segsum.cu``) for a CUDA tensor, and GIN's
differentiable aggregation over it.

``edge_graph(src, dst, w, n_nodes)`` sorts a graph's edges once (stably,
so each row keeps the edge list's order): by destination for the
forward's sum, by source for its transpose, the backward's. Each order is
a :class:`SegmentCSR`, which also cuts every row into work items of at
most ``SEG_CHUNK`` edges for the kernel (a long row's items write partial
rows, added in item order by a second kernel). ``segment_sum(h, graph)``
is ``jax.ops.segment_sum(h[src] * w[:, None], dst, n_nodes)`` with that
transpose as its backward: no atomics, one order of adds for every output
on the card, so a rerun gives the same bits. Edge weights are data: no
gradient flows to them.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import check_kernel_inputs
from repro_torch.kernels import _build
from repro_torch.kernels.segsum.ref import segsum_ref

SEG_CHUNK = 256  # edges a work item: the kernel's longest serial chain


@dataclasses.dataclass(frozen=True)
class SegmentCSR:
    """Edges sorted by their row: ``indptr`` (n_rows + 1,) int32, ``cols``
    and ``w`` (E,) in that order; ``items`` (I, 4) int32 (row, first edge,
    end, partial slot or -1); ``longs`` (L, 4) int32 (row, first slot,
    slots, 0) for the rows of more than one item."""

    indptr: torch.Tensor
    cols: torch.Tensor
    w: torch.Tensor
    items: torch.Tensor
    longs: torch.Tensor
    n_slots: int

    @property
    def n_rows(self) -> int:
        return self.indptr.shape[0] - 1


@dataclasses.dataclass(frozen=True)
class EdgeGraph:
    """A graph's edges sorted both ways: ``fwd`` by destination (rows are
    destination nodes), ``bwd`` by source."""

    fwd: SegmentCSR
    bwd: SegmentCSR


def segment_csr(keys: torch.Tensor, others: torch.Tensor, w: torch.Tensor,
                n_rows: int, chunk: int = SEG_CHUNK) -> SegmentCSR:
    """The CSR of the edges ``(keys[e] -> others[e], w[e])`` by key (a
    stable sort: each row keeps the edges' order)."""
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
    return SegmentCSR(
        indptr=indptr.int(), cols=others[order].int().contiguous(),
        w=w[order].float().contiguous(),
        items=torch.stack([row, lo, hi, slot], 1).int().contiguous(),
        longs=longs.int().contiguous(), n_slots=int(long_item.sum()))


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
    check_kernel_inputs("segsum", h, csr.cols, csr.w, csr.items, csr.longs,
                        dtypes=(torch.float32, torch.int32, torch.float32,
                                torch.int32, torch.int32))
    d = h.shape[1]
    out = torch.empty((csr.n_rows, d), dtype=torch.float32, device=h.device)
    if csr.n_rows == 0 or d == 0:
        return out.zero_()
    part = torch.empty((max(1, csr.n_slots), d), dtype=torch.float32, device=h.device)
    _build.launch("segsum_launch", h,
                  h.data_ptr(), csr.cols.data_ptr(), csr.w.data_ptr(),
                  csr.items.data_ptr(), csr.longs.data_ptr(), out.data_ptr(),
                  part.data_ptr(), csr.items.shape[0], csr.longs.shape[0], d)
    _build.count(segsum, h)
    return out


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
