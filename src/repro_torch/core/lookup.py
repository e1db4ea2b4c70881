"""Query lookup table (paper section 2.4, step 1).

All query descriptors of a batch are assigned to their leaf cluster by
traversing the index tree, then reordered by leaf id; a CSR offset array per
leaf lets any index block find which query descriptors meet a given
cluster. The table is the broadcast auxiliary data of the search phase.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.distance import sq_norms, topk_lex
from repro_torch.core.sentinels import PAD_QUERY_LEAF
from repro_torch.core.tree import VocabTree, child_norms, descend, tree_assign
from repro_torch.kernels.l2nn.ops import l2_nearest

# Queries per beam-descent chunk in probe_leaves (bounds the gathered
# (rows, beam, f, d) children). Every chunk runs at exactly this many rows
# (the last one padded): the beam's products, like tree level 1's
# (``core/tree.py``, ``CHUNK_ROWS``), would otherwise sum in an order
# cuBLAS picks by the row count, and a real-valued query's probes would
# depend on how many queries share its call.
PROBE_CHUNK = 4096


@dataclasses.dataclass
class LookupTable:
    vecs: torch.Tensor  # (Q, d) query descriptors, sorted by leaf id
    qids: torch.Tensor  # (Q,) original query row ids (permutation)
    leaves: torch.Tensor  # (Q,) leaf id per sorted query
    offsets: torch.Tensor  # (n_leaves + 1,) CSR start offsets into vecs

    @property
    def n_queries(self) -> int:
        return self.vecs.shape[0]

    @property
    def n_leaves(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def nbytes(self) -> int:
        return sum(
            a.numel() * a.element_size()
            for a in (self.vecs, self.qids, self.leaves, self.offsets)
        )


def _probe_chunk(tree: VocabTree, qf: torch.Tensor, probes: int) -> torch.Tensor:
    n_q = qf.shape[0]
    roots = tree.levels[0].float()
    d2 = sq_norms(roots)[None, :] - 2.0 * (qf @ roots.T)  # (Q, f0)
    # the greedy chain is tree_assign's own arithmetic (l2nn, then descend)
    greedy = l2_nearest(qf, tree.levels[0])[0].long()
    _, nodes = topk_lex(d2, min(probes, roots.shape[0]))
    has = (nodes == greedy[:, None]).any(dim=1)
    nodes[:, -1] = torch.where(has, nodes[:, -1], greedy)
    for lvl in tree.levels[1:]:
        f = lvl.shape[1]
        lf = lvl.float()
        cn = child_norms(lf)  # (nodes, f)
        gathered = lf[nodes]  # (Q, B, f, d)
        d2 = cn[nodes] - 2.0 * torch.einsum("qd,qbfd->qbf", qf, gathered)
        cand = nodes[:, :, None] * f + torch.arange(f, device=qf.device)
        _, sel = topk_lex(d2.reshape(n_q, -1), min(probes, cand[0].numel()))
        nodes = torch.gather(cand.reshape(n_q, -1), 1, sel)
        # advance the greedy chain and force it into the beam (it can fall
        # out: beam score is centroid distance, which is not monotone down
        # the hierarchy) -- replace the worst slot when missing
        greedy = descend(qf, lvl, cn, greedy)
        has = (nodes == greedy[:, None]).any(dim=1)
        nodes[:, -1] = torch.where(has, nodes[:, -1], greedy)
    # pin the hard assignment (== greedy chain) to rank 0, keep the rest in
    # beam (ascending-distance) order
    is_primary = nodes == greedy[:, None]
    rank = torch.where(is_primary, -1,
                       torch.arange(nodes.shape[1], device=qf.device))
    order = torch.argsort(rank, dim=1, stable=True)
    return torch.gather(nodes, 1, order).to(torch.int32)


def probe_leaves(tree: VocabTree, queries: torch.Tensor, probes: int) -> torch.Tensor:
    """(Q, probes) int32 leaves per query: the hierarchical assignment
    first, then the next-nearest leaves (multi-probe soft assignment).

    Beam descent, not a dense scan over all leaves: each level keeps the
    ``probes`` nearest nodes among the beam's children. Column 0 is exactly
    ``tree_assign``: the greedy chain is kept in the beam and pinned to
    rank 0, so ``probes=1`` reproduces the hard assignment and widening
    ``probes`` only ever adds visited leaves.
    """
    if probes == 1:
        return tree_assign(tree, queries)[:, None]
    qf = queries.float().contiguous()
    out = []
    for s in range(0, qf.shape[0], PROBE_CHUNK):
        q = qf[s:s + PROBE_CHUNK]
        m = q.shape[0]
        if m < PROBE_CHUNK:
            q = torch.cat([q, q.new_zeros((PROBE_CHUNK - m, q.shape[1]))])
        out.append(_probe_chunk(tree, q, probes)[:m])
    return torch.cat(out)


def build_lookup(tree: VocabTree, queries: torch.Tensor, *,
                 probes: int = 1) -> LookupTable:
    """Assign queries to their ``probes`` nearest leaves and build the CSR
    table of ``Q * probes`` leaf-sorted rows. With multi-probe, ``qids``
    hold *flat merge slots* ``query_id * probes + probe_rank``.

    Raises:
      ValueError: ``probes < 1`` or ``probes > tree.n_leaves``.
    """
    if probes < 1:
        raise ValueError(f"{probes=} must be >= 1")
    if probes > tree.n_leaves:
        raise ValueError(f"{probes=} must be <= n_leaves={tree.n_leaves}")
    leaves = probe_leaves(tree, queries, probes)
    return lookup_from_leaves(queries, leaves, n_leaves=tree.n_leaves)


def lookup_from_leaves(
    queries: torch.Tensor,
    leaves: torch.Tensor,
    *,
    n_leaves: int,
    n_valid: int | None = None,
    q_total: int | None = None,
) -> LookupTable:
    """Build a :class:`LookupTable` from precomputed ``(Q, probes)`` probe
    leaves at a fixed output shape.

    Rows ``>= n_valid`` get :data:`PAD_QUERY_LEAF` and never match a point.
    ``q_total`` appends tail pad rows (fresh flat slots past the real ones).
    Real rows are stably sorted by leaf.
    """
    q, probes = leaves.shape
    q_rows = q * probes
    if q_total is None:
        q_total = q_rows
    if q_total < q_rows or q_total % probes:
        raise ValueError(
            f"{q_total=} must be >= {q_rows} and a multiple of {probes=}"
        )
    dev = leaves.device
    if n_valid is None:
        n_valid = q
    valid = torch.arange(q, device=dev) < n_valid
    leaves = torch.where(valid[:, None], leaves, PAD_QUERY_LEAF).reshape(-1)
    vecs = torch.repeat_interleave(queries, probes, dim=0) if probes > 1 else queries
    order = torch.argsort(leaves, stable=True)
    sorted_leaves = leaves[order].to(torch.int32)
    offsets = torch.searchsorted(
        sorted_leaves, torch.arange(n_leaves + 1, dtype=torch.int32, device=dev)
    ).to(torch.int32)
    pad = q_total - q_rows
    svecs = vecs[order]
    qids = order.to(torch.int32)
    if pad:
        svecs = torch.cat([svecs, svecs.new_zeros((pad, svecs.shape[1]))])
        qids = torch.cat([qids, torch.arange(q_rows, q_total, dtype=torch.int32,
                                             device=dev)])
        sorted_leaves = torch.cat([
            sorted_leaves,
            torch.full((pad,), PAD_QUERY_LEAF, dtype=torch.int32, device=dev)])
    return LookupTable(vecs=svecs, qids=qids, leaves=sorted_leaves,
                       offsets=offsets)


def build_lookup_bucketed(
    tree: VocabTree,
    queries: torch.Tensor,
    n_valid: int,
    *,
    probes: int = 1,
    q_total: int | None = None,
) -> tuple[LookupTable, torch.Tensor]:
    """Bucket-shaped :func:`build_lookup`: queries padded to a bucket size,
    ``n_valid`` masks the tail. Returns the table plus the ``(Q, probes)``
    probe-leaf matrix."""
    leaves = probe_leaves(tree, queries, probes)
    lk = lookup_from_leaves(
        queries, leaves, n_leaves=tree.n_leaves, n_valid=n_valid,
        q_total=q_total,
    )
    return lk, leaves
