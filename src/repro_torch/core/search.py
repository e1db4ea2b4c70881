"""Batch search (paper section 2.4): plan, build the lookup table, pad,
run the executor, trim.

  * ``batch_search`` -- the entry point (``layout`` point-major,
    query-routed or "auto", multi-probe ``probes=T``, ``impl``
    "xla"/"pallas" for the per-tile scans or "fused" for the whole-shard
    scan);
  * ``search_with_lookup`` -- one executor run over a *pre-built* lookup
    table; with a ``scan_codes`` plan it scans the index's PQ codes and
    returns ``plan.rerank`` approximate candidates per query for
    ``codes.rerank_exact``.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine.executors import (  # noqa: F401
    SearchResult,
    make_executor,
    pad_lookup,
)
from repro_torch.core.engine.plan import SearchPlan, plan as make_plan, round_up
from repro_torch.core.index_build import DistributedIndex
from repro_torch.core.lookup import LookupTable, build_lookup
from repro_torch.core.tree import VocabTree
from repro_torch.device import resolve


def lookup_q_total(p: SearchPlan, n_queries: int, n_shards: int = 1) -> int:
    """Padded lookup-row count an executor for ``p`` needs: query-routed
    rows on the ``(q_tile * n_shards)`` routing grid, point-major rows
    covering the slab budget; a multiple of ``probes`` for the
    probe-group merge either way."""
    q_rows = n_queries * p.probes
    if p.layout == "query_routed":
        return round_up(q_rows, p.q_tile * n_shards * p.probes)
    return round_up(max(q_rows, p.q_cap), p.probes)


def search_with_lookup(index: DistributedIndex, lookup: LookupTable,
                       plan: SearchPlan, *, n_queries: int, codes=None,
                       codebooks=None) -> SearchResult:
    """Run one resolved plan's executor over a pre-built lookup table.

    ``lookup`` is the unpadded ``n_queries * probes``-row table from
    :func:`~repro_torch.core.lookup.build_lookup`; it is padded here to the
    executor's row count. Results are trimmed back to ``n_queries`` rows.

    For a ``scan_codes`` plan, ``codes`` (the index's ``(rows, m)`` uint8
    PQ codes on its device, row-aligned with ``index``) and ``codebooks``
    (the quantizer's ``(m, C, dsub)`` table, numpy or a tensor) are
    required, and the returned tables hold ``plan.rerank`` approximate ADC
    candidates per query -- the caller reranks exactly
    (:func:`repro_torch.codes.rerank_exact`).
    """
    n_shards = index.n_shards
    shard_rows = index.rows // n_shards
    q_total = lookup_q_total(plan, n_queries, n_shards)
    fn = make_executor(plan, n_leaves=index.n_leaves, shard_rows=shard_rows,
                       q_total=q_total, n_shards=n_shards)
    padded = pad_lookup(lookup, q_total)
    if plan.layout == "scan_codes":
        if codes is None or codebooks is None:
            raise ValueError("scan_codes plan needs codes + codebooks")
        res = fn(index, padded, codes,
                 torch.as_tensor(codebooks, device=index.device))
    else:
        res = fn(index, padded)
    return SearchResult(
        ids=res.ids[:n_queries],
        dists=res.dists[:n_queries],
        pairs=res.pairs,
        q_cap_overflow=res.q_cap_overflow,
    )


def batch_search(
    index: DistributedIndex,
    tree: VocabTree,
    queries,
    k: int,
    *,
    layout: str = "point_major",
    probes: int = 1,
    block_rows: int | None = None,
    q_cap: int | None = None,
    impl: str = "xla",
    p_cap: int | None = None,
    device: str | torch.device | None = "cuda",
) -> SearchResult:
    """Plan, build the lookup table, pad, run, trim.

    ``index`` and ``tree`` must live on ``device``; ``queries`` (numpy or a
    tensor) are moved there. ``layout``: ``"point_major"``,
    ``"query_routed"`` or ``"auto"`` (the cost models of
    ``core.engine.costmodel`` pick, from the module's default store);
    ``p_cap`` pins the query-routed point slab.
    ``probes=T`` visits each query's T nearest leaves. ``impl``:
    ``"xla"``/``"pallas"`` scan each wave or query tile through the l2topk
    kernel, ``"fused"`` scans the whole shard through the fusedscan
    kernel, ``"auto"`` lets the cost model pick.
    """
    dev = resolve(device)
    if index.device != dev or tree.device != dev:
        raise ValueError(
            f"index on {index.device}, tree on {tree.device}, search on {dev}")
    queries = torch.as_tensor(queries, device=dev).float().contiguous()
    q = queries.shape[0]
    p = make_plan(
        rows=index.rows, n_leaves=index.n_leaves, n_queries=q,
        n_shards=index.n_shards, k=k, probes=probes, layout=layout, impl=impl,
        block_rows=block_rows, q_cap=q_cap, p_cap=p_cap,
    )
    lookup = build_lookup(tree, queries, probes=probes)
    return search_with_lookup(index, lookup, p, n_queries=q)
