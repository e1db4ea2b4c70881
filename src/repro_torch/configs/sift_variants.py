"""Hill-climb variants of the paper's own architecture (sift100m): the JAX
package's ``configs/sift_variants.py``.

The port's ``DeviceMesh`` is already flat: one axis of shards, one a card
(``local_mesh()``), with no model axis left idle. So ``flat_mesh`` and
``query_routed_flat`` are the baselines over every shard of
``local_mesh()``; what they change is the reference's layouts, where rows
shard over every mesh axis (``FLAT_RULES``) and each shard's slice of the
index shrinks accordingly.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import sift100m as s
from repro_torch.configs.base import Cell


def make_routed_search_cell(shape_name: str, q_total: int, *, q_tile: int,
                            p_cap: int, flat_mesh: bool = False) -> Cell:
    """The query-routed executor (``layout="query_routed"``, K1 on each
    query tile) over the baseline's index and lookup."""
    rules = s.FLAT_RULES if flat_mesh else s.DEFAULT_RULES
    q_cap = {s.SEARCH_1M["q_total"]: s.SEARCH_1M["q_cap"],
             s.SEARCH_32K["q_total"]: s.SEARCH_32K["q_cap"]}[q_total]
    base = s.make_search_cell(shape_name, q_total, q_cap)

    def args_fn(rows, layout, on_card):
        dtype = torch.float32 if on_card else torch.bfloat16
        return (s.index_args(layout, rows, rules, dtype=dtype), s.lookup_args(q_total))

    def build_fn(dev, rows, seed):
        from repro_torch.core.engine import SearchPlan
        from repro_torch.core.search import search_with_lookup

        _, (index, lookup) = base.build_fn(dev, rows, seed)
        plan = SearchPlan(layout="query_routed", k=s.K, impl="xla", q_tile=q_tile,
                          p_cap=p_cap)

        def fn(index, lookup):
            return search_with_lookup(index, lookup, plan, n_queries=q_total)

        return fn, (index, lookup)

    return dataclasses.replace(base, args_fn=args_fn, build_fn=build_fn, rules=rules)


def make_flat_index_cell() -> Cell:
    """index_wave over all mesh axes (the paper's cluster is flat; leaving
    the model axis idle replicates the whole job 16x per pod)."""
    return s.make_index_cell(rules=s.FLAT_RULES)


def apply(name: str, arch: str, shape: str) -> Cell:
    if arch != "sift100m":
        raise KeyError(f"unknown variant {name} for {arch}")
    if name in ("query_routed", "query_routed_flat"):
        q_total = {"search_1m": 2**20, "search_32k": 2**15}[shape]
        return make_routed_search_cell(shape, q_total, q_tile=512, p_cap=8192,
                                       flat_mesh=name == "query_routed_flat")
    if name == "flat_mesh":
        return make_flat_index_cell()
    raise KeyError(f"unknown variant {name}")
