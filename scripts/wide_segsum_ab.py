"""Time the wide scan calls and segsum for any checkout of the port, so that
two checkouts can be compared on one card: K1 (l2topk) on the dense
sweep's waves and K2 (fusedscan) on the fused call at k = 100, K4
(adcscan) on the codes sweep's waves and K5 (fusedadc) on the fused codes
call at rerank 256 (``chip_smoke.py``'s P7 shapes), each beside the same
kernel at the main path's own k = 20 / rerank 128, and the wave sweeps'
walls (``batch_search`` and the codes search on the pallas path, three
synchronised calls each, the host's work included) at both; then segsum at
ogb_products' layer (2,449,152 rows, 61,859,840 edges, d 64), the
forward's and the backward's order, with one traced call of each (the
items pass and the long rows' pass apart; where the port has them, each
pass also timed alone with CUDA events), and the forward at d 100
(ogb_products' input width, layer 0's aggregation).

    python scripts/wide_segsum_ab.py [--src DIR] [--seed S]

``--src`` is the ``src`` directory of the checkout whose port runs (default
this repository's). Everything else is ``chip_smoke.py``'s, from this
checkout: the dense main path at the sift100m deployment's widths
(``run_main_path``), its 64 mid-shard waves (``dense_waves``), the fused
call (``fused_inputs``), the codes path (``run_codes_path``,
``codes_inputs``), gin-tu's ogb_products batch (``rs_gin_batch``). Prints
the card's name and power limit, then one JSON line: device ms, and the
sweeps' walls in s.

Run it for two checkouts in turns in one call (parent, change, change,
parent): ``git archive`` the parent into ``build/parent`` (git-ignored).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def walls(cs, fn, n: int = 3) -> list:
    """``n`` synchronised walls (s) of ``fn()``, the host's work included."""
    out = []
    for _ in range(n):
        t0 = cs.sync_now()
        fn()
        out.append(cs.sync_now() - t0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wide_segsum_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    dev, sizes = torch.device("cuda"), cs.SIZES
    rt = cs.Port(args.src)
    out = {"src": args.src, "card": smi.splitlines()[0]}

    # --- dense: K1 on the sweep's waves, K2 on the fused call ---
    run = cs.run_main_path(rt, args, dev, sizes)
    lk = rt.build_lookup(run["tree"], run["queries"], probes=1)
    waves, _ = cs.dense_waves(run, sizes, lk)
    pairs = [int(rt.count_pairs(w[1], w[3])) for w in waves]
    top = waves[max(range(len(pairs)), key=pairs.__getitem__)]
    full = cs.fused_inputs(rt, run, sizes, lk)[1]
    for k in (sizes["k"], cs.P7_K):
        out[f"l2topk_k{k}_ms"] = cs.time_ms(lambda *w, k=k: rt.l2_topk(*w, k=k),
                                            waves)[0]
        out[f"l2topk_k{k}_busiest_ms"] = cs.time_ms(
            lambda *w, k=k: rt.l2_topk(*w, k=k), [top] * 20)[0]
        out[f"fusedscan_k{k}_ms"] = cs.fused_time(rt, full, k)[0]
    del full, lk, waves, top
    index, tree, queries = run["index"], run["tree"], run["queries"]
    B, qc = sizes["block_rows"], sizes["q_cap"]
    for k in (sizes["k"], cs.P7_K):  # the wave sweep's wall, host included
        out[f"sweep_k{k}_wall_s"] = walls(cs, lambda k=k: rt.batch_search(
            index, tree, queries, k, q_cap=qc, block_rows=B, impl="pallas",
            device=dev))

    # --- codes: K4 on the codes sweep's waves, K5 on the fused call ---
    cs.run_codes_path(rt, run, sizes)
    ci = cs.codes_inputs(rt, run, sizes)
    pq = run["codes"]["pq"]
    for r in (run["codes"]["results"]["pallas"]["plan"].rerank, cs.P7_RERANK):
        out[f"adcscan_r{r}_ms"] = cs.k4_time(rt, ci, r)[0]
        out[f"fusedadc_r{r}_ms"] = cs.k5_time(rt, ci, r)[0]
        plan = rt.make_plan(
            rows=index.rows, n_leaves=index.n_leaves, n_queries=queries.shape[0],
            n_shards=1, k=sizes["k"], probes=1, layout="scan_codes", impl="pallas",
            q_cap=qc, block_rows=B, code_m=pq.m, code_bits=pq.bits, rerank=r)
        out[f"codes_sweep_r{r}_wall_s"] = walls(cs, lambda plan=plan: (
            rt.search_with_lookup(index, rt.build_lookup(tree, queries, probes=1),
                                  plan, n_queries=queries.shape[0],
                                  codes=run["codes"]["codes"],
                                  codebooks=pq.codebooks)))
    del ci, run
    gc.collect()
    torch.cuda.empty_cache()

    # --- segsum at ogb_products' layer, both orders ---
    batch, _ = cs.rs_gin_batch(rt, "ogb_products", args.seed, dev)
    graph = batch["graph"]
    n = graph.fwd.n_rows
    h = torch.randn((n, 64), generator=torch.Generator(device=dev).manual_seed(
        args.seed + 41), device=dev)
    for name, csr in (("fwd", graph.fwd), ("bwd", graph.bwd)):
        out[f"segsum_{name}_ms"] = cs.time_ms(lambda hh, c=csr: rt.segsum(hh, c),
                                              [(h,)] * 5)[0]
        if hasattr(rt.segsum_ops, "tree_pass"):  # the passes apart, CUDA events
            o, part = rt.segsum_ops.items_pass(h, csr)
            out[f"segsum_{name}_items_pass_ms"] = cs.time_ms(
                lambda hh, c=csr: rt.segsum_ops.items_pass(hh, c), [(h,)] * 5)[0]
            out[f"segsum_{name}_tree_pass_ms"] = cs.time_ms(
                lambda c=csr: rt.segsum_ops.tree_pass(part, o, c), [()] * 20)[0]
            del o, part
        ev, busy = cs.device_trace(lambda c=csr: rt.segsum(h, c))
        for key in ("items", "long", "tree"):
            hit = [e for e in ev if f"segsum_{key}" in e.key]
            if hit:
                out[f"segsum_{name}_{key}_ms"] = sum(
                    e.self_device_time_total for e in hit) / 1e3
                out[f"segsum_{name}_{key}_launches"] = sum(e.count for e in hit)
    # the forward at ogb_products' input width (layer 0's aggregation)
    h100 = torch.randn((n, 100), generator=torch.Generator(device=dev).manual_seed(
        args.seed + 42), device=dev)
    out["segsum_fwd_d100_ms"] = cs.time_ms(lambda hh: rt.segsum(hh, graph.fwd),
                                           [(h100,)] * 5)[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
