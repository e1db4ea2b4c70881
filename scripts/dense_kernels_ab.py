"""Time the search paths' hand-written kernels and what they move end to
end, for any checkout of the port, so that two checkouts can be compared on
one card: l2topk (K1), fusedscan (K2), l2nn (K3), adcscan (K4), fusedadc
(K5), and flashattn (K6) at the gemma3-4b prefill's layer-5 shape.

    python scripts/dense_kernels_ab.py [--src DIR] [--seed S]

``--src`` is the ``src`` directory of the checkout whose port runs (default
this repository's). Everything else is ``chip_smoke.py``'s, from this
checkout: it drives the dense main path at the sift100m deployment's
widths (``run_main_path``), takes the same 64 mid-shard waves
(``dense_waves``), times K1 and K3 on them as the kernel phase does
(``dense_kernel_times``: K1 a real wave, its floor and its busiest wave;
K3 a build wave and tree level 0), K2 on the main path's fused call
(``fused_inputs``, ``fused_time``), traces one dense sweep over the
index's first eighth (``trace_sweep``) and one fused dense search at probes 1 and 2, runs the
codes path (``run_codes_path``: PQ train, encode, three searches), times
K4 a real codes wave and K5 the fused codes call (``codes_inputs``,
``k4_time``, ``k5_time``), traces the fused codes search at probes 1 and
2, times K6 on random bf16 q, k, v of layer 5's shape (B 4, S 2048, 8 over
4 heads, hd 256, causal), traces one more build (``trace_build``), and
prints one JSON line of device ms, device busy s and wall s.

Run it for two checkouts in turns in one call (parent, change, change,
parent). Needs a CUDA device; prints the card first.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dense_kernels_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    dev, sizes = torch.device("cuda"), cs.SIZES
    rt = cs.Port(args.src)
    run = cs.run_main_path(rt, args, dev, sizes)
    index, tree, queries = run["index"], run["tree"], run["queries"]
    lk = rt.build_lookup(tree, queries, probes=1)
    t = cs.dense_kernel_times(rt, run, sizes, *cs.dense_waves(run, sizes, lk))
    full = cs.fused_inputs(rt, run, sizes, lk)[1]
    k2 = cs.fused_time(rt, full, sizes["k"])
    del full, lk
    sweep_k1, sweep_busy, sweep_wall, sweep_waves = cs.trace_sweep(rt, run, sizes)
    out = {"src": args.src}

    def traced(name, fn, kernels):
        ev, busy = cs.device_trace(fn)
        out[f"{name}_busy_s"] = busy
        out[f"{name}_kernel_ms"] = sum(e.self_device_time_total for e in ev
                                       if any(x in e.key for x in kernels)) / 1e3

    for probes in (1, 2):
        traced(f"fused_p{probes}", lambda: rt.batch_search(
            index, tree, queries, sizes["k"], probes=probes, q_cap=sizes["q_cap"],
            block_rows=sizes["block_rows"], impl="fused", device=dev), ("fusedscan",))
    cs.run_codes_path(rt, run, sizes)
    codes = run["codes"]
    r = codes["results"]["pallas"]["plan"].rerank
    ci = cs.codes_inputs(rt, run, sizes)
    k4, k5 = cs.k4_time(rt, ci, r), cs.k5_time(rt, ci, r)
    del ci
    for probes, key in ((1, "fused"), (2, "fused_p2")):
        plan = codes["results"][key]["plan"]
        traced(f"codes_fused_p{probes}", lambda: rt.search_with_lookup(
            index, rt.build_lookup(tree, queries, probes=probes), plan,
            n_queries=queries.shape[0], codes=codes["codes"],
            codebooks=codes["pq"].codebooks), ("fusedadc", "adcscan"))
    g = torch.Generator(device=dev).manual_seed(args.seed)
    q, k, v = (torch.randn((4, 2048, h, 256), generator=g, device=dev,
                           dtype=torch.bfloat16) for h in (8, 4, 4))
    k6 = cs.time_ms(lambda q, k, v: rt.flash_attention(q, k, v),
                    [(q, k, v)] * 50)
    del q, k, v
    times = run["times"]
    code_times = codes["times"]
    del run, codes, index, queries
    gc.collect()
    torch.cuda.empty_cache()
    build = cs.trace_build(rt, args, dev, sizes, tree, times["build_index"])
    k1_pairs = t["k1_pairs"]
    out.update({
        "l2nn_wave_ms": t["k3_wave"][0], "l2nn_level0_ms": t["k3_level0"][0],
        "build_wall_s": build["build_wall_s"], "build_busy_s": build["build_busy_s"],
        "build_l2nn_ms": build["build_trace_ms"],
        "build_l2nn_launches": build["build_trace_launches"],
        "l2topk_wave_ms": t["k1_wave"][0], "l2topk_floor_ms": t["k1_floor"][0],
        "l2topk_busiest_wave_ms": t["k1_busiest"][0],
        "busiest_wave_pairs": t["k1_busiest_pairs"],
        "pairs_per_wave": sum(k1_pairs) / len(k1_pairs),
        "sweep_wall_s": times["pallas"], "traced_sweep_waves": sweep_waves,
        "traced_sweep_wall_s": sweep_wall, "traced_sweep_busy_s": sweep_busy,
        "sweep_l2topk": {key[:60]: val for key, val in sweep_k1.items()},
        "fusedscan_ms": k2[0], "fused_wall_s": times["fused"],
        "fused_p2_wall_s": times["fused_p2"],
        "adcscan_wave_ms": k4[0], "fusedadc_ms": k5[0],
        "codes_fused_wall_s": code_times["fused"],
        "codes_fused_p2_wall_s": code_times["fused_p2"],
        "flashattn_layer5_ms": k6[0]})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
