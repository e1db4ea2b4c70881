"""Time the dense path's two hand-written kernels, l2topk (K1) and l2nn
(K3), and what they move end to end, for any checkout of the port, so that
two checkouts can be compared on one card.

    python scripts/dense_kernels_ab.py [--src DIR] [--seed S]

``--src`` is the ``src`` directory of the checkout whose port runs (default
this repository's). Everything else is ``chip_smoke.py``'s, from this
checkout: it drives the dense main path at the sift100m deployment's
widths (``run_main_path``), takes the same 64 mid-shard waves
(``dense_waves``), times K1 and K3 on them as the kernel phase does
(``dense_kernel_times``: K1 a real wave, its floor and its busiest wave;
K3 a build wave and tree level 0), traces one dense sweep (``trace_sweep``)
and one more build (``trace_build``), and prints one JSON line of device
ms, device busy s and wall s.

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
    lk = rt.build_lookup(run["tree"], run["queries"], probes=1)
    t = cs.dense_kernel_times(rt, run, sizes, *cs.dense_waves(run, sizes, lk))
    sweep_k1, sweep_busy = cs.trace_sweep(rt, run, sizes)
    tree, times = run["tree"], run["times"]
    del run, lk
    gc.collect()
    torch.cuda.empty_cache()
    build = cs.trace_build(rt, args, dev, sizes, tree, times["build_index"])
    k1_pairs = t["k1_pairs"]
    print(json.dumps({
        "src": args.src,
        "l2nn_wave_ms": t["k3_wave"][0], "l2nn_level0_ms": t["k3_level0"][0],
        "build_wall_s": build["build_wall_s"], "build_busy_s": build["build_busy_s"],
        "build_l2nn_ms": build["build_trace_ms"],
        "build_l2nn_launches": build["build_trace_launches"],
        "l2topk_wave_ms": t["k1_wave"][0], "l2topk_floor_ms": t["k1_floor"][0],
        "l2topk_busiest_wave_ms": t["k1_busiest"][0],
        "busiest_wave_pairs": t["k1_busiest_pairs"],
        "pairs_per_wave": sum(k1_pairs) / len(k1_pairs),
        "sweep_wall_s": times["pallas"], "sweep_busy_s": sweep_busy,
        "sweep_l2topk": {key[:60]: v for key, v in sweep_k1.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
