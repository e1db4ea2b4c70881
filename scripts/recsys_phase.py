"""Run ``chip_smoke.py``'s recsys phase alone: DLRM-rm2, DIN, DIEN and
two-tower at full width over their four shapes (serve_p99, serve_bulk,
retrieval_cand, train_batch), two-tower's 1M candidates through the
vocabulary-tree index (K1, K2, K3 at d = 256), and GIN-tu at its four
shapes (the segsum kernel), with checks (a)-(e); each line also carries
the device time and top ops of one traced call (``chip_smoke.py`` leaves
them out).

    python scripts/recsys_phase.py [--seed S]

Prints the card, the phase's lines and one JSON line of its numbers last.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("recsys_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    for line in smi.splitlines():
        print(line, flush=True)
    dev = torch.device("cuda", 0)
    rt = cs.Port()
    rt.build.lib()
    name = None
    for line in rt.build.ptxas_report.splitlines():  # registers, spills
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("Used" in line or "spill" in line):
            cs.log(f"ptxas {name}: {line.split(':', 1)[-1].strip()}")
    kernels = [dict(name=n) for n in ("l2topk", "fusedscan", "l2nn")]
    cs.RS_TRACES = True  # alone, the profiler's traces hold the phase's device time
    stats = cs.recsys_phase(rt, args, dev, kernels, time.perf_counter())
    print(json.dumps(dict(recsys=stats, kernels=kernels), default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
