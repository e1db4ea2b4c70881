"""Run ``chip_smoke.py``'s MoE phase alone, then its examples phase:
moonshot-v1-16b-a3b at full width on one card, timed at full depth and
checked at 8 layers (chunked against full attention, decode against
forward, routed against global dispatch over four shards of the card,
layer 0's experts against float64, K6 at hd 128), then the port's
quickstart and Copydays examples as subprocesses.

    python scripts/moe_phase.py [--seed S] [--no-examples]

Prints the card, the phases' lines and one JSON line of their numbers
last. Needs a CUDA device.
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
    ap.add_argument("--no-examples", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("moe_phase: no CUDA device", file=sys.stderr)
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
    kernels = [dict(name="flashattn", max_abs_err=0.0)]
    stats = cs.moe_phase(rt, args, dev, kernels, time.perf_counter())
    out = dict(moe=stats)
    if not args.no_examples:
        out["examples"] = cs.examples_phase(dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
