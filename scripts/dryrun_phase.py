"""Run ``chip_smoke.py``'s dryrun phase alone: the cell registry's
``--list``, the abstract records of all 44 cells on 16x16, 2x16x16 and
the card, the measured records of llama3.2-3b prefill_32k (batch 1) and
decode_32k, gin-tu molecule and sift100m search_32k (each in a process
of its own), and K6 at 32,768 tokens held against its plain version and
timed alone.

    python scripts/dryrun_phase.py [--seed S]

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
        print("dryrun_phase: no CUDA device", file=sys.stderr)
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
    kernels = [dict(name=n) for n in ("flashattn", "segsum", "fusedscan")]
    t0 = time.perf_counter()
    cs.dryrun_phase(rt, args, dev, kernels, t0)
    print(json.dumps(dict(kernels=kernels), default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
