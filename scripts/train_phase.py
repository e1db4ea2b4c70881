"""Run ``chip_smoke.py``'s train phase alone: internlm2-1.8b at full width
and depth trained on one card (the ``train_4k`` step cut to 4 sequences of
4096 tokens in 2 microbatches, K6's forward and kernel backward in every
layer), with its checks (a)-(e) and the K6 backward's timing.

    python scripts/train_phase.py [--seed S]

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
        print("train_phase: no CUDA device", file=sys.stderr)
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
    stats = cs.train_phase(rt, args, dev, kernels, time.perf_counter())
    print(json.dumps(dict(train=stats, kernels=kernels), default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
