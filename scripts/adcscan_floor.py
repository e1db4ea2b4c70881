"""Split the adcscan kernel's (K4) time on one codes wave into its launch
and empty-list floor and the scan of the rows the wave's lookup rows match.

    python scripts/adcscan_floor.py [--src DIR] [--waves N] [--seed S]

Builds ``--waves`` synthetic waves shaped like the main path's codes sweep
(``chip_smoke.py``: 4,096 leaf-sorted rows of m = 8 uint8 codes in runs of
about 256 rows a leaf, a 1,024-row lookup slab whose sorted leaves spread
over about 2,000 leaves from the wave's first, 8 KiB real-valued LUTs,
rerank depth 128) and times ``adc_topk`` on them as the sweep calls it
(the whole LUT table, the slab start on the device), then on the same
waves with every lookup leaf moved past the wave's leaves, where no warp
finds a match: that time is the launch, the leaf test and the empty
lists. ``--src`` is the ``src`` directory of the checkout whose port is
timed (default this repository's), so two checkouts can be compared on one
card. Needs a CUDA device; prints the card and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

P, Q, M, C, K = 4096, 1024, 8, 256, 128


def time_ms(fn, args_list, warmup: int = 2) -> float:
    """Device ms per call of ``fn(*args)``, calls back to back: the stream
    is held by a spin kernel while the host enqueues them all."""
    for args in args_list[:warmup]:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for args in args_list:
        fn(*args)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * host_s + 1e-3) * 2e9))  # cycles at <= 2 GHz
    start.record()
    for args in args_list:
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(args_list)


def make_waves(n: int, seed: int, dev):
    """``n`` waves (codes, point leaves, slab start) over one LUT table."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lut = torch.rand((n * Q, M, C), generator=g, device=dev) * 2000.0
    qleaves, waves = [], []
    for i in range(n):
        first = 100_000 * i
        sizes = torch.randint(128, 385, (32,), generator=g, device=dev)
        pl = torch.repeat_interleave(first + torch.arange(32, device=dev), sizes)[:P]
        codes = torch.randint(0, C, (P, M), generator=g, device=dev).to(torch.uint8)
        ql = first + torch.randint(0, 2048, (Q,), generator=g, device=dev).sort().values
        qleaves.append(ql.int())
        waves.append((codes, pl.int().contiguous(),
                       torch.tensor([i * Q], dtype=torch.int64, device=dev)))
    return waves, lut, torch.cat(qleaves)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--waves", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("adcscan_floor: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.kernels.adcscan.ops import adc_topk

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    waves, lut, qleaves = make_waves(args.waves, args.seed, dev)
    shifted = qleaves + 50_000  # past every wave's last leaf, before the next

    def call(leaves):
        return lambda codes, pl, start: adc_topk(codes, pl, lut, leaves, k=K,
                                                 q_start=start, q_rows=Q)

    matched = sum(int(torch.isin(qleaves[int(s):int(s) + Q], pl).sum())
                  for _, pl, s in waves)
    real = time_ms(call(qleaves), waves)
    floor = time_ms(call(shifted), waves)
    print(json.dumps({"src": args.src, "wave_ms": real, "floor_ms": floor,
                      "scan_ms": real - floor, "waves": len(waves),
                      "matched_lookup_rows_per_wave": matched / len(waves)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
