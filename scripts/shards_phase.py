"""Run ``chip_smoke.py``'s shards phase alone: both jobs over a mesh of
devices at the sift100m deployment's widths, held bit for bit against a
one-shard index of the same corpus.

    python scripts/shards_phase.py [--seed S]

Builds the kernels, the 256 x 256 tree on the corpus's first 2^20 rows
(``build_tree``, as the main path) and the PQ codebooks (m 8, bits 8, as
the codes path, here trained on the tree's sample), then calls
``chip_smoke.shards_phase``: mesh A, four shards on the first card, and
mesh B, one shard a card, on a machine with two cards or more; the short
``Index`` over the last mesh and ``ShardedIndex(n_shards=2)`` on it.
Prints the cards, the phase's lines (walls, peak memory a card, launches
by kernel and card, on mesh B each card's busy time and first and last
event in a traced K1 sweep), and one JSON line of the phase's numbers last. Needs a CUDA
device.
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
        print("shards_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    for line in smi.splitlines():
        print(line, flush=True)
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    rt = cs.Port()
    rt.build.lib()
    mix = rt.synth.make_mixture(256, cs.DIM, seed=args.seed)
    sample = cs.make_corpus(rt, cs.SAMPLE_ROWS, args.seed, dev, mix)
    tree = rt.build_tree(sample, cs.FANOUTS,
                         generator=torch.Generator().manual_seed(args.seed),
                         device=dev)
    pq = rt.ProductQuantizer.train(sample, **cs.PQ)
    del sample
    kernels = [dict(name=n) for n in cs.SH_KERNELS]
    setup_s = time.perf_counter() - t_start
    stats = cs.shards_phase(rt, args, dev, tree, pq, kernels,
                            time.perf_counter())
    print(json.dumps(dict(setup_s=setup_s, stats=stats, kernels=kernels)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
