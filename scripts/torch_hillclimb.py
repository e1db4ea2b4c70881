"""The hill-climb for the PyTorch/CUDA port: the per-source breakdown
of one traced step of a cell on the card (the roofline mode of
``scripts/hillclimb.py``).

  PYTHONPATH=src python scripts/torch_hillclimb.py --arch gin-tu \
      --shape molecule [--variant NAME] [--key device|launches] [--top 14] \
      [--device cuda] [--out records.jsonl]

The cell is built at its card cut (``Cell.card_cut``), warmed up, timed
over a few synchronised steps and traced once (``launch/dryrun.py``'s
measured mode); the trace's kernels are listed by device time or by
launches. Variants (``repro_torch.configs.variants``) apply one named
change to the cell (``head_pad``, ``routed_moe``, ``query_routed``, ...).

The reference's tune mode (``--tune-fused``: sweep the fused scan's block
sizes and record the winner) is not ported: it calls
``benchmarks.block_size.tune``, which waits for the port's benchmark
modules (ROADMAP M10).
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default=None)
    ap.add_argument("--key", default="device", choices=["device", "launches"])
    ap.add_argument("--top", type=int, default=14)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--tune-fused", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help="append JSONL record")
    args = ap.parse_args(argv)
    if args.tune_fused:
        ap.error("tune mode is not ported (it waits for the port's benchmark "
                 "modules, ROADMAP M10)")

    from repro_torch.configs import REGISTRY, variants
    from repro_torch.device import resolve
    from repro_torch.launch import dryrun, trace_cost

    dev = resolve(args.device)
    cell = (variants.apply(args.variant, args.arch, args.shape) if args.variant
            else REGISTRY[args.arch].cell(args.shape))
    rec = dryrun.measured_record(cell, dev, seed=args.seed, steps=args.steps,
                                 n_top=args.top)
    rec["variant"] = args.variant or "baseline"
    if rec["status"] != "ok":
        print(json.dumps(rec))
        return 0 if rec["status"] == "skip" else 1
    roof = rec["roofline"]
    print(f"roofline: compute={roof['t_compute']:.4g}s memory={roof['t_memory']:.4g}s "
          f"collective={roof['t_collective']:.4g}s dominant={roof['dominant']}")
    print(f"top sources by {args.key}:")
    cost = trace_cost.Cost(device_s=roof["device_s"])
    for op in rec["top_ops"]:
        cost.add_source(op["name"], None if op["device_ms"] == trace_cost.NOT_MEASURED
                        else op["device_ms"], op["launches"])
    for name, ms, launches, share in cost.top_sources(args.top, key=args.key):
        print(f"  {name[:100]:<100s} device_ms={ms} launches={launches} share={share}")
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
