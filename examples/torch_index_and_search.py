"""End-to-end example on the PyTorch port: streaming index job + batched
search serving, on every visible card.

This is the paper's full production pipeline (Table 2): stream a descriptor
store through the wave-scheduled index job (with an injected failure to
show retry), then serve query batches and report ms/image throughput -- the
paper's 210 ms/image headline protocol.

Run:  PYTHONPATH=src python examples/torch_index_and_search.py [--device cpu]
"""

import argparse
import sys

from repro_torch.launch import index as index_job
from repro_torch.launch import serve

ROWS, DIM, FANOUT = 120_000, 48, 24
BLOCK_ROWS, IMAGES, BATCHES, BATCH_IMAGES = 30_000, 2000, 2, 128


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (every visible card, one shard each), cuda:N or cpu")
    args = ap.parse_args(argv)
    common = ["--rows", str(ROWS), "--dim", str(DIM),
              "--fanout", str(FANOUT), str(FANOUT), "--device", args.device]

    print("=" * 70)
    print("PHASE 1 — streaming index job (with injected failures + retry)")
    print("=" * 70)
    rc = index_job.main(common + ["--block-rows", str(BLOCK_ROWS),
                                  "--inject-failures"])
    assert rc == 0

    print()
    print("=" * 70)
    print("PHASE 2 — batched search serving (throughput protocol, Exp #5)")
    print("=" * 70)
    rc = serve.main(common + ["--images", str(IMAGES), "--batches", str(BATCHES),
                              "--batch-images", str(BATCH_IMAGES)])
    assert rc == 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
