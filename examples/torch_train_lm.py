"""Train an LM from the arch zoo (reduced config) with checkpoint/resume,
on the PyTorch port (``examples/train_lm.py``'s counterpart).

Demonstrates the training substrate: AdamW, warmup-cosine, microbatch
accumulation, bf16 gradient compression with error feedback, and
mid-run checkpoint + resume producing a continuous loss curve.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--device cpu]
"""

import argparse
import shutil
import tempfile

from repro_torch.launch import train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    ckpt = tempfile.mkdtemp(prefix="torch_train_lm_")
    common = ["--arch", "internlm2-1.8b", "--batch", "8", "--seq", "64",
              "--microbatches", "2", "--compress", "bf16", "--ckpt-dir", ckpt,
              "--checkpoint-every", "10", "--device", args.device]
    try:
        print("=== phase 1: steps 0..30 (bf16-compressed grads, 2 microbatches)")
        train.main(["--steps", "30", *common])
        print("=== phase 2: simulated restart — resume from step 30, run to 60")
        train.main(["--steps", "60", "--resume", *common])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
