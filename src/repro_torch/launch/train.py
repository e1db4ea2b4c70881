"""Training launcher: ``--arch`` zoo training with checkpoint/restart, on
the card (the JAX package's ``launch/train.py``).

It trains the *reduced* configs (``configs/lm.py`` ``SMOKE_BY_ARCH``), as
the reference's launcher does, with its flags, its schedule (warmup 10,
cosine to ``--steps``, weight decay 0.01) and its lines (``step ... loss
... gnorm ...``, ``resumed from step N``, ``loss a -> b OK``). Every
``--checkpoint-every`` steps, and at the last, the whole train state goes
through ``CheckpointManager`` under the reference's leaf names
(``0/embed``, ``1/m/layers/wq``, ``1/step``, ...), so a run checkpointed by
either package's launcher resumes in the other. Fresh weights are drawn
from a ``torch.Generator`` seeded with ``--seed`` (not the reference's
``jax.random`` numbers).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --steps 50 --batch 8 --seq 64 [--resume] [--ckpt-dir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[3] / "build" / "train_ckpt")


def reduced_lm_config(arch: str):
    from repro_torch.configs.lm import SMOKE_BY_ARCH

    if arch not in SMOKE_BY_ARCH:
        raise SystemExit(f"train.py currently drives LM archs; got {arch}")
    return SMOKE_BY_ARCH[arch]


def restore_train_state(mgr, params, state, device):
    """``(params, state, manifest)`` of ``mgr``'s latest checkpoint, shaped
    as ``(params, state)``, on ``device``."""
    from repro_torch.train import tree

    names = list(tree.named((params, state)))
    arrays, manifest = mgr.restore(names, device=device)
    params, state = tree.unflatten((params, state), [arrays[n] for n in names])
    return params, state, manifest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", choices=["bf16", "topk"], default=None)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)

    from repro_torch.data.batches import lm_batch
    from repro_torch.device import resolve
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.models import transformer as tfm
    from repro_torch.models.module import init_params
    from repro_torch.train import AdamWConfig, make_train_step, tree
    from repro_torch.train.optimizer import warmup_cosine
    from repro_torch.train.step import init_train_state

    dev = resolve(args.device)
    cfg = reduced_lm_config(args.arch)
    params = init_params(cfg.param_specs(),
                         torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    state = init_train_state(params, compress=args.compress)
    start_step = 0
    mgr = CheckpointManager(f"{args.ckpt_dir}/{args.arch}")
    if args.resume and mgr.latest_step() is not None:
        params, state, manifest = restore_train_state(mgr, params, state, dev)
        start_step = manifest["step"]
        print(f"resumed from step {start_step}")

    opt_cfg = AdamWConfig(lr=warmup_cosine(args.lr, 10, args.steps), weight_decay=0.01)
    step_fn = make_train_step(lambda p, b: tfm.loss_fn(p, cfg, b, device=dev), opt_cfg,
                              microbatches=args.microbatches, compress=args.compress)

    losses = []
    for step in range(start_step, args.steps):
        batch = lm_batch(args.batch, args.seq, cfg.vocab_size, seed=args.seed + step)
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, batch)
        loss = float(metrics["loss"])  # waits for the step
        losses.append(loss)
        print(f"step {step:5d} loss {loss:8.4f} gnorm "
              f"{float(metrics['grad_norm']):8.4f} "
              f"({(time.perf_counter() - t0) * 1e3:7.1f} ms)")
        if (step + 1) % args.checkpoint_every == 0 or step + 1 == args.steps:
            mgr.save(step + 1, tree.named((params, state)))
    if len(losses) > 10:
        assert np.mean(losses[-5:]) < np.mean(losses[:5]), "loss did not drop"
        print(f"loss {np.mean(losses[:5]):.3f} -> {np.mean(losses[-5:]):.3f} OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
