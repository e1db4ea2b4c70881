"""Search-quality evaluation on the PyTorch port: the paper's Fig 4
(Copydays) protocol.

Distorted query variants (crop / jpeg-noise / strong) are drowned in a
distractor collection; we report per-variant recall@1 of the original
image via k-NN voting -- compare with the paper's ~82% average.

Run:  PYTHONPATH=src python examples/torch_copydays_eval.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch import batch_search, build_index, build_tree, local_mesh
from repro_torch.data import synth
from repro_torch.data.copydays import VARIANTS, make_copydays, vote_images

DIM, N_IMAGES, DPI, N_ORIGINALS = 48, 800, 24, 100


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (every visible card, one shard each), cuda:N or cpu")
    args = ap.parse_args(argv)
    mesh = local_mesh(args.device)
    dev = mesh.first
    print(f"corpus: {N_IMAGES} images x {DPI} descriptors (d={DIM})")
    vecs_np, img_ids = synth.sample_images(N_IMAGES, DPI, DIM, seed=0)

    rng = np.random.default_rng(1)
    originals = rng.choice(N_IMAGES, N_ORIGINALS, replace=False)
    rows = np.isin(img_ids, originals)
    cd = make_copydays(vecs_np[rows], img_ids[rows], seed=2)
    print(f"queries: {len(cd.query_vecs)} descriptors from "
          f"{cd.n_originals} originals x {len(VARIANTS)} variants")

    vecs = torch.as_tensor(vecs_np, device=dev)
    tree = build_tree(vecs, (24, 24), generator=torch.Generator().manual_seed(3),
                      device=dev)
    index = build_index(vecs, tree, mesh=mesh)
    res = batch_search(index, tree, cd.query_vecs, k=10, q_cap=2048, device=dev)
    assert int(res.q_cap_overflow) == 0

    per_variant, avg = vote_images(
        res.ids.cpu().numpy(), img_ids, cd.query_img, cd.query_variant,
        len(VARIANTS),
    )
    print()
    print(f"{'variant':<10} {'kept':>5} {'noise':>6} {'recall@1':>9}")
    for (name, keep, noise), r in zip(VARIANTS, per_variant):
        print(f"{name:<10} {keep:>5.0%} {noise:>6.1f} {r:>9.1%}")
    print(f"{'AVERAGE':<10} {'':>5} {'':>6} {avg:>9.1%}   (paper: ~82%)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
