"""Quickstart on the PyTorch port: build a vocabulary-tree index and search
it -- the paper's whole workflow in ~30 lines, on every visible card.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import torch

from repro_torch import batch_search, build_index, build_tree, local_mesh
from repro_torch.data import synth

ROWS, DIM, N_QUERIES = 50_000, 64, 100


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (every visible card, one shard each), cuda:N or cpu")
    args = ap.parse_args(argv)
    mesh = local_mesh(args.device)  # one shard a card
    dev = mesh.first

    # 1. a synthetic SIFT-like collection (50k descriptors, 64-d)
    vecs_np, _ = synth.sample_descriptors(ROWS, DIM, seed=0, n_centers=256)
    vecs = torch.as_tensor(vecs_np, device=dev)

    # 2. the index tree: wide-fanout hierarchical quantization (paper §2.3)
    tree = build_tree(vecs, fanouts=(16, 16),
                      generator=torch.Generator().manual_seed(0), device=dev)
    print(f"index tree: {tree.n_leaves} leaves, {tree.nbytes / 1e6:.2f} MB")

    # 3. distributed index creation: assign -> shuffle -> cluster-sort
    index = build_index(vecs, tree, mesh=mesh)
    print(f"index: {int(index.n_valid.sum())} descriptors, "
          f"routing overflow {int(index.overflow)}")

    # 4. batch search: 100 noisy queries, k=5 approximate nearest neighbors.
    #    layout="auto" lets the engine plan() heuristic pick the scan layout;
    #    probes=3 visits each query's 3 nearest leaves (multi-probe recall)
    noise = torch.randn((N_QUERIES, DIM), generator=torch.Generator().manual_seed(1))
    queries = vecs[:N_QUERIES] + 2.0 * noise.to(dev)
    for probes in (1, 3):
        result = batch_search(index, tree, queries, k=5, layout="auto",
                              probes=probes, device=dev)
        top1 = result.ids[:, 0].cpu()
        print(f"probes={probes}: top-1 self-retrieval "
              f"{(top1 == torch.arange(N_QUERIES)).float().mean():.0%}, "
              f"distance pairs {float(result.pairs):.3g} "
              f"(brute force would be {ROWS * N_QUERIES:.3g})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
