"""DescriptorStore: the Hadoop sequence-file analog (paper §2.3 step 1).

The JAX package's ``data/store.py`` (numpy only), on this package's
``data/synth.py``: the same directory format and the same virtual blocks,
so either package reads the other's stores.

A store is a directory of fixed-size *blocks* (``block_*.npy`` pairs of
vectors + ids) plus a JSON manifest — the same role HDFS chunks play for the
paper: the unit of map-task input, of streaming, and of re-execution. Blocks
are read lazily, so terabyte-scale collections stream through the index
pipeline wave-by-wave (the index lifecycle) without ever being resident.

For synthetic corpora a *virtual* store generates blocks on the fly from a
seed — same interface, zero disk.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, Optional

import numpy as np

from repro_torch.data import synth


@dataclasses.dataclass
class Block:
    index: int
    vecs: np.ndarray  # (rows, dim)
    ids: np.ndarray  # (rows,) global descriptor ids


class DescriptorStore:
    """On-disk block store."""

    def __init__(self, directory: str):
        self.directory = directory
        with open(os.path.join(directory, "manifest.json")) as f:
            m = json.load(f)
        self.n_rows = m["n_rows"]
        self.dim = m["dim"]
        self.block_rows = m["block_rows"]
        self.n_blocks = m["n_blocks"]

    @staticmethod
    def create(
        directory: str,
        vecs: np.ndarray,
        *,
        block_rows: int = 65536,
        ids: Optional[np.ndarray] = None,
    ) -> "DescriptorStore":
        os.makedirs(directory, exist_ok=True)
        n, dim = vecs.shape
        if ids is None:
            ids = np.arange(n, dtype=np.int64)
        n_blocks = (n + block_rows - 1) // block_rows
        for b in range(n_blocks):
            sl = slice(b * block_rows, min(n, (b + 1) * block_rows))
            np.save(os.path.join(directory, f"block_{b:06d}_vecs.npy"), vecs[sl])
            np.save(os.path.join(directory, f"block_{b:06d}_ids.npy"), ids[sl])
        with open(os.path.join(directory, "manifest.json"), "w") as f:
            json.dump(
                {
                    "n_rows": int(n),
                    "dim": int(dim),
                    "block_rows": int(block_rows),
                    "n_blocks": int(n_blocks),
                },
                f,
            )
        return DescriptorStore(directory)

    def read_block(self, b: int) -> Block:
        vecs = np.load(os.path.join(self.directory, f"block_{b:06d}_vecs.npy"))
        ids = np.load(os.path.join(self.directory, f"block_{b:06d}_ids.npy"))
        return Block(index=b, vecs=vecs, ids=ids)

    def blocks(self) -> Iterator[Block]:
        for b in range(self.n_blocks):
            yield self.read_block(b)

    def read_rows(self, rows: np.ndarray) -> np.ndarray:
        return _read_rows(self, rows)


class VirtualStore:
    """Seeded on-the-fly store: block b is a pure function of (seed, b)."""

    def __init__(
        self,
        n_rows: int,
        dim: int = 128,
        *,
        block_rows: int = 65536,
        seed: int = 0,
        n_centers: int = 1024,
    ):
        self.n_rows = n_rows
        self.dim = dim
        self.block_rows = block_rows
        self.n_blocks = (n_rows + block_rows - 1) // block_rows
        self.seed = seed
        self.mixture = synth.make_mixture(n_centers, dim, seed=seed ^ 0x5EED)

    def read_block(self, b: int) -> Block:
        start = b * self.block_rows
        rows = min(self.block_rows, self.n_rows - start)
        vecs, _ = synth.sample_descriptors(
            rows, self.dim, mixture=self.mixture, seed=self.seed + 7919 * b
        )
        ids = np.arange(start, start + rows, dtype=np.int64)
        return Block(index=b, vecs=vecs, ids=ids)

    def blocks(self) -> Iterator[Block]:
        for b in range(self.n_blocks):
            yield self.read_block(b)

    def read_rows(self, rows: np.ndarray) -> np.ndarray:
        return _read_rows(self, rows)

    def sample_for_tree(self, n: int) -> np.ndarray:
        vecs, _ = synth.sample_descriptors(
            n, self.dim, mixture=self.mixture, seed=self.seed ^ 0x7EEE
        )
        return vecs


def _read_rows(store, rows: np.ndarray) -> np.ndarray:
    """Gather arbitrary global rows, touching each containing block once.

    The serving trace replay and the index lifecycle rely on its edge-case
    contract: rows may arrive in any order (with duplicates), may span the
    final partial block, and an empty selection returns an empty ``(0,
    dim)`` gather; the output row ``i`` is always ``store`` row
    ``rows[i]``, regardless of gather order.
    """
    rows = np.atleast_1d(np.asarray(rows, np.int64))
    if rows.ndim != 1:
        raise ValueError(f"rows must be 1-D; got shape {rows.shape}")
    if rows.size == 0:
        return np.empty((0, store.dim), np.float32)
    if rows.min() < 0 or rows.max() >= store.n_rows:
        raise IndexError(
            f"row ids must be in [0, {store.n_rows}); got "
            f"[{rows.min()}, {rows.max()}]"
        )
    out = np.empty((rows.size, store.dim), np.float32)
    blocks = rows // store.block_rows
    for b in np.unique(blocks):
        sel = blocks == b
        blk = store.read_block(int(b))
        out[sel] = blk.vecs[rows[sel] - int(b) * store.block_rows]
    return out
