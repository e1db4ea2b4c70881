"""Index persistence: corpus store helpers, and deprecation shims over
:mod:`repro_torch.index`.

The historical index-once / serve-many pair (``save_index``/``load_index``)
persisted one monolithic ``DistributedIndex``. The canonical API is
:class:`repro_torch.index.Index` (``create``/``open``/``append``/``commit``/
``compact``), whose on-disk format -- the JAX package's versioned
manifests over immutable segments -- is what these shims read and write:

  * ``save_index(dir, index, tree)`` is ``Index.create(tree, dir,
    overwrite=True)`` + ``append_built(index)`` + ``commit()``;
  * ``load_index(dir, device)`` is ``Index.open(dir, device)`` restricted
    to a single-segment, tombstone-free index.

Both emit ``DeprecationWarning``; a legacy ``index_ckpt/`` directory
raises ``Index.open``'s error. The corpus helpers (``save_corpus``/
``load_corpus``) are not deprecated: the trace replay reads query images
from a ``DescriptorStore`` block by block.
"""

from __future__ import annotations

import os
import warnings

import numpy as np

from repro_torch.core.index_build import DistributedIndex
from repro_torch.core.tree import VocabTree
from repro_torch.data.store import DescriptorStore
from repro_torch.index import Index
from repro_torch.index import has_index  # noqa: F401

CORPUS_SUBDIR = "corpus"


def save_index(directory: str, index: DistributedIndex, tree: VocabTree, *,
               extra: dict | None = None) -> str:
    """Deprecated: persist one built index as a single committed segment
    (on the tree's device)."""
    warnings.warn(
        "serving.persist.save_index is deprecated; use repro_torch.index."
        "Index.create(...).append_built(...)/commit()",
        DeprecationWarning, stacklevel=2)
    idx = Index.create(tree, directory, device=tree.device, extra=extra,
                       overwrite=True)
    idx.append_built(index)
    idx.commit()
    return directory


def load_index(directory: str, device="cuda"
               ) -> tuple[DistributedIndex, VocabTree, dict]:
    """Deprecated: restore ``(index, tree, meta)`` from a one-segment index
    onto ``device``. Raises ``ValueError`` for a grown (multi-segment or
    tombstoned) index -- open those with ``Index.open``."""
    warnings.warn(
        "serving.persist.load_index is deprecated; use "
        "repro_torch.index.Index.open", DeprecationWarning, stacklevel=2)
    idx = Index.open(directory, device=device)
    if idx.n_segments != 1 or len(idx.tombstones):
        raise ValueError(
            f"{directory} holds {idx.n_segments} segments and "
            f"{len(idx.tombstones)} tombstones -- not representable as one "
            "DistributedIndex; use repro_torch.index.Index.open")
    return idx.segments[0].index, idx.tree, idx.meta


def corpus_dir(directory: str) -> str:
    return os.path.join(directory, CORPUS_SUBDIR)


def save_corpus(directory: str, vecs: np.ndarray, *,
                block_rows: int = 65536) -> DescriptorStore:
    """Persist corpus rows as a DescriptorStore (the trace replay reads
    query images from it without holding the collection resident)."""
    return DescriptorStore.create(corpus_dir(directory), np.asarray(vecs),
                                  block_rows=block_rows)


def load_corpus(directory: str) -> DescriptorStore:
    return DescriptorStore(corpus_dir(directory))
