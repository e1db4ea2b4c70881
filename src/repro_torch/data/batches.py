"""Synthetic LM batch generator (numpy, seeded): a copy of the JAX
package's ``data/batches.py::lm_batch``."""

from __future__ import annotations

import numpy as np


def lm_batch(batch: int, seq: int, vocab: int, *, seed: int = 0):
    """Zipf-distributed token stream with next-token labels."""
    rng = np.random.default_rng(seed)
    toks = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64)
    toks = np.minimum(toks, vocab - 1)
    return {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }
