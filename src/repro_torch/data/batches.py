"""Synthetic LM and recsys batch generators (numpy, seeded): copies of
the JAX package's ``data/batches.py``, the same arrays bit for bit."""

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


def dlrm_batch(batch: int, n_dense: int, n_sparse: int, vocab: int, *, seed: int = 0):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((batch, n_dense)).astype(np.float32)
    sparse = np.minimum(rng.zipf(1.2, (batch, n_sparse)), vocab - 1).astype(np.int32)
    # planted signal: label correlates with a dense feature + sparse parity
    logit = dense[:, 0] + 0.5 * ((sparse[:, 0] % 2) * 2 - 1)
    label = (logit + rng.standard_normal(batch) > 0).astype(np.float32)
    return {"dense": dense, "sparse": sparse, "label": label}


def din_batch(batch: int, seq_len: int, vocab: int, *, seed: int = 0):
    rng = np.random.default_rng(seed)
    hist = np.minimum(rng.zipf(1.3, (batch, seq_len)), vocab - 1).astype(np.int32)
    # half positives: target drawn from the user's history
    pos_target = hist[np.arange(batch), rng.integers(0, seq_len, batch)]
    neg_target = np.minimum(rng.zipf(1.3, batch), vocab - 1).astype(np.int32)
    label = (rng.random(batch) < 0.5).astype(np.float32)
    target = np.where(label > 0, pos_target, neg_target).astype(np.int32)
    target = np.maximum(target, 1)
    return {"hist": hist, "target": target, "label": label}


def twotower_batch(batch: int, n_user_fields: int, n_item_fields: int, vocab: int,
                   *, seed: int = 0):
    rng = np.random.default_rng(seed)
    user = rng.integers(0, vocab, (batch, n_user_fields)).astype(np.int32)
    # positive item correlated with the user's first field
    item = rng.integers(0, vocab, (batch, n_item_fields)).astype(np.int32)
    item[:, 0] = (user[:, 0] * 7919 + 13) % vocab
    return {"user_ids": user, "item_ids": item}
