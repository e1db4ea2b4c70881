"""Copydays-style distorted-query evaluation (paper §4.2, Fig 4), the JAX
package's ``data/copydays.py`` (numpy only).

The paper drowns 127 originals + 3055 generated variants (crop+scale,
jpeg, strong manual distortions) in 20M/100M distractors and counts
originals returned at rank 1. We synthesise the same protocol: 'images' are
descriptor sets; variants perturb a fraction of descriptors with increasing
severity; strong variants keep only a few descriptors — the paper notes
some attacked queries retain only a handful (or zero) descriptors.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: (name, kept descriptor fraction, additive noise scale) — severity ladder
VARIANTS = (
    ("crop10", 0.90, 4.0),
    ("crop30", 0.70, 6.0),
    ("crop50", 0.50, 8.0),
    ("crop80", 0.20, 12.0),
    ("jpeg75", 1.00, 10.0),
    ("jpeg30", 1.00, 20.0),
    ("strong", 0.10, 40.0),
)


@dataclasses.dataclass
class CopydaysSet:
    query_vecs: np.ndarray  # (Q, d)
    query_img: np.ndarray  # (Q,) original image id each query row comes from
    query_variant: np.ndarray  # (Q,) index into VARIANTS
    n_originals: int


def make_copydays(
    orig_vecs: np.ndarray,
    orig_img_ids: np.ndarray,
    *,
    seed: int = 0,
    variants=VARIANTS,
) -> CopydaysSet:
    """Build the distorted-query set from original images' descriptors."""
    rng = np.random.default_rng(seed)
    originals = np.unique(orig_img_ids)
    q_vecs, q_img, q_var = [], [], []
    for img in originals:
        rows = np.flatnonzero(orig_img_ids == img)
        for vi, (_, keep, noise) in enumerate(variants):
            m = max(1, int(len(rows) * keep))
            pick = rng.choice(rows, size=m, replace=False)
            v = orig_vecs[pick].astype(np.float32)
            v = v + rng.standard_normal(v.shape).astype(np.float32) * noise
            np.clip(v, 0.0, 255.0, out=v)
            q_vecs.append(v)
            q_img.append(np.full(m, img, np.int32))
            q_var.append(np.full(m, vi, np.int32))
    return CopydaysSet(
        query_vecs=np.concatenate(q_vecs),
        query_img=np.concatenate(q_img),
        query_variant=np.concatenate(q_var),
        n_originals=len(originals),
    )


def vote_images(result_ids: np.ndarray, db_img_ids: np.ndarray,
                query_img: np.ndarray, query_variant: np.ndarray,
                n_variants: int):
    """Paper's scoring: per (original, variant), vote k-NN hits by image and
    check the original wins rank 1. Returns per-variant recall@1 + average.

    result_ids: (Q, k) descriptor ids (-1 = none); db_img_ids maps
    descriptor id -> image id.
    """
    recalls = np.zeros(n_variants)
    counts = np.zeros(n_variants)
    keys = np.stack([query_img, query_variant], axis=1)
    uniq = np.unique(keys, axis=0)
    for img, var in uniq:
        rows = np.flatnonzero((query_img == img) & (query_variant == var))
        ids = result_ids[rows].reshape(-1)
        ids = ids[ids >= 0]
        counts[var] += 1
        if len(ids) == 0:
            continue
        imgs = db_img_ids[ids]
        vals, cnt = np.unique(imgs, return_counts=True)
        if vals[np.argmax(cnt)] == img:
            recalls[var] += 1
    per_variant = recalls / np.maximum(counts, 1)
    return per_variant, float(recalls.sum() / max(1, counts.sum()))
