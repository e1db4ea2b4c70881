"""Synthetic SIFT-like descriptor collections.

Real SIFT: 128-d, non-negative, heavy-tailed, strongly clustered (gradients
of natural image patches). The generator draws a Gaussian-mixture with
power-law cluster masses and per-cluster anisotropic scales, then clips to
[0, 255] and quantises like SIFT byte descriptors — clustered enough that a
vocabulary tree behaves like it does on real data (unbalanced leaves,
Table 7's variance in per-block work), cheap enough to synthesise billions
of rows wave-by-wave from a seed (the store never materialises the corpus).
"""

from __future__ import annotations

import numpy as np


def make_mixture(n_centers: int, dim: int = 128, seed: int = 0):
    rng = np.random.default_rng(seed)
    centers = rng.gamma(2.0, 24.0, size=(n_centers, dim)).astype(np.float32)
    scales = rng.uniform(4.0, 18.0, size=(n_centers, 1)).astype(np.float32)
    # power-law cluster masses (zipf-ish) -> unbalanced tree leaves
    w = 1.0 / np.arange(1, n_centers + 1) ** 1.1
    weights = (w / w.sum()).astype(np.float64)
    return centers, scales, weights


def sample_descriptors(
    n: int,
    dim: int = 128,
    *,
    mixture=None,
    n_centers: int = 256,
    seed: int = 0,
    quantize: bool = True,
):
    """(n, dim) float32 SIFT-like rows + (n,) their mixture component."""
    rng = np.random.default_rng(seed)
    centers, scales, weights = mixture or make_mixture(n_centers, dim, seed=seed ^ 0x5EED)
    comp = rng.choice(len(weights), size=n, p=weights)
    x = centers[comp] + rng.standard_normal((n, dim)).astype(np.float32) * scales[comp]
    np.clip(x, 0.0, 255.0, out=x)
    if quantize:
        x = np.rint(x).astype(np.float32)
    return x, comp.astype(np.int32)


def sample_images(
    n_images: int,
    desc_per_image: int,
    dim: int = 128,
    *,
    seed: int = 0,
    n_centers: int = 256,
):
    """A collection of 'images': (vecs (n_images*dpi, dim), img_ids)."""
    mix = make_mixture(n_centers, dim, seed=seed ^ 0xA11CE)
    vecs, _ = sample_descriptors(
        n_images * desc_per_image, dim, mixture=mix, seed=seed
    )
    img_ids = np.repeat(np.arange(n_images, dtype=np.int32), desc_per_image)
    return vecs, img_ids


def zipf_weights(n: int, s: float = 1.1) -> np.ndarray:
    """Zipf popularity over ``n`` items: weight of rank r is ``1/r^s``."""
    if n < 1:
        raise ValueError(f"{n=} must be positive")
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return w / w.sum()


def sample_trace(
    n_requests: int,
    n_images: int,
    *,
    skew: str = "uniform",
    zipf_s: float = 1.1,
    rate: float | None = None,
    seed: int = 0,
):
    """A replayable request trace: ``(image_ids, arrivals)``.

    ``image_ids`` — which image each request queries, drawn uniformly or
    Zipf-skewed (popular images repeat: the hot-leaf-cache workload).
    Popularity ranks are themselves shuffled so "hot" images are spread
    over the id space rather than clustered at low ids.
    ``arrivals`` — seconds, Poisson arrivals at ``rate`` req/s (``None`` =
    everything arrives at t=0: the paper's offline batch as a degenerate
    trace). Deterministic under ``seed``; tests assert bit-equality.
    """
    if skew not in ("uniform", "zipf"):
        raise ValueError(f"unknown {skew=}; want uniform|zipf")
    rng = np.random.default_rng(seed)
    if skew == "zipf":
        ranks = rng.permutation(n_images)
        p = zipf_weights(n_images, zipf_s)[ranks]
        image_ids = rng.choice(n_images, size=n_requests, p=p)
    else:
        image_ids = rng.integers(0, n_images, size=n_requests)
    if rate is None:
        arrivals = np.zeros(n_requests, np.float64)
    else:
        arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n_requests))
    return image_ids.astype(np.int64), arrivals
