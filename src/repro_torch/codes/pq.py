"""Product quantization: the compressed-codes encoder.

A :class:`ProductQuantizer` splits the descriptor dimension into ``m``
subspaces and learns a ``2**bits``-centroid k-means codebook per subspace
from a *deterministic seeded sample* of the corpus. Encoding maps every
row to ``m`` uint8 codes (``m`` bytes/row vs ``4 * dim`` full-precision);
searching scans the codes with asymmetric distances (the query stays
full-precision, each code byte indexes a per-query lookup table) and
reranks the surviving candidates exactly from the raw rows.

Training is numpy, as in the JAX package, so that the same rows give
byte-identical codebooks there and here; only the seeded sample is
gathered from the rows, on their device, and copied to the host. Encoding
runs on the rows' device: per subspace, the nearest centroid of every row
through ``kernels.l2nn`` (K3 on the card, its plain version on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.l2nn.ops import l2_nearest

CODES_FORMAT = 1

#: k-means assignment chunk: bounds the (chunk, C) distance matrix
_CHUNK = 8192
#: encode chunk (rows per l2_nearest call): bounds the copied subspace
_ENCODE_CHUNK = 1 << 21


def _sq_dists(x: np.ndarray, cents: np.ndarray) -> np.ndarray:
    """(n, C) squared L2 distances, f32; ||x||^2 dropped (argmin-safe)."""
    return (
        (cents * cents).sum(1)[None, :] - 2.0 * (x @ cents.T)
    ).astype(np.float32)


def _kmeans(x: np.ndarray, n_centers: int, iters: int,
            rng: np.random.Generator) -> np.ndarray:
    """Deterministic Lloyd k-means: seeded row init, fixed iterations,
    empty clusters reseeded to the worst-served points."""
    n = x.shape[0]
    cents = x[np.sort(rng.choice(n, n_centers, replace=n < n_centers))].copy()
    for _ in range(max(1, iters)):
        assign = np.empty(n, np.int64)
        mind = np.empty(n, np.float32)
        for s in range(0, n, _CHUNK):
            d = _sq_dists(x[s:s + _CHUNK], cents)
            assign[s:s + _CHUNK] = d.argmin(1)
            mind[s:s + _CHUNK] = d.min(1)
        sums = np.zeros_like(cents, dtype=np.float64)
        np.add.at(sums, assign, x.astype(np.float64))
        counts = np.bincount(assign, minlength=n_centers)
        empty = np.flatnonzero(counts == 0)
        if empty.size:
            # farthest-from-centroid points re-seed dead centers (ordered
            # by distance then index: fully deterministic)
            order = np.argsort(-mind, kind="stable")[: empty.size]
            for c, row in zip(empty, order):
                cents[c] = x[row]
                counts[c] = 1
                sums[c] = x[row].astype(np.float64)
        live = counts > 0
        cents[live] = (sums[live] / counts[live, None]).astype(np.float32)
    return cents.astype(np.float32)


def _as_rows(vecs) -> torch.Tensor:
    """A float32 tensor view of ``vecs`` (numpy or a tensor, any device)."""
    return torch.as_tensor(vecs).float()


class ProductQuantizer:
    """Per-subspace k-means codebooks + uint8 code encode/decode.

    Args:
      codebooks: ``(m, 2**bits, dim // m)`` float32 centroid table (numpy,
        on the host).
      meta: provenance (seed/sample/iters) carried through serialization.
    """

    def __init__(self, codebooks: np.ndarray, meta: dict | None = None):
        cb = np.asarray(codebooks, np.float32)
        if cb.ndim != 3:
            raise ValueError(f"codebooks must be (m, C, dsub), got {cb.shape}")
        self.codebooks = cb
        self.m = cb.shape[0]
        self.n_centers = cb.shape[1]
        self.bits = int(self.n_centers - 1).bit_length()
        if 1 << self.bits != self.n_centers or self.bits > 8:
            raise ValueError(
                f"n_centers {self.n_centers} must be a power of 2, <= 256"
            )
        self.dsub = cb.shape[2]
        self.dim = self.m * self.dsub
        self.meta = dict(meta or {})

    # -- training -----------------------------------------------------------
    @classmethod
    def train(cls, vecs, *, m: int = 4, bits: int = 8, seed: int = 0,
              sample: int = 65_536, iters: int = 16) -> "ProductQuantizer":
        """Fit per-subspace codebooks on a deterministic seeded sample.

        Args:
          vecs: ``(n, dim)`` training rows (numpy, or a tensor on any
            device: only the sampled rows are copied to the host).
          m: subvectors (bytes per encoded row); must divide ``dim``.
          bits: code width per subvector (``2**bits`` centroids, <= 8).
          seed: sample + init seed -- same (seed, sample, vecs) trains
            byte-identical codebooks, here and in the JAX package.
          sample: max training rows (seeded choice without replacement).
          iters: Lloyd iterations (fixed count -- no data-dependent stop,
            so training is reproducible).
        """
        x = _as_rows(vecs)
        n, dim = x.shape
        rows = cls.sample_rows(n, dim, m=m, bits=bits, seed=seed, sample=sample)
        xs = x[torch.as_tensor(rows, device=x.device)].cpu().numpy()
        return cls.fit(xs, m=m, bits=bits, seed=seed, iters=iters,
                       trained_rows=n)

    @staticmethod
    def sample_rows(n: int, dim: int, *, m: int, bits: int, seed: int,
                    sample: int) -> np.ndarray:
        """The sorted row positions :meth:`train` fits on, of ``n`` rows of
        width ``dim`` -- so a caller whose rows are spread over several
        tensors (an index's segments) can gather just those."""
        if dim % m:
            raise ValueError(f"{m=} must divide {dim=}")
        if not 1 <= bits <= 8:
            raise ValueError(f"{bits=} must be in [1, 8]")
        rng = np.random.default_rng(seed)
        take = min(int(sample), n)
        return np.sort(rng.choice(n, take, replace=False))

    @classmethod
    def fit(cls, xs: np.ndarray, *, m: int, bits: int, seed: int, iters: int,
            trained_rows: int) -> "ProductQuantizer":
        """Fit the codebooks on the sampled rows ``xs`` (host, float32) of
        :meth:`sample_rows`; ``trained_rows`` is the ``n`` they came from."""
        take, dim = xs.shape
        dsub = dim // m
        cb = np.empty((m, 1 << bits, dsub), np.float32)
        for j in range(m):
            cb[j] = _kmeans(
                xs[:, j * dsub:(j + 1) * dsub], 1 << bits, iters,
                np.random.default_rng([seed, j]),
            )
        return cls(cb, meta={"seed": int(seed), "sample": int(take),
                             "iters": int(iters),
                             "trained_rows": int(trained_rows)})

    # -- encode / decode ----------------------------------------------------
    def encode(self, vecs) -> torch.Tensor:
        """``(n, dim)`` rows -> ``(n, m)`` uint8 codes on the rows' device
        (nearest centroid per subspace by ``||c||^2 - 2 x.c``; ties break
        to the lowest code).

        Raises:
          ValueError: a row's distance to its code is not finite (the rows
            hold inf or NaN, or are too large for fp32).
        """
        x = _as_rows(vecs)
        if x.shape[-1] != self.dim:
            raise ValueError(f"dim mismatch: {x.shape[-1]} != {self.dim}")
        n = x.shape[0]
        codes = torch.empty((n, self.m), dtype=torch.uint8, device=x.device)
        finite = torch.ones((), dtype=torch.bool, device=x.device)
        for j in range(self.m):
            cb = torch.as_tensor(self.codebooks[j], device=x.device)
            for s in range(0, n, _ENCODE_CHUNK):
                sub = x[s:s + _ENCODE_CHUNK,
                        j * self.dsub:(j + 1) * self.dsub].contiguous()
                idx, dist = l2_nearest(sub, cb)
                codes[s:s + _ENCODE_CHUNK, j] = idx.to(torch.uint8)
                finite &= torch.isfinite(dist).all()
        if not bool(finite):  # one host sync for the whole encode
            raise ValueError("encode: a row's distance to its centroid is "
                             "not finite")
        return codes

    def decode(self, codes) -> np.ndarray:
        """``(n, m)`` codes -> ``(n, dim)`` reconstructed f32 rows (host)."""
        c = np.asarray(torch.as_tensor(codes).cpu())
        if c.shape[-1] != self.m:
            raise ValueError(f"code width {c.shape[-1]} != m={self.m}")
        out = np.empty((c.shape[0], self.dim), np.float32)
        for j in range(self.m):
            out[:, j * self.dsub:(j + 1) * self.dsub] = (
                self.codebooks[j][c[:, j].astype(np.int64)]
            )
        return out

    def lut(self, queries) -> np.ndarray:
        """``(q, dim)`` queries -> ``(q, m, C)`` squared-distance tables:
        ``lut[q, j, c] = ||q_j - codebook[j, c]||^2`` (the asymmetric
        distance is ``sum_j lut[q, j, codes[p, j]]``). The search builds
        its tables on the device instead (``executors._build_adc_lut``)."""
        q = np.asarray(queries, np.float32)
        sub = q.reshape(q.shape[0], self.m, self.dsub)
        diff = sub[:, :, None, :] - self.codebooks[None]
        return (diff * diff).sum(-1).astype(np.float32)

    # -- footprint ----------------------------------------------------------
    @property
    def bytes_per_row(self) -> int:
        """Resident bytes per encoded row (uint8 codes)."""
        return self.m

    @property
    def codebook_bytes(self) -> int:
        return int(self.codebooks.nbytes)

    def compression_ratio(self) -> float:
        """Full-precision bytes/row over code bytes/row (f32 baseline)."""
        return 4.0 * self.dim / self.m

    # -- serialization ------------------------------------------------------
    def to_json(self) -> dict:
        """Versioned manifest payload, the JAX package's format. Float32
        values survive the JSON round-trip exactly (f32 -> f64 is exact,
        repr(f64) round-trips), so ``from_json(to_json())`` is
        byte-identical."""
        return {
            "format": CODES_FORMAT,
            "m": int(self.m),
            "bits": int(self.bits),
            "dsub": int(self.dsub),
            "meta": dict(self.meta),
            "codebooks": [
                [[float(v) for v in cent] for cent in book]
                for book in self.codebooks
            ],
        }

    @classmethod
    def from_json(cls, d: dict) -> "ProductQuantizer":
        cb = np.asarray(d["codebooks"], np.float32)
        pq = cls(cb, meta=d.get("meta"))
        if pq.m != int(d["m"]) or pq.bits != int(d["bits"]):
            raise ValueError(
                f"codebook shape {cb.shape} disagrees with m={d['m']}/"
                f"bits={d['bits']}"
            )
        return pq

    def __repr__(self) -> str:
        return (
            f"ProductQuantizer(m={self.m}, bits={self.bits}, dim={self.dim},"
            f" bytes/row={self.bytes_per_row})"
        )
