"""L2-distance algebra used everywhere (index build, search, k-means refine).

All entry points use the expansion  ||x - c||^2 = ||x||^2 - 2 x.c + ||c||^2
so the inner loop is a matrix product. The ``x`` norm term is dropped where
only an argmin/top-k over ``c`` is needed.

Float32 products stay in full float32: TF32 would break the 2e-4 distance
contract and the tie order (``torch.backends.cuda.matmul.allow_tf32`` is
left at its default, False).
"""

from __future__ import annotations

import torch


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Row squared norms, accumulated in fp32."""
    xf = x.float()
    return (xf * xf).sum(-1)


def sq_dists(x: torch.Tensor, c: torch.Tensor,
             c_norms: torch.Tensor | None = None) -> torch.Tensor:
    """Full (n, m) squared distances between rows of x (n,d) and c (m,d)."""
    if c_norms is None:
        c_norms = sq_norms(c)
    dots = x.float() @ c.float().T
    return sq_norms(x)[:, None] - 2.0 * dots + c_norms[None, :]


def nearest(x: torch.Tensor, c: torch.Tensor,
            c_norms: torch.Tensor | None = None):
    """(argmin, min_sqdist) of each row of x over centroid rows c.

    The ||x||^2 term is omitted from the argmin and added back to the
    returned distance. ``torch.argmin`` returns the first minimum, the
    same tie rule as ``jnp.argmin``.
    """
    if c_norms is None:
        c_norms = sq_norms(c)
    dots = x.float() @ c.float().T
    partial = c_norms[None, :] - 2.0 * dots  # (n, m)
    idx = torch.argmin(partial, dim=1)
    best = partial.min(dim=1).values + sq_norms(x)
    return idx.to(torch.int32), best


def topk_lex(values: torch.Tensor, k: int):
    """(values, indices) of the k smallest along the last axis, ascending by
    ``(value, index)``: ties go to the lower index.

    This is the order ``jax.lax.top_k`` gives on negated values;
    ``torch.topk`` promises no order on ties, so every top-k of the port
    goes through here. Indices are int64.
    """
    vals, idx = torch.sort(values, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_neighbors(x: torch.Tensor, c: torch.Tensor, k: int,
                   c_norms: torch.Tensor | None = None):
    """(indices, sq_dists) of the k nearest rows of c for each row of x."""
    d2 = sq_dists(x, c, c_norms)
    vals, idx = topk_lex(d2, k)
    return idx.to(torch.int32), vals
