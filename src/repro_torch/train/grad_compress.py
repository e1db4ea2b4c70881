"""Gradient compression with fp32 error feedback: the JAX package's
``train/grad_compress.py``.

``bf16_compress`` rounds each gradient plus its residual to bf16 and keeps
what the rounding lost; ``topk_compress`` keeps each leaf's k = max(1,
int(n * fraction)) largest magnitudes (every entry at least the k-th
largest |x|, so ties may keep more) and carries the rest. Either way the
sent gradients plus the new residual equal the gradients plus the old
residual. Both run before the cross-replica reduction (one card here).
"""

from __future__ import annotations

import torch

from repro_torch.train import tree


def init_feedback(params):
    return tree.map_(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)


def bf16_compress(grads, feedback):
    """(compressed bf16 grads, new fp32 residual)."""

    def one(g, r):
        acc = g.float() + r
        q = acc.to(torch.bfloat16)
        return q, acc - q.float()

    return _apply(one, grads, feedback)


def topk_compress(grads, feedback, *, fraction: float = 0.01):
    """(sparse grads, densified with zeros off the support; new residual)."""

    def one(g, r):
        acc = g.float() + r
        flat = acc.reshape(-1)
        k = max(1, int(flat.shape[0] * fraction))
        thresh = torch.topk(flat.abs(), k).values[-1]
        kept = flat * (flat.abs() >= thresh).to(torch.float32)
        return kept.reshape(acc.shape), (flat - kept).reshape(acc.shape)

    return _apply(one, grads, feedback)


def _apply(one, grads, feedback):
    """``one(g, r) -> (sent, residual)`` over every leaf, as two trees."""
    pairs = [one(g, r) for g, r in zip(tree.leaves(grads), tree.leaves(feedback))]
    return (tree.unflatten(grads, [a for a, _ in pairs]),
            tree.unflatten(grads, [b for _, b in pairs]))
