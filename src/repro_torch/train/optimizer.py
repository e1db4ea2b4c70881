"""AdamW over dict trees of tensors: the JAX package's ``train/optimizer.py``.

fp32 moments whatever the parameter dtype; global-norm clipping; decoupled
weight decay; a linear-warmup cosine schedule. The step, the schedule and
the bias corrections are fp32 tensors on the parameters' device, computed
as the reference's ``jnp.float32`` arithmetic is (a Python float meeting an
fp32 tensor is rounded to fp32 first, as JAX's weakly typed scalars are).

``adamw_update`` updates in place: the moments, and the parameters under
``torch.no_grad()`` (each keeps its tensor, and so its ``requires_grad``),
where the reference returns new arrays. At full width that saves a copy of
the parameters and both moments. Each leaf is updated in slices of at most
``UPDATE_CHUNK`` entries: the update is elementwise, so the bits are the
same, and its temporaries stay a slice's size (DLRM-rm2's 1.66 G table
entries would otherwise need some 27 GB of them).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Union

import torch

from repro_torch.train import tree

UPDATE_CHUNK = 2**26  # entries of a leaf updated at once


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Union[float, Callable] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.1):
    """``lr(step)``: linear warmup to ``peak`` over ``warmup`` steps, then a
    cosine down to ``floor * peak`` at ``total``; an fp32 tensor."""

    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = step * peak / max(1, warmup)
        frac = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = (torch.cos(frac * math.pi) + 1) * ((1 - floor) * peak * 0.5) + floor * peak
        return torch.where(step < warmup, warm, cos)

    return lr


def init_opt_state(params):
    """``{"m", "v"}``: fp32 zeros shaped like every parameter; ``"step"``: an
    int32 0 on the parameters' device."""
    first = tree.leaves(params)[0]
    return {
        "m": tree.map_(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params),
        "v": tree.map_(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    sums = [g.float().square().sum() for g in tree.leaves(grads)]
    return torch.stack(sums).sum().sqrt()


def _update(p, g, m, v, scale, lr, bc1, bc2, cfg: AdamWConfig) -> None:
    """One slice of a leaf: its moments and parameters in place."""
    g = g.float() * scale if scale is not None else g.float()
    m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    v.mul_(cfg.b2).add_(g * (1 - cfg.b2) * g)
    delta = (m / bc1) / ((v / bc2).sqrt() + cfg.eps)
    if cfg.weight_decay:
        delta = delta + p.float() * cfg.weight_decay
    p.copy_(p.float() - lr * delta)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig):
    """One AdamW step. Returns ``(params, state, metrics)``: the same
    parameter tensors and moments, updated in place, the new step, and
    ``{"grad_norm", "lr"}`` (fp32 tensors)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    sf = step.to(torch.float32)
    lr = cfg.lr(step) if callable(cfg.lr) else torch.tensor(
        cfg.lr, dtype=torch.float32, device=sf.device)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=sf.device), sf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=sf.device), sf)
    for (_, p), g, m, v in zip(tree.items(params), tree.leaves(grads),
                               tree.leaves(state["m"]), tree.leaves(state["v"])):
        pf, gf, mf, vf = p.view(-1), g.reshape(-1), m.view(-1), v.view(-1)
        for s in range(0, pf.shape[0], UPDATE_CHUNK):
            e = s + UPDATE_CHUNK
            _update(pf[s:e], gf[s:e], mf[s:e], vf[s:e], scale, lr, bc1, bc2, cfg)
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
