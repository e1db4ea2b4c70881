"""Train steps: microbatch accumulation, optimizer, compression --
the JAX package's ``train/step.py``.

``make_train_step(loss_fn, opt_cfg)`` returns ``train_step(params,
opt_state, batch) -> (params, opt_state, metrics)``. ``loss_fn(params,
batch)`` returns ``(loss, aux)``; the step differentiates it with
``torch.autograd.grad`` over every parameter leaf (each is made to require
grad if it does not), then updates the parameters in place.

Options:
  * ``microbatches=m``: the batch's leading dimension splits into m chunks,
    whose gradients accumulate in fp32 as ``g / m``, in chunk order (the
    reference's ``lax.scan``); aux is averaged over the chunks in fp32.
  * ``compress="bf16"|"topk"``: gradient compression with fp32 error
    feedback carried in ``opt_state["feedback"]`` (``grad_compress.py``).

``metrics`` holds ``grad_norm`` and ``lr`` (the optimizer's) and aux's
``loss`` and ``moe_drops``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.train import grad_compress, tree
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state


def init_train_state(params, *, compress: Optional[str] = None):
    state = init_opt_state(params)
    if compress:
        state["feedback"] = grad_compress.init_feedback(params)
    return state


def _chunks(batch, m: int) -> list:
    """``batch`` (a dict of arrays or tensors) as m chunks of its leading
    dimension."""
    n = len(next(iter(batch.values())))
    if n % m:
        raise ValueError(f"batch of {n} rows does not split into {m} microbatches")
    size = n // m
    return [{key: x[i * size:(i + 1) * size] for key, x in batch.items()}
            for i in range(m)]


def _mean(values) -> torch.Tensor:
    return torch.stack([torch.as_tensor(v).to(torch.float32) for v in values]).mean()


def make_train_step(
    loss_fn: Callable,
    opt_cfg: AdamWConfig,
    *,
    microbatches: int = 1,
    compress: Optional[str] = None,
    topk_fraction: float = 0.01,
):
    if compress not in (None, "bf16", "topk"):
        raise ValueError(f"unknown compress {compress!r}")

    def grads_of(params, batch):
        leaves = tree.leaves(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        loss, aux = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        aux = {key: (v.detach() if isinstance(v, torch.Tensor) else v)
               for key, v in aux.items()}
        return grads, aux

    def compute_grads(params, batch):
        if microbatches == 1:
            flat, aux = grads_of(params, batch)
        else:
            flat, auxes = None, []
            for chunk in _chunks(batch, microbatches):
                g, aux = grads_of(params, chunk)
                if flat is None:
                    flat = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                            for x in g]
                for acc, x in zip(flat, g):
                    acc.add_(x.float() / microbatches)
                del g
                auxes.append(aux)
            aux = {key: _mean([a[key] for a in auxes]) for key in auxes[0]}
        return tree.unflatten(params, flat), aux

    def train_step(params, opt_state, batch):
        grads, aux = compute_grads(params, batch)
        feedback = None
        if compress == "bf16":
            grads, feedback = grad_compress.bf16_compress(grads, opt_state["feedback"])
        elif compress == "topk":
            grads, feedback = grad_compress.topk_compress(
                grads, opt_state["feedback"], fraction=topk_fraction)
        core = {key: v for key, v in opt_state.items() if key != "feedback"}
        params, core, metrics = adamw_update(params, grads, core, opt_cfg)
        if feedback is not None:
            core["feedback"] = feedback
        metrics.update(aux)
        return params, core, metrics

    return train_step

