"""Carry state across from the JAX package as numpy arrays.

Each function takes the reference's arrays as numpy (for example
``np.asarray(tree.levels[i])`` or the fields of a ``DistributedIndex``)
and returns the port's object on ``device``, holding copies of the arrays.
Nothing here imports the JAX package: the caller does the ``np.asarray``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.codes.pq import ProductQuantizer
from repro_torch.core.index_build import (
    DistributedIndex,
    MeshIndex,
    from_global,
    to_global,
)
from repro_torch.core.lookup import LookupTable
from repro_torch.core.tree import VocabTree
from repro_torch.device import resolve
from repro_torch.distributed.meshutil import DeviceMesh
from repro_torch.train import tree


def tree_from_numpy(levels: Sequence[np.ndarray],
                    device: str | torch.device | None = "cuda") -> VocabTree:
    dev = resolve(device)
    return VocabTree(levels=tuple(
        torch.as_tensor(np.array(lvl, np.float32), device=dev).contiguous() for lvl in levels))


def index_from_numpy(*, vecs, ids, leaves, offsets, n_valid, overflow,
                     n_leaves: int,
                     device: str | torch.device | None = "cuda",
                     mesh: DeviceMesh | None = None
                     ) -> DistributedIndex | MeshIndex:
    """The reference's global arrays (``vecs (S*R, d)``, ``offsets (S,
    L/S+1)``, ...) as an index: one shard on ``device``, or S shards on
    ``mesh`` (default: S shards on ``device`` in turn), shard ``s``'s
    block of rows on ``mesh.devices[s]``. Raises unless each shard's
    leaves are sorted ascending, the order the search kernels rely on
    (``LEAF_SENTINEL`` padding sorts last)."""
    n_shards = np.shape(offsets)[0]
    shard_leaves = np.asarray(leaves, np.int64).reshape(n_shards, -1)
    if (np.diff(shard_leaves, axis=1) < 0).any():
        raise ValueError("index_from_numpy: leaves must be sorted per shard")
    fields = dict(vecs=np.array(vecs, np.float32), ids=np.array(ids, np.int32),
                  leaves=np.array(leaves, np.int32),
                  offsets=np.array(offsets, np.int32),
                  n_valid=np.array(n_valid, np.int32),
                  overflow=np.array(overflow, np.int32))
    return from_global(fields, n_leaves=n_leaves,
                       mesh=mesh or DeviceMesh((resolve(device),) * n_shards))


def index_to_numpy(index: DistributedIndex | MeshIndex) -> dict:
    """The reference's global arrays of an index of any shard count
    (``vecs (S*R, d)``, ``ids``, ``leaves``, ``offsets (S, L/S+1)``,
    ``n_valid (S,)``, ``overflow ()``) as numpy, with ``n_leaves``."""
    out = {f: t.cpu().numpy() for f, t in to_global(index).items()}
    out["n_leaves"] = index.n_leaves
    return out


def lookup_from_numpy(*, vecs, qids, leaves, offsets,
                      device: str | torch.device | None = "cuda") -> LookupTable:
    dev = resolve(device)
    return LookupTable(
        vecs=torch.as_tensor(np.array(vecs, np.float32), device=dev).contiguous(),
        qids=torch.as_tensor(np.array(qids, np.int32), device=dev),
        leaves=torch.as_tensor(np.array(leaves, np.int32), device=dev),
        offsets=torch.as_tensor(np.array(offsets, np.int32), device=dev),
    )


def codes_from_numpy(codes, device: str | torch.device | None = "cuda"
                     ) -> torch.Tensor:
    """``(rows, m)`` uint8 PQ codes (``Index._codes[segment]``) on
    ``device``."""
    c = np.asarray(codes)
    if c.dtype != np.uint8 or c.ndim != 2:
        raise ValueError(f"codes must be (rows, m) uint8, got {c.shape} {c.dtype}")
    return torch.as_tensor(np.array(c), device=resolve(device))


def quantizer_from_numpy(codebooks, meta: dict | None = None
                         ) -> ProductQuantizer:
    """The port's quantizer over the reference's ``(m, C, dsub)`` codebooks
    (``ProductQuantizer.codebooks``, ``.meta``); the codebooks stay numpy
    on the host, as in the reference."""
    return ProductQuantizer(np.array(codebooks, np.float32), meta=meta)


def params_from_numpy(params, cfg, device: str | torch.device | None = "cuda",
                      dtype: torch.dtype | None = None):
    """The port's weights from the reference's params pytree as numpy
    arrays, one tensor a leaf of ``cfg.param_specs()`` under the
    reference's names (stacked ``(L, ...)`` weights stay stacked).
    ``dtype`` casts each weight once on ``device`` (the compute dtype gives
    the same bits as the reference's cast at every use); by default they
    stay fp32. Raises on a missing, extra or misshapen leaf."""
    dev = resolve(device)
    specs = cfg.param_specs()

    def carry(spec_tree, arrays, path):
        if not isinstance(spec_tree, dict):
            a = np.asarray(arrays)
            if tuple(a.shape) != tuple(spec_tree.shape):
                raise ValueError(f"{path}: shape {a.shape}, expected {spec_tree.shape}")
            t = torch.as_tensor(np.array(a, np.float32), device=dev)
            return t.to(dtype) if dtype is not None else t
        if set(arrays) != set(spec_tree):
            raise ValueError(f"{path or 'params'}: keys {sorted(arrays)}, "
                             f"expected {sorted(spec_tree)}")
        return {key: carry(spec_tree[key], arrays[key], f"{path}.{key}".strip("."))
                for key in sorted(spec_tree)}

    return carry(specs, params, "")


# the names of each model family's carry: one function for every spec tree
transformer_params_from_numpy = params_from_numpy
recsys_params_from_numpy = params_from_numpy
gin_params_from_numpy = params_from_numpy


def cache_from_numpy(cache, device: str | torch.device | None = "cuda"):
    """A KV cache ``{"k", "v"}`` of shape ``(L, B, S, Hkv, hd)`` (the
    reference's ``prefill``/``init_cache`` output) on ``device``, in fp32."""
    dev = resolve(device)
    out = {}
    for key in ("k", "v"):
        a = np.asarray(cache[key], np.float32)
        if a.ndim != 5:
            raise ValueError(f"cache {key}: expected (L, B, S, Hkv, hd), got {a.shape}")
        out[key] = torch.as_tensor(np.array(a), device=dev)
    return out


def train_state_from_numpy(params, state, cfg,
                           device: str | torch.device | None = "cuda"):
    """The port's ``(params, opt_state)`` from the reference's train state
    as numpy trees: fp32 weights, ``m``, ``v`` and (with compression)
    ``feedback`` shaped as ``cfg.param_specs()`` (a transformer's, a
    recsys model's or GIN's), and the int32 ``step``."""
    dev = resolve(device)
    out = {key: params_from_numpy(state[key], cfg, dev)
           for key in ("m", "v", "feedback") if key in state}
    out["step"] = torch.as_tensor(np.array(state["step"], np.int32), device=dev)
    extra = set(state) - set(out)
    if extra:
        raise ValueError(f"train state: unexpected keys {sorted(extra)}")
    return params_from_numpy(params, cfg, dev), out


def train_state_to_numpy(params, state):
    """``(params, opt_state)`` as the reference's numpy trees."""
    return tree.map_(lambda t: t.detach().cpu().numpy(), (params, state))
