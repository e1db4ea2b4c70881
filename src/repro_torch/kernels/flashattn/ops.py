"""Fused GQA flash-attention wrapper: the plain version for a CPU tensor,
a K6 CUDA kernel for a CUDA tensor.

Two hand-written kernels compute the same function (:func:`variant` picks
one from the dtype and the head dimension):

* ``"tensor_core"`` (``csrc/flashattn_tc.cu``): bf16 at hd 64, 128 and 256,
  every full config of ``configs/lm.py``. ``mma.sync`` on bf16 with fp32
  accumulators; every (B, S, H) stride of q, k and v must be a multiple of 8
  elements and every data pointer 16-byte aligned (16-byte ``cp.async``
  rows), else the wrapper raises;
* ``"cuda_core"`` (``csrc/flashattn.cu``): fp32 at every head dimension,
  and bf16 below hd 64. fp32 FMAs on the CUDA cores: tensor cores on fp32
  would be TF32, which the fp32 bound rejects (ROADMAP P5).

Both read q, k and v in the reference's ``(B, S, H, hd)`` layout through
their strides (the last dimension must be dense), so a view such as a KV
cache's leading ``Skv`` rows is passed without a copy.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flashattn.ref import flash_attention_ref

HEAD_DIMS = (8, 16, 32, 64, 128, 256)  # csrc/flashattn.cu instantiations
TC_HEAD_DIMS = (64, 128, 256)  # csrc/flashattn_tc.cu instantiations
VARIANTS = ("tensor_core", "cuda_core")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def variant(dtype: torch.dtype, hd: int) -> str:
    """The kernel that serves ``(dtype, hd)`` on the card."""
    return "tensor_core" if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS else "cuda_core"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = -1, kernel: str | None = None) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention ``(B, Sq, Hq, hd)``
    in ``q.dtype``; see ref.py. ``kernel`` names a variant in place of the
    rule of :func:`variant` (to time one against the other)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not (q.dim() == k.dim() == v.dim() == 4):
        raise ValueError("flash_attention: q, k, v must be (B, S, H, hd)")
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if (k.shape != (B, Skv, Hkv, hd) or v.shape != k.shape or Hkv < 1
            or Hq % Hkv or not 1 <= Sq <= Skv or hd not in HEAD_DIMS):
        raise ValueError(f"flash_attention: unsupported shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    for t in (k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("flash_attention: q, k, v must share device and dtype")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: unsupported dtype {q.dtype}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dimension must be dense")
    kernel = kernel or variant(q.dtype, hd)
    if kernel not in VARIANTS:
        raise ValueError(f"flash_attention: no kernel {kernel!r}")
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    if kernel == "tensor_core":
        if q.dtype != torch.bfloat16 or hd not in TC_HEAD_DIMS:
            raise ValueError(f"flash_attention: the tensor-core kernel takes bf16 "
                             f"at hd {TC_HEAD_DIMS}, not {q.dtype} at hd {hd}")
        if any(s % 8 for s in strides) or any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("flash_attention: the tensor-core kernel reads 16-byte "
                             "rows: strides must be multiples of 8 elements and "
                             "data 16-byte aligned")
        _build.launch(
            "flashattn_tc_launch", q,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, Hq, Hkv, hd, int(window), 1.0 / math.sqrt(hd),
            *strides)
    else:
        _build.launch(
            "flashattn_launch", q,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, Hq, Hkv, hd, int(window), _DTYPES[q.dtype],
            1.0 / math.sqrt(hd), *strides)
    _build.count(flash_attention, q)
    flash_attention.variant_launches[kernel] += 1
    return out


_build.counters(flash_attention)  # every launch
flash_attention.variant_launches = dict.fromkeys(VARIANTS, 0)
