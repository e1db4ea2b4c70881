"""Fused GQA flash-attention wrapper: the plain version for a CPU tensor,
the K6 CUDA kernel (``csrc/flashattn.cu``) for a CUDA tensor.

The kernel reads q, k and v in the reference's ``(B, S, H, hd)`` layout
through their strides (the last dimension must be dense), so a view such
as a KV cache's leading ``Skv`` rows is passed without a copy.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flashattn.ref import flash_attention_ref

HEAD_DIMS = (8, 16, 32, 64, 128, 256)  # csrc/flashattn.cu instantiations
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = -1) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention ``(B, Sq, Hq, hd)``
    in ``q.dtype``; see ref.py."""
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
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    err = _build.lib().flashattn_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Skv, Hq, Hkv, hd, int(window), _DTYPES[q.dtype],
        1.0 / math.sqrt(hd),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        _build.stream_ptr(q))
    _build.check(err, "flashattn_launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
