"""Plain PyTorch version of fused (flash) attention.

Semantics: grouped-query causal attention with optional sliding window --
exactly ``repro_torch.models.transformer.attend`` with q_pos/kv_pos = arange.

  q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd); Hq % Hkv == 0
  causal mask uses absolute positions with q offset = Skv - Sq
  window > 0 limits attention to the last ``window`` positions.

The logits are formed in fp32 from the inputs (a bf16 product is exact in
fp32), masked scores are -1e30, the softmax is fp32 and is cast to
``v.dtype`` before the PV product. Float32 products stay in full float32:
TF32 is switched off for matmuls and for cuDNN, and bf16 products keep
fp32 partial sums (no reduced-precision split-K), so this version is a
fair oracle for the kernel.
"""

from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: int = -1) -> torch.Tensor:
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd).float()
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * (1.0 / math.sqrt(hd))
    q_pos = torch.arange(Sq, device=q.device) + (Skv - Sq)
    kv_pos = torch.arange(Skv, device=q.device)
    dist = q_pos[:, None] - kv_pos[None, :]
    mask = dist >= 0
    if window > 0:
        mask &= dist < window
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Sq, Hq, hd)
