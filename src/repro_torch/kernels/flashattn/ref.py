"""Plain PyTorch version of fused (flash) attention and of its gradient.

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
fair oracle for the kernel. float64 inputs are computed in float64.

The gradient (``flash_attention_bwd_ref``) is the explicit formulas the
backward kernel evaluates, not autograd: from the forward's ``out`` and
its per-row log-sum-exp ``lse`` (fp32 ``(B, Hq, Sq)``), with the same
scores, mask and scale,

  P = exp(s - lse),  D = rowsum(dout * out),  dS = P * (dout V^T - D),
  dq = scale dS K,   dk = scale sum_g dS^T Q,  dv = sum_g P^T dout,

in fp32, each gradient rounded to its input's dtype once (the sums over g
run over the query heads of a KV head's group).
"""

from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _acc(t: torch.Tensor) -> torch.dtype:
    """The dtype sums are taken in: fp32, or float64 for float64 inputs."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def attention_mask(sq: int, skv: int, window: int, device) -> torch.Tensor:
    """``(Sq, Skv)`` bool: query row i sees key j iff 0 <= (i + Skv - Sq) - j
    < window (no upper limit when window <= 0)."""
    dist = ((torch.arange(sq, device=device) + (skv - sq))[:, None]
            - torch.arange(skv, device=device)[None, :])
    mask = dist >= 0
    if window > 0:
        mask &= dist < window
    return mask


def _scores(q, k, mask) -> torch.Tensor:
    """Masked scaled scores ``(B, Hkv, G, Sq, Skv)`` in ``_acc(q)``."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    acc = _acc(q)
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, hd).to(acc)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(acc)) * (1.0 / math.sqrt(hd))
    return torch.where(mask, logits, -1e30)


def _attend(logits, v, shape) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v).reshape(shape)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: int = -1) -> torch.Tensor:
    mask = attention_mask(q.shape[1], k.shape[1], window, q.device)
    return _attend(_scores(q, k, mask), v, q.shape)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            window: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_ref``'s output and each query row's log-sum-exp of
    the same scores, ``(B, Hq, Sq)`` in fp32 (float64 for float64 inputs)."""
    B, Sq, Hq, _ = q.shape
    logits = _scores(q, k, attention_mask(Sq, k.shape[1], window, q.device))
    lse = torch.logsumexp(logits, dim=-1).reshape(B, Hq, Sq)
    return _attend(logits, v, q.shape), lse


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, window: int = -1):
    """``(dq, dk, dv)`` of flash attention by the formulas in the module
    docstring, in the dtypes of ``q``, ``k`` and ``v``."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    acc = _acc(q)
    mask = attention_mask(Sq, k.shape[1], window, q.device)
    p = torch.exp(_scores(q, k, mask)
                  - lse.reshape(B, Hkv, G, Sq, 1).to(acc))  # masked: exactly 0
    dog = dout.reshape(B, Sq, Hkv, G, hd).to(acc)
    d = (dog * out.reshape(B, Sq, Hkv, G, hd).to(acc)).sum(-1)  # (B, Sq, Hkv, G)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dog, v.to(acc))
    ds = p * (dp - d.permute(0, 2, 3, 1)[..., None])
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, Hkv, G, hd).to(acc)
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, k.to(acc)) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qg) * scale
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dog)
    return (dq.reshape(B, Sq, Hq, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
