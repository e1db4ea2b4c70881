"""Fused GQA flash-attention wrapper: the plain version for a CPU tensor,
a K6 CUDA kernel for a CUDA tensor; and its gradient.

Two hand-written kernels compute the forward (:func:`variant` picks one
from the dtype and the head dimension):

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
cache's leading ``Skv`` rows is passed without a copy. Either writes
each query row's log-sum-exp ``lse`` (fp32 ``(B, Hq, Sq)``) beside the
output, which the backward reads (at layer 5 of gemma3-4b the write is
within the time's run-to-run spread; a decode step of one token does not
launch K6).

:class:`FlashAttention` is the ``torch.autograd.Function``:
:func:`flash_attention` routes through it whenever grad is enabled and an
input requires grad, so a result that needs a gradient always has one. Its
backward, :func:`flash_attention_bwd`, is a kernel on a CUDA tensor and
``ref.flash_attention_bwd_ref`` on a CPU tensor. Its kernel has the
forward's two variants, by the same rule and with the same checks:

* ``"tensor_core"`` (``csrc/flashattn_bwd_tc.cu``): bf16 at hd 64, 128 and
  256. ``mma.sync`` on bf16 with fp32 accumulators, P and dS entering
  their products as two bf16 terms;
* ``"cuda_core"`` (``csrc/flashattn_bwd.cu``): fp32 at every head
  dimension and bf16 below hd 64, fp32 FMAs.

``FlashAttention`` hands the forward's ``kernel`` to its backward. The JAX
package has no VJP of its Pallas kernel (its training differentiates the
XLA attention), so the backward replaces no TPU kernel.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flashattn.ref import (
    flash_attention_bwd_ref,
    flash_attention_lse_ref,
    flash_attention_ref,
)

HEAD_DIMS = (8, 16, 32, 64, 128, 256)  # csrc/flashattn{,_bwd}.cu instantiations
TC_HEAD_DIMS = (64, 128, 256)  # csrc/flashattn{,_bwd}_tc.cu instantiations
VARIANTS = ("tensor_core", "cuda_core")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def variant(dtype: torch.dtype, hd: int) -> str:
    """The kernel that serves ``(dtype, hd)`` on the card, forward and
    backward alike."""
    return "tensor_core" if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS else "cuda_core"


def _check(name, q, k, v) -> None:
    """Raise unless the kernels take ``q``, ``k``, ``v`` (CUDA tensors)."""
    if not (q.dim() == k.dim() == v.dim() == 4):
        raise ValueError(f"{name}: q, k, v must be (B, S, H, hd)")
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if (k.shape != (B, Skv, Hkv, hd) or v.shape != k.shape or Hkv < 1
            or Hq % Hkv or not 1 <= Sq <= Skv or hd not in HEAD_DIMS):
        raise ValueError(f"{name}: unsupported shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    for t in (k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: q, k, v must share device and dtype")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: unsupported dtype {q.dtype}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the head dimension must be dense")


def _strides(q, k, v) -> tuple:
    return (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])


def _kernel(name, kernel: str | None, q, k, v, *dense) -> str:
    """The variant that runs ``name`` on ``q``, ``k``, ``v`` (and the dense
    tensors ``dense`` it also reads): ``kernel``, or the rule of
    :func:`variant`. Raises on a variant that does not take them."""
    hd = q.shape[3]
    kernel = kernel or variant(q.dtype, hd)
    if kernel not in VARIANTS:
        raise ValueError(f"{name}: no kernel {kernel!r}")
    if kernel == "tensor_core":
        if q.dtype != torch.bfloat16 or hd not in TC_HEAD_DIMS:
            raise ValueError(f"{name}: the tensor-core kernel takes bf16 "
                             f"at hd {TC_HEAD_DIMS}, not {q.dtype} at hd {hd}")
        if (any(s % 8 for s in _strides(q, k, v))
                or any(t.data_ptr() % 16 for t in (q, k, v, *dense))):
            raise ValueError(f"{name}: the tensor-core kernel reads 16-byte "
                             "rows: strides must be multiples of 8 elements and "
                             "data 16-byte aligned")
    return kernel


def _forward(q, k, v, window: int, kernel: str | None):
    """One launch of the forward kernel on CUDA tensors: ``(out, lse)``."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check("flash_attention", q, k, v)
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    kernel = _kernel("flash_attention", kernel, q, k, v)
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v)
    if kernel == "tensor_core":
        _build.launch(
            "flashattn_tc_launch", q,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B, Sq, Skv, Hq, Hkv, hd, int(window), 1.0 / math.sqrt(hd), *strides)
    else:
        _build.launch(
            "flashattn_launch", q,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B, Sq, Skv, Hq, Hkv, hd, int(window), _DTYPES[q.dtype],
            1.0 / math.sqrt(hd), *strides)
    _build.count(flash_attention, q)
    flash_attention.variant_launches[kernel] += 1
    return out, lse


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: the forward keeps ``lse`` beside
    ``out``, the backward is :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, window, kernel):
        if q.device.type == "cpu":
            out, lse = flash_attention_lse_ref(q, k, v, window=window)
        else:
            out, lse = _forward(q, k, v, window, kernel)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.kernel = window, kernel
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, window=ctx.window,
                                         kernel=ctx.kernel)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = -1, kernel: str | None = None) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention ``(B, Sq, Hq, hd)``
    in ``q.dtype``; see ref.py. ``kernel`` names a variant in place of the
    rule of :func:`variant`: a switch for measurement alone (to time and hold
    one variant against the other), which nothing in the port sets. Differentiable
    (through :class:`FlashAttention`) when grad is enabled and an input
    requires grad."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, int(window), kernel)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window=window)
    return _forward(q, k, v, window, kernel)[0]


def flash_attention_bwd(q, k, v, out, lse, dout, *, window: int = -1,
                        kernel: str | None = None):
    """``(dq, dk, dv)`` of :func:`flash_attention` at ``(q, k, v)``, given
    its ``out``, ``lse`` (fp32 ``(B, Hq, Sq)``) and the output's gradient
    ``dout``, in the dtypes of ``q``, ``k`` and ``v``: the plain version
    for a CPU tensor; for a CUDA tensor the variant the rule of
    :func:`variant` picks (``csrc/flashattn_bwd_tc.cu`` or
    ``csrc/flashattn_bwd.cu``: three kernels each, one launch of this
    wrapper). ``kernel`` forces one, as the forward's does: a switch for
    measurement alone, which nothing in the port sets but ``FlashAttention``
    handing on the forward's."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    _check("flash_attention_bwd", q, k, v)
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out, dout = out.contiguous(), dout.to(q.dtype).contiguous()
    for t, name in ((out, "out"), (dout, "dout")):
        if t.shape != q.shape or t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention_bwd: {name} must match q")
    if (lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError("flash_attention_bwd: lse must be a dense fp32 (B, Hq, Sq)")
    kernel = _kernel("flash_attention_bwd", kernel, q, k, v, out, dout)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((B, Skv, Hkv, hd), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    d = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)  # D scratch
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), d.data_ptr(),
            B, Sq, Skv, Hq, Hkv, hd, int(window))
    if kernel == "tensor_core":
        _build.launch("flashattn_bwd_tc_launch", q, *args, 1.0 / math.sqrt(hd),
                      *_strides(q, k, v))
    else:
        _build.launch("flashattn_bwd_launch", q, *args, _DTYPES[q.dtype],
                      1.0 / math.sqrt(hd), *_strides(q, k, v))
    _build.count(flash_attention_bwd, q)
    flash_attention_bwd.variant_launches[kernel] += 1
    return dq, dk, dv


_build.counters(flash_attention)  # every forward launch
flash_attention.variant_launches = dict.fromkeys(VARIANTS, 0)
_build.counters(flash_attention_bwd)  # every backward launch
flash_attention_bwd.variant_launches = dict.fromkeys(VARIANTS, 0)
