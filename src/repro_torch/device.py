"""Where the port runs: the card, unless the caller asks for the CPU."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device: str | torch.device | None = DEFAULT_DEVICE) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``None`` means the default, the card. A CUDA device on a machine
    without one raises: nothing falls back to the CPU unless asked.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions"
            )
        if dev.index is None:  # name the device, so it compares equal to tensors'
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def dtype_name(dtype) -> str:
    """A torch or numpy dtype's name as the JAX package spells it
    (``jnp.dtype(...).name``): ``"float32"``, ``"bfloat16"``."""
    return str(dtype).removeprefix("torch.")


def check_kernel_inputs(name: str, *tensors: torch.Tensor, dtypes) -> None:
    """Raise unless every tensor is contiguous, of its dtype, on one CUDA
    device (the kernels take nothing else)."""
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
