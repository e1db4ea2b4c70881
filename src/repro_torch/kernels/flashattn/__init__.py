from repro_torch.kernels.flashattn.ops import flash_attention  # noqa: F401
