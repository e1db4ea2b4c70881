from repro_torch.kernels.l2nn.ops import l2_nearest  # noqa: F401
