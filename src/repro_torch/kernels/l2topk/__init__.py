from repro_torch.kernels.l2topk.ops import l2_topk  # noqa: F401
