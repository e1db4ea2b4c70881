from repro_torch.kernels.fusedscan.ops import fused_topk  # noqa: F401
