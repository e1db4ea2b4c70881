from repro_torch.kernels.adcscan.ops import adc_topk  # noqa: F401
