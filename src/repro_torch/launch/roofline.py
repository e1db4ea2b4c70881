"""Roofline terms of a cell's step on the card: the counterpart of the JAX
package's ``launch/roofline.py``.

The reference divides XLA's cost of a compiled TPU program by TPU v5e
constants (197 TFLOP/s bf16, 819 GB/s HBM, 50 GB/s ICI). The port runs
the step on the card instead, so its roofline is one of measurements
against the H100's published peaks:

  compute    = model FLOPs / the peak of the cell's compute dtype
  memory     = argument bytes / HBM rate
  collective = bytes the collectives moved between devices / NVLink rate

beside the step's measured wall time, device busy time (a
``torch.profiler`` trace, ``launch/trace_cost.py``), idle share and mfu.

``hbm_bytes`` counts every argument byte read once: the floor a step must
move (a bound computed from the inputs, each read once), not what it
does move. ``wire_bytes`` are the bytes ``distributed/collectives.py``
moved between distinct devices during the step; a copy within one device
counts 0.

This module imports torch only, so ``chip_smoke.py`` loads it from its
file without importing the package (``--src`` A/B runs load another
checkout's package).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import torch

# NVIDIA H100 SXM5 80GB published peaks (NVIDIA H100 Tensor Core GPU data
# sheet), at its 700 W limit: dense bf16 tensor-core FLOP/s, fp32 FLOP/s
# without TF32, HBM3 bytes/s, NVLink 4 bytes/s in one direction
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_FP32 = 67e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9

NOT_MEASURED = "not measured"


def peak_flops(dtype: torch.dtype) -> float:
    """The peak of a compute dtype: bf16 (and fp16) on the tensor cores,
    anything else fp32 without TF32 (the port keeps TF32 off)."""
    return PEAK_FLOPS_BF16 if dtype in (torch.bfloat16, torch.float16) else PEAK_FLOPS_FP32


def bound(bytes_moved: float, flops: float, peak: float = PEAK_FLOPS_FP32
          ) -> tuple[float, str]:
    """(ms, "bytes" | "operations"): the least time the card could take,
    the larger of ``bytes_moved`` at the HBM rate and ``flops`` at
    ``peak``."""
    t_bytes = bytes_moved / HBM_BW * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, args_list, warmup: int = 2) -> tuple[float, float]:
    """(ms, wall_ms) per call of ``fn(*args)`` over ``args_list``, from CUDA
    events around the whole run, after a warm-up.

    ``wall_ms``: the host issues the calls as it goes, so the card may wait
    for it between calls. ``ms``: the stream is first held by a spin kernel
    long enough for the host to enqueue every call, so the calls run back
    to back and the events see device time only (none of the timed calls
    synchronises inside, which would drain the hold).
    """
    for args in args_list[:warmup]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for args in args_list:
        fn(*args)
    end.record()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / len(args_list)
    torch.cuda._sleep(int((2 * host_s + 1e-3) * 2e9))  # cycles at <= 2 GHz
    start.record()
    for args in args_list:
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(args_list), wall


@dataclasses.dataclass
class Roofline:
    flops: float  # model FLOPs of the step on this device
    hbm_bytes: float  # argument bytes, each read once
    wire_bytes: float  # bytes the collectives moved between devices
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    collectives: Dict[str, float]
    # measured (``NOT_MEASURED`` off the card): the untraced steps' mean
    # wall (which ``mfu`` reads), and the traced step's device busy time
    # and its own wall (which ``idle_share`` reads)
    wall_s: object = NOT_MEASURED
    device_s: object = NOT_MEASURED
    traced_wall_s: object = NOT_MEASURED
    idle_share: object = NOT_MEASURED
    mfu: object = NOT_MEASURED

    def as_dict(self):
        return dataclasses.asdict(self)


def analyze(*, flops: float, hbm_bytes: float, collectives: Dict[str, float],
            compute_dtype: torch.dtype, wall_s: Optional[float] = None,
            device_s: Optional[float] = None,
            traced_wall_s: Optional[float] = None) -> Roofline:
    """The three terms (seconds) against the H100 peaks, and the measured
    fields when the step ran on the card: ``idle_share = 1 - device_s /
    traced_wall_s`` (both of the one traced step), ``mfu = flops / (wall_s
    x peak)``, the peak of ``compute_dtype``."""
    peak = peak_flops(compute_dtype)
    wire = float(sum(collectives.values()))
    t_c, t_m, t_x = flops / peak, hbm_bytes / HBM_BW, wire / NVLINK_BW
    dom = max((("compute", t_c), ("memory", t_m), ("collective", t_x)),
              key=lambda kv: kv[1])[0]
    roof = Roofline(flops=flops, hbm_bytes=hbm_bytes, wire_bytes=wire,
                    t_compute=t_c, t_memory=t_m, t_collective=t_x, dominant=dom,
                    collectives=dict(collectives, total=wire))
    if wall_s is not None and device_s is not None and traced_wall_s is not None:
        roof.wall_s, roof.device_s, roof.traced_wall_s = wall_s, device_s, traced_wall_s
        roof.idle_share = 1.0 - device_s / traced_wall_s
        roof.mfu = flops / (wall_s * peak)
    return roof


def fused_scan_estimate(
    *,
    rows: int,
    dim: int,
    q_rows: int,
    k: int,
    block_rows: int,
    dtype_bytes: int = 4,
) -> dict:
    """First-order roofline for the fused multi-probe tile scan.

    The flops are layout-independent (every (point, query) pair costs one
    ``dim``-wide MAC, times 2); what the fused kernel changes is the HBM
    story. The reference wave sweep materialises each wave's distance
    slab and folds a ``(q_rows, 2k)`` running table through memory once
    per wave; the fused kernel keeps the running top-k on chip and emits
    one ``(q_rows, k)`` table at the end -- so its byte count is just the
    operand stream plus the output. The intensity gap between the two is
    the kernel's headroom, and it grows with ``rows / block_rows``. All
    terms are per shard; the ``t_*`` terms are against the H100's fp32
    peak (K2 multiplies in fp32) and HBM rate.
    """
    n_waves = max(1, int(rows) // max(1, int(block_rows)))
    flops = 2.0 * rows * q_rows * dim
    stream = float(rows + q_rows) * dim * dtype_bytes  # operands, once
    out = float(q_rows) * k * 8.0  # f32 dists + i32 ids
    fused_bytes = stream + out
    slab = float(rows) * q_rows * 4.0  # per-wave distance slabs, summed
    carry = float(n_waves) * q_rows * 2 * k * 8.0  # running-table folds
    reference_bytes = stream + out + slab + carry
    return {
        "flops": flops,
        "n_waves": n_waves,
        "fused_hbm_bytes": fused_bytes,
        "reference_hbm_bytes": reference_bytes,
        "fused_intensity": flops / max(1.0, fused_bytes),
        "reference_intensity": flops / max(1.0, reference_bytes),
        "t_compute": flops / PEAK_FLOPS_FP32,
        "t_memory_fused": fused_bytes / HBM_BW,
        "t_memory_reference": reference_bytes / HBM_BW,
    }


def memory_stats(argument_bytes: int, device: torch.device) -> dict:
    """``argument_bytes`` (from the cell's abstract tree), and on the card
    ``peak_bytes``: ``torch.cuda.max_memory_allocated()`` since the caller's
    ``reset_peak_memory_stats()``."""
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else NOT_MEASURED)
    return {"argument_bytes": int(argument_bytes), "peak_bytes": peak}
