"""A traced step's cost by source: the counterpart of the JAX package's
``launch/hlo_cost.py``.

The reference parses a compiled TPU program's HLO text and charges each
op's FLOPs, bytes and wire bytes to its source (``op_name`` metadata),
loop bodies times their trip counts. The port has no HLO: it runs the
step and reads a ``torch.profiler`` trace of it. :class:`Cost` keeps the
reference's interface (``add_source``, ``top_sources(n, key)``), keyed by
kernel name: the kernel's device ms, its launches (the counterpart of a
loop's trip count) and its share of the device's busy time.

On the CPU (the tests) a trace reports structure only: the operators'
names and call counts. A CPU time is never written under a device
field's name.

This module imports torch only, so ``chip_smoke.py`` loads it from its
file without importing the package.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import torch

NOT_MEASURED = "not measured"


def device_trace(fn):
    """(device-side profiler events, device busy s) of one call of ``fn``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    # device-side events only: a CPU op's device time repeats its kernels'
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return ev, sum(e.self_device_time_total for e in ev) / 1e6


def top_ops_line(name: str, ev, busy: float, wall: float, n_top: int) -> str:
    """One line: the trace's device busy time against ``wall``, and its
    ``n_top`` kernels by device time with their launches."""
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:n_top]
    return (f"trace {name}: device busy {busy} s of {wall} s wall "
            f"(idle share {1 - busy / wall}); top device time: " + "; ".join(
                f"{e.key[:60]} {e.self_device_time_total / 1e3} ms x{e.count}"
                for e in top))


@dataclasses.dataclass
class Cost:
    """A traced step by source: ``by_source[name] = [device ms, launches]``
    (device ms ``None`` when the trace ran on the CPU)."""

    device_s: object = NOT_MEASURED  # the device's busy time
    wall_s: object = NOT_MEASURED  # the traced step's wall, synchronised, inside the trace
    by_source: Dict[str, list] = dataclasses.field(default_factory=dict)

    def add_source(self, key: str, ms, launches: int):
        cur = self.by_source.get(key, [None if ms is None else 0.0, 0])
        if ms is not None:
            cur[0] = (cur[0] or 0.0) + ms
        cur[1] += launches
        self.by_source[key] = cur

    def top_sources(self, n: int = 8, key: str = "device") -> list:
        """``n`` rows ``(name, device ms, launches, share of busy time)``,
        by device time (``key="device"``) or by launches."""
        idx = {"device": 0, "launches": 1}[key]
        rows = sorted(self.by_source.items(), key=lambda kv: -(kv[1][idx] or 0))[:n]
        out = []
        for name, (ms, launches) in rows:
            if ms is None or not isinstance(self.device_s, float) or not self.device_s:
                out.append((name, NOT_MEASURED, launches, NOT_MEASURED))
            else:
                out.append((name, ms, launches, ms / 1e3 / self.device_s))
        return out

    def top_records(self, n: int = 8, key: str = "device") -> list:
        """:meth:`top_sources` as dicts, each name cut to 120 characters (a
        templated kernel's name runs to thousands)."""
        return [dict(name=name[:120], device_ms=ms, launches=launches, share=share)
                for name, ms, launches, share in self.top_sources(n, key)]


def trace(fn, device: torch.device) -> Cost:
    """The :class:`Cost` of one call of ``fn`` on ``device``: on the card
    each kernel's device ms and launches, and the call's own wall (from a
    synchronised start to a synchronised end, the profiler running); on
    the CPU each operator's calls."""
    if device.type == "cuda":
        walls = []

        def timed():
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(device)
            walls.append(time.perf_counter() - t0)

        ev, busy = device_trace(timed)
        cost = Cost(device_s=busy, wall_s=walls[0])
        for e in ev:
            cost.add_source(e.key, e.self_device_time_total / 1e3, e.count)
        return cost
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    cost = Cost()
    for e in prof.key_averages():
        cost.add_source(e.key, None, e.count)
    return cost
