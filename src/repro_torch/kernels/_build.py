"""Build and load the port's CUDA kernels at first use.

Every ``src/repro_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
(one process per source, all started together), linked into one shared
library with a plain C interface, and loaded with ``ctypes``. The library
lands in ``build/kernels/`` at the repository root, named by a hash of the
sources and flags, so an edited source is never served from a stale build.
Nothing is built when a module is imported: :func:`lib` builds on its first
call, which only a wrapper handed a CUDA tensor makes.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` calls one with the tensor's device
made current -- the launchers set function attributes and read occupancy
per device, on the current one -- and raises if that is not 0.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
# C signatures of the entry points in csrc/*.cu
SIGNATURES = {
    "l2topk_launch": [_VP] * 7 + [_I] * 4 + [_VP],
    "l2topk_clusters": [_VP],
    "fusedscan_launch": [_VP] * 8 + [_I] * 4 + [_VP],
    "l2nn_launch": [_VP] * 4 + [_I] * 3 + [_VP],
    "adcscan_launch": [_VP] * 8 + [_I] * 6 + [_VP],
    "fusedadc_launch": [_VP] * 7 + [_I] * 5 + [_VP],
    "l2topk_wide_launch": [_VP] * 10 + [_I] * 4 + [_VP],
    "adctopk_wide_launch": [_VP] * 11 + [_I] * 6 + [_VP],
    "flashattn_launch": [_VP] * 5 + [_I] * 8 + [_F] + [_LL] * 9 + [_VP],
    "flashattn_tc_launch": [_VP] * 5 + [_I] * 7 + [_F] + [_LL] * 9 + [_VP],
    "flashattn_bwd_launch": [_VP] * 10 + [_I] * 8 + [_F] + [_LL] * 9 + [_VP],
    "flashattn_bwd_tc_launch": [_VP] * 10 + [_I] * 7 + [_F] + [_LL] * 9 + [_VP],
    "segsum_items_launch": [_VP] * 6 + [_LL, _I] + [_VP],
    "segsum_tree_launch": [_VP] * 4 + [_I] * 2 + [_VP],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of this process's build
ptxas_report: str = ""  # nvcc -Xptxas -v output of this process's build


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    global build_seconds, ptxas_report
    t0 = time.perf_counter()
    nvcc = _nvcc()
    work = BUILD_DIR / f"tmp-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for src in _sources():
        obj = work / (src.stem + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    for src, proc in zip(_sources(), procs):
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            for other in procs:
                other.kill()
                other.wait()
            raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
    tmp_so = work / target.name
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         *map(str, objs), "-o", str(tmp_so)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp_so, target)  # atomic: a concurrent build never sees half a file
    shutil.rmtree(work, ignore_errors=True)
    ptxas_report = "\n".join(logs)
    build_seconds = time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built from the repository's sources on
    first use."""
    global _lib
    with _lock:
        if _lib is None:
            target = BUILD_DIR / f"libkernels-{_digest()}.so"
            if not target.exists():
                _build(target)
            so = ctypes.CDLL(str(target))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = so
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def ptr(t: torch.Tensor | None) -> int:
    """``t``'s device address for ctypes, 0 (a null pointer) for None."""
    return 0 if t is None else t.data_ptr()


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as an int for ctypes."""
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, t: torch.Tensor, *args) -> None:
    """Call the C entry point ``name`` with ``args`` and the current stream
    of ``t``'s device, with that device current, and raise on a CUDA
    error. ``t`` is a tensor of the launch, on the device it runs on."""
    fn = getattr(lib(), name)
    if t.device.index == torch.cuda.current_device():
        check(fn(*args, stream_ptr(t)), name)  # the common case: no switch
    else:
        with torch.cuda.device(t.device):
            check(fn(*args, stream_ptr(t)), name)


def count(wrapper, t: torch.Tensor) -> None:
    """One launch of ``wrapper``'s kernel, on ``t``'s device: its
    ``launches`` and its ``by_device[device index]``."""
    wrapper.launches += 1
    wrapper.by_device[t.device.index] += 1


def counters(wrapper) -> None:
    """Give ``wrapper`` zeroed launch counters."""
    wrapper.launches = 0
    wrapper.by_device = collections.Counter()
