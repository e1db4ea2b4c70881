"""Checkpoints with integrity manifests, byte-compatible with the JAX
package's ``distributed/checkpoint.py``.

A checkpoint is a directory ``step_<step:010d>/`` holding one ``.npy`` per
array and a JSON manifest carrying step, shapes, dtypes and crc32s. The
JAX package names each array by its pytree path; here the caller passes
the same names in an explicit table (``{"index/0": vecs, ...}``, see
:mod:`repro_torch.index.segment`), and the file is the name with ``/``
spelled ``__`` (``index__0.npy``). Dtypes are written as the JAX package
spells them (``"float32"``, ``"int32"``, ``"bfloat16"``); bfloat16 arrays
go to disk as their raw bytes in a ``uint8`` array, and each crc32 is taken
over the bytes in the file. Writes are atomic (``<step>.tmp`` -> rename),
so a failure mid-save never corrupts the latest checkpoint, and ``keep``
bounds the steps kept.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch.device import dtype_name

#: torch dtypes numpy has no type for: stored as raw bytes (uint8)
_RAW_DTYPES = {"bfloat16": torch.bfloat16}


def crc32(arr: np.ndarray) -> int:
    """crc32 of a C-contiguous array's bytes, read in place (zlib releases
    the interpreter lock while it runs, so this overlaps other work)."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def to_host(x) -> tuple[np.ndarray, str]:
    """(the array to write, its manifest dtype): a tensor is copied to the
    host (from the card into page-locked memory, which copies several
    times faster than pageable), a bfloat16 one as raw bytes."""
    if isinstance(x, torch.Tensor):
        name = dtype_name(x.dtype)
        if x.device.type == "cuda":
            t = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            t.copy_(x)
        else:
            t = x.detach().contiguous()
        if name in _RAW_DTYPES:
            return t.reshape(-1).view(torch.uint8).numpy(), name
        return t.numpy(), name
    arr = np.asarray(x)
    return arr, dtype_name(arr.dtype)


def from_file(arr: np.ndarray, meta: dict) -> torch.Tensor:
    """The tensor a restored file holds: raw bytes viewed as their dtype."""
    if meta["dtype"] in _RAW_DTYPES and arr.dtype == np.uint8:
        return (torch.from_numpy(np.ascontiguousarray(arr))
                .view(_RAW_DTYPES[meta["dtype"]]).reshape(meta["shape"]))
    return torch.from_numpy(np.asarray(arr))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- paths ------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read_manifest(self, step: Optional[int] = None) -> dict:
        """The manifest of ``step`` (default: latest) without loading any
        array."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            return json.load(f)

    # -- save / restore ----------------------------------------------------
    def save(self, step: int, arrays: dict, extra: Optional[dict] = None) -> str:
        """Write ``arrays`` (name -> tensor or numpy array, in the order
        the manifest lists them) as checkpoint ``step``; returns its
        directory."""
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra or {}, "leaves": {}}
        with ThreadPoolExecutor(max_workers=1) as pool:
            for key, x in arrays.items():
                arr, dtype = to_host(x)
                fname = key.replace("/", "__") + ".npy"
                crc = pool.submit(crc32, arr)  # overlaps the write
                np.save(os.path.join(tmp, fname), arr)
                manifest["leaves"][key] = {
                    "file": fname,
                    "shape": list(x.shape),
                    "dtype": dtype,
                    "crc32": crc.result(),
                }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def restore(self, keys, step: Optional[int] = None, device=None):
        """Load the arrays named ``keys`` of ``step`` (default: latest),
        each crc-checked, as tensors on ``device`` (default: the host).
        Returns ``({key: tensor}, manifest)``.

        Raises:
          FileNotFoundError: no checkpoint; KeyError: a key is missing;
          IOError: a file's crc32 differs from the manifest's.
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        out = {}
        with ThreadPoolExecutor(max_workers=1) as pool:
            for key in keys:
                meta = manifest["leaves"].get(key)
                if meta is None:
                    raise KeyError(f"leaf {key} missing from checkpoint {d}")
                arr = np.load(os.path.join(d, meta["file"]))
                crc = pool.submit(crc32, arr)  # overlaps the copy to the device
                t = from_file(arr, meta)
                if device is not None and torch.device(device).type == "cuda":
                    # through page-locked memory: several times faster
                    t = t.pin_memory().to(device, non_blocking=True)
                elif device is not None:
                    t = t.to(device)
                if crc.result() != meta["crc32"]:
                    raise IOError(f"crc mismatch for {key} in {d}")
                out[key] = t
        return out, manifest
