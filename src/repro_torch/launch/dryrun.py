"""The cell registry's dry-run: the counterpart of the JAX package's
``launch/dryrun.py``.

The reference lowers every (architecture x shape) cell for a 256- or
512-chip TPU mesh and reads XLA's cost of it. The port has two modes:

* ``--abstract`` (no card needed): for each cell the reference's record
  fields -- its kind, model FLOPs, status, and the argument bytes one
  device of the layout holds (``distributed.partitioning``) -- on
  ``16x16``, ``2x16x16`` (``--multi-pod``, ``--both-meshes``) or the
  one-card layout ``card`` (``--meshes``), where the record adds the cut
  the cell would run at (:meth:`Cell.card_cut`).
* measured (the default): each cell built on ``--device`` at its card
  cut, a warm-up call (``warmup_s``, the kernels' build included), a few
  synchronised steps (``wall_s``), one traced step (device busy time,
  idle share against that step's own wall, the top 8 device ops with
  their launches, the kernel wrappers' launches), and the
  :class:`~repro_torch.launch.roofline.Roofline` against the H100's peaks
  with its ``mfu`` (from the cell's step FLOPs, :meth:`Cell.step_flops`). A cell that does not fit
  one card even at batch 1 is a ``"skip"`` whose reason gives its bytes
  and the smallest layout that would hold it. An out-of-memory error is
  that record's failure, never a signal to retry smaller.

As the reference does, a cell that raises is written as ``status:
"error"`` and the others go on; the process then exits 1. Measuring more
than one cell, each runs in a process of its own (the reference's advice,
one cell a process), forked from a server that has imported torch and
never touched the card: a late cell then finds the allocator empty, and
its trace whole (in one long process the profiler's traces of late cells
lost hand-written kernels' events). Without a card and without ``--device
cpu`` the measured mode raises (there is no fallback to the CPU); on the
CPU its device fields read "not measured".

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list
  PYTHONPATH=src python -m repro_torch.launch.dryrun --abstract --all \\
      [--meshes 16x16 2x16x16 card] [--out records.jsonl]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gin-tu \\
      --shape molecule [--device cpu] [--out records.jsonl]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out records.jsonl
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import multiprocessing
import subprocess
import sys
import time

import torch

MESHES = {"16x16": dict(multi_pod=False), "2x16x16": dict(multi_pod=True)}

#: the hand-written kernels' wrappers (module, name), whose ``launches``
#: count each launch of a kernel on the card
KERNEL_WRAPPERS = {
    "l2topk": ("repro_torch.kernels.l2topk.ops", "l2_topk"),
    "fusedscan": ("repro_torch.kernels.fusedscan.ops", "fused_topk"),
    "l2nn": ("repro_torch.kernels.l2nn.ops", "l2_nearest"),
    "adcscan": ("repro_torch.kernels.adcscan.ops", "adc_topk"),
    "fusedadc": ("repro_torch.kernels.fusedscan.ops", "fused_adc_topk"),
    "flashattn": ("repro_torch.kernels.flashattn.ops", "flash_attention"),
    "flashattn_bwd": ("repro_torch.kernels.flashattn.ops", "flash_attention_bwd"),
    "segsum": ("repro_torch.kernels.segsum.ops", "segsum"),
}


def wrappers() -> dict:
    return {name: getattr(importlib.import_module(mod), fn)
            for name, (mod, fn) in KERNEL_WRAPPERS.items()}


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0
        for variant in getattr(fn, "variant_launches", {}):
            fn.variant_launches[variant] = 0


def launches() -> dict:
    """Each kernel wrapper's launches since :func:`reset_launches` (those
    launched at least once), and K6's by variant (``flashattn.tensor_core``)."""
    out = {}
    for name, fn in wrappers().items():
        counts = {name: fn.launches, **{f"{name}.{v}": n for v, n in
                                        getattr(fn, "variant_launches", {}).items()}}
        out.update({k: n for k, n in counts.items() if n})
    return out


def device_info(dev: torch.device) -> dict:
    """The card's name, power limit (as ``nvidia-smi`` gives it) and count."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": "not measured", "count": 0}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
        limit = smi.splitlines()[dev.index or 0].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "not measured"
    return {"name": torch.cuda.get_device_name(dev), "power_limit": limit,
            "count": torch.cuda.device_count()}


def _base(cell, mesh: str) -> dict:
    return {"arch": cell.arch, "shape": cell.shape, "mesh": mesh, "kind": cell.kind,
            "model_flops": cell.model_flops}


def abstract_record(cell, mesh: str) -> dict:
    """The reference's record fields for ``cell`` on ``mesh`` ("16x16",
    "2x16x16" or "card"), from its abstract arguments alone."""
    from repro_torch.configs.base import layout_devices
    from repro_torch.launch.mesh import card_layout, make_production_layout

    layout = card_layout() if mesh == "card" else make_production_layout(**MESHES[mesh])
    rec = _base(cell, mesh)
    rec["status"], rec["skip_reason"] = ("skip", cell.skip) if cell.skip else ("ok", None)
    rec["memory"] = {"argument_bytes": cell.argument_bytes(layout)}
    rec["model_flops_per_device"] = cell.model_flops / layout_devices(layout)
    if mesh == "card" and not cell.skip:
        cut = cell.card_cut()
        rec["card_cut"] = dataclasses.asdict(cut)
        if not cut.fits:
            rec["status"], rec["skip_reason"] = "skip", cut.reason
    return rec


def _sync(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def measured_record(cell, dev: torch.device, *, seed: int = 0, steps: int = 3,
                    batch: int | None = None, n_top: int = 8, verbose: bool = True
                    ) -> dict:
    """``cell`` built on ``dev`` at its card cut (or ``batch``, if smaller),
    warmed up, timed over ``steps`` synchronised steps and traced once
    (its ``n_top`` device ops kept)."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.shardutil import total_bytes
    from repro_torch.launch import roofline as rl
    from repro_torch.launch import trace_cost
    from repro_torch.launch.mesh import card_layout

    rec = _base(cell, "card")
    rec["device"] = device_info(dev)
    if cell.skip:
        rec.update(status="skip", skip_reason=cell.skip)
        return rec
    cut = cell.card_cut()
    rec["card_cut"] = dataclasses.asdict(cut)
    if not cut.fits:
        rec.update(status="skip", skip_reason=cut.reason)
        return rec
    b = min(batch or cut.batch, cut.batch)
    rec["batch"] = b
    rec["reduced"] = {} if b == cut.full else {cut.axis: [cut.full, b]}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = _sync(dev)
    fn, args = cell.build(dev, b, seed)
    rec["build_s"] = _sync(dev) - t0
    t0 = _sync(dev)
    fn(*args)
    rec["warmup_s"] = _sync(dev) - t0
    walls = []
    for _ in range(steps):
        t0 = _sync(dev)
        fn(*args)
        walls.append(_sync(dev) - t0)
    reset_launches()
    collectives.reset_wire_bytes()
    cost = trace_cost.trace(lambda: fn(*args), dev)
    rec["launches"] = launches()
    wire = dict(collectives.wire_bytes)
    on_card = dev.type == "cuda"
    wall = sum(walls) / len(walls)
    arg_bytes = total_bytes(cell.args_fn(b, card_layout(), True))
    roof = rl.analyze(flops=cell.step_flops(b), hbm_bytes=arg_bytes, collectives=wire,
                      compute_dtype=cell.compute_dtype,
                      wall_s=wall if on_card else None,
                      device_s=cost.device_s if on_card else None,
                      traced_wall_s=cost.wall_s if on_card else None)
    rec.update(status="ok", steps=steps, step_walls_s=walls if on_card else None,
               host_wall_s=None if on_card else wall,
               model_flops_per_device=cell.flops_fn(b), roofline=roof.as_dict(),
               memory=rl.memory_stats(arg_bytes, dev), top_ops=cost.top_records(n_top))
    del fn, args
    if verbose:
        print(f"== {cell.arch} / {cell.shape} on the card ({rec['device']['name']}, "
              f"{rec['device']['power_limit']}), batch {b} of {cut.full} ==")
        print(f"wall {roof.wall_s} s, device {roof.device_s} s, idle share "
              f"{roof.idle_share}, mfu {roof.mfu}; dominant {roof.dominant}; peak "
              f"{rec['memory']['peak_bytes']} B; launches {json.dumps(rec['launches'])}")
    return rec


#: what the forkserver of :func:`measured_in_child` imports once: torch,
#: its profiler, the registry and the kernel wrappers' modules (no device
#: work: importing any of them touches no card)
PRELOAD = ["torch", "torch.profiler", "repro_torch.configs", "repro_torch.launch.dryrun",
           *sorted({mod for mod, _ in KERNEL_WRAPPERS.values()})]


def measure(arch: str, shape: str, args) -> tuple[dict, int]:
    """One cell's measured record on ``args.device`` in this process, and
    1 when it raised (the record then an ``"error"``), else 0."""
    from repro_torch.configs import REGISTRY
    from repro_torch.device import resolve

    try:
        cell = REGISTRY[arch].cell(shape)
        return measured_record(cell, resolve(args.device), seed=args.seed,
                               steps=args.steps, batch=args.batch), 0
    except Exception as e:  # noqa: BLE001 - report and continue
        print(f"== {arch} / {shape} FAILED: {e!r}", file=sys.stderr, flush=True)
        return {"arch": arch, "shape": shape, "mesh": "card", "status": "error",
                "error": repr(e)[:2000]}, 1


def _child(conn, arch: str, shape: str, args) -> None:
    conn.send(measure(arch, shape, args))
    conn.close()


def measured_in_child(arch: str, shape: str, args, timeout: float | None = None
                      ) -> tuple[dict, int]:
    """One cell's measured record (:func:`measure`) from a process of its
    own, and its exit code.

    The process is forked from a server that has imported :data:`PRELOAD`
    and never touched a card, so each cell still starts with no CUDA
    context, an empty allocator and a profiler that has traced nothing,
    without importing torch and its profiler again (about 7 and 8 s a
    process on an H100 host). Past ``timeout`` seconds the process is
    killed and ``TimeoutError`` raised."""
    from repro_torch.launch import dryrun  # importable by name, also when run as __main__

    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(PRELOAD)
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=dryrun._child, args=(send, arch, shape, args))
    proc.start()
    send.close()
    try:
        if not recv.poll(timeout):
            proc.kill()
            raise TimeoutError(f"{arch} / {shape}: no record in {timeout} s")
        rec, rc = recv.recv()
    except EOFError:  # the process died before it sent its record
        rec, rc = None, None
    finally:
        proc.join()
        recv.close()
    if rec is None:
        return ({"arch": arch, "shape": shape, "mesh": "card", "status": "error",
                 "error": f"the measuring process died: exit {proc.exitcode}"},
                proc.exitcode or 1)
    return rec, rc or proc.exitcode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--meshes", nargs="+", choices=["16x16", "2x16x16", "card"],
                    help="the abstract mode's layouts (over --multi-pod / --both-meshes)")
    ap.add_argument("--all", action="store_true",
                    help="every cell (measured: each in a process of its own)")
    ap.add_argument("--out", help="append JSONL records here")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--abstract", action="store_true",
                    help="argument bytes from the layouts alone; no card needed")
    ap.add_argument("--device", default="cuda",
                    help="where the measured mode runs (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3, help="timed steps a cell")
    ap.add_argument("--batch", type=int, default=None,
                    help="run at this batch when it is below the card cut")
    args = ap.parse_args(argv)

    from repro_torch.configs import REGISTRY

    if args.list:
        for name, arch in REGISTRY.items():
            print(name, "->", ", ".join(arch.cells))
        return 0

    jobs = []
    if args.all:
        for name, arch in REGISTRY.items():
            jobs.extend((name, shape) for shape in arch.cells)
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all / --list)")
        jobs.append((args.arch, args.shape))

    if args.abstract:
        meshes = args.meshes or (["16x16", "2x16x16"] if args.both_meshes else
                                 ["2x16x16" if args.multi_pod else "16x16"])
    else:
        from repro_torch.device import resolve

        resolve(args.device)  # raises without a card: no fallback
        meshes = ["card"]
    rc = 0
    for arch, shape in jobs:
        for mesh in meshes:
            if not args.abstract:
                rec, cell_rc = (measured_in_child(arch, shape, args) if len(jobs) > 1
                                else measure(arch, shape, args))
                rc = rc or (1 if cell_rc else 0)
            else:
                try:
                    rec = abstract_record(REGISTRY[arch].cell(shape), mesh)
                except Exception as e:  # noqa: BLE001 - report and continue
                    rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": "error",
                           "error": repr(e)[:2000]}
                    print(f"== {arch} / {shape} FAILED: {e!r}", file=sys.stderr)
                    rc = 1
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
