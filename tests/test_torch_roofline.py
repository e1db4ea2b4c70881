"""The port's roofline and dry-run (``launch/{roofline,trace_cost,dryrun}.py``)
against the JAX package's: the fused-scan estimate's counts, the
dry-run's records on the CPU, and the counters the roofline reads. The
reference's ``launch/dryrun.py`` is never imported (it pins 512 host
devices when imported), and no cell is lowered."""

import argparse
import itertools
import json

import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as REF
from repro.launch import roofline as ref_roofline
from repro_torch.distributed import collectives
from repro_torch.distributed.meshutil import DeviceMesh
from repro_torch.launch import dryrun, roofline, trace_cost

GRID = list(itertools.product((4096, 2**20 + 7), (16, 128), (1, 1024), (10, 20),
                              (256, 4096)))
COUNTS = ("flops", "n_waves", "fused_hbm_bytes", "reference_hbm_bytes",
          "fused_intensity", "reference_intensity")


@pytest.mark.parametrize("rows,dim,q_rows,k,block_rows", GRID)
def test_fused_scan_estimate_counts_equal_the_reference(rows, dim, q_rows, k, block_rows):
    kw = dict(rows=rows, dim=dim, q_rows=q_rows, k=k, block_rows=block_rows)
    ref, port = ref_roofline.fused_scan_estimate(**kw), roofline.fused_scan_estimate(**kw)
    assert {c: port[c] for c in COUNTS} == {c: ref[c] for c in COUNTS}
    # the time terms are the same counts over the H100's fp32 peak and HBM rate
    assert port["t_compute"] == port["flops"] / 67e12
    assert port["t_memory_fused"] == port["fused_hbm_bytes"] / 3.35e12
    assert port["t_memory_reference"] == port["reference_hbm_bytes"] / 3.35e12


def test_peaks_bound_and_analyze():
    assert (roofline.PEAK_FLOPS_BF16, roofline.PEAK_FLOPS_FP32) == (989e12, 67e12)
    assert (roofline.HBM_BW, roofline.NVLINK_BW) == (3.35e12, 450e9)
    assert roofline.peak_flops(torch.bfloat16) == 989e12
    assert roofline.peak_flops(torch.float32) == 67e12
    assert roofline.bound(3.35e9, 1.0) == (1.0, "bytes")
    assert roofline.bound(1.0, 67e9) == (1.0, "operations")
    roof = roofline.analyze(flops=989e12, hbm_bytes=3.35e12, compute_dtype=torch.bfloat16,
                            collectives={"all_to_all": 900e9}, wall_s=4.0, device_s=3.0,
                            traced_wall_s=5.0)
    assert (roof.t_compute, roof.t_memory, roof.t_collective) == (1.0, 1.0, 2.0)
    assert roof.dominant == "collective" and roof.wire_bytes == 900e9
    # mfu reads the untraced steps' wall, the idle share the traced step's own
    assert roof.mfu == 0.25 and roof.idle_share == 0.4
    cpu = roofline.analyze(flops=1.0, hbm_bytes=1.0, compute_dtype=torch.float32,
                           collectives={})
    assert (cpu.wall_s == cpu.device_s == cpu.traced_wall_s == cpu.mfu == cpu.idle_share
            == "not measured")


def test_trace_cost_keeps_the_reference_interface():
    cost = trace_cost.Cost(device_s=0.004)
    cost.add_source("k1", 1.0, 2)
    cost.add_source("k2", 3.0, 1)
    cost.add_source("k1", 1.0, 2)
    assert cost.top_sources(1) == [("k2", 3.0, 1, 0.75)]
    assert cost.top_sources(1, key="launches") == [("k1", 2.0, 4, 0.5)]
    cpu = trace_cost.trace(lambda: torch.ones(8) @ torch.ones(8), torch.device("cpu"))
    names = {name for name, *_ in cpu.top_sources(50, key="launches")}
    assert "aten::matmul" in names or "aten::dot" in names
    assert all(ms == "not measured" for _, ms, _, _ in cpu.top_sources(50))
    assert cpu.device_s == cpu.wall_s == "not measured"


def test_collectives_count_only_bytes_between_devices():
    collectives.reset_wire_bytes()
    mesh = DeviceMesh((torch.device("cpu"),) * 4)
    parts = [torch.arange(8, dtype=torch.float32) for _ in range(4)]
    out = collectives.all_to_all(parts, mesh)
    collectives.gather(parts, mesh)
    collectives.psum([torch.ones((), dtype=torch.int32)] * 4, mesh)
    collectives.broadcast(parts[0], mesh)
    assert torch.equal(out[1], torch.tensor([2.0, 3.0] * 4))
    assert collectives.wire_bytes == {"all_to_all": 0, "gather": 0, "psum": 0,
                                      "broadcast": 0}


def _records(capsys, argv) -> list:
    assert dryrun.main(argv) == 0
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_dryrun_list_and_abstract_records(capsys, tmp_path):
    assert dryrun.main(["--list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"{a} -> {', '.join(REF[a].cells)}" for a in REF]
    out = tmp_path / "records.jsonl"
    recs = _records(capsys, ["--abstract", "--all", "--out", str(out)])
    assert len(recs) == 44 and len(out.read_text().splitlines()) == 44
    for rec in recs:
        ref = REF[rec["arch"]].cell(rec["shape"])
        assert rec["mesh"] == "16x16"
        assert rec["status"] == ("skip" if ref.skip else "ok")
        assert rec["model_flops"] == pytest.approx(ref.model_flops, rel=1e-12)
        assert rec["model_flops_per_device"] == pytest.approx(ref.model_flops / 256)
    card = _records(capsys, ["--abstract", "--arch", "phi3.5-moe-42b-a6.6b",
                             "--shape", "decode_32k", "--meshes", "2x16x16", "card"])
    assert [r["mesh"] for r in card] == ["2x16x16", "card"]
    assert card[1]["status"] == "skip" and card[1]["card_cut"]["batch"] == 0
    assert "smallest layout holding it: 16x16" in card[1]["skip_reason"]


def test_dryrun_measured_on_the_cpu():
    # the process of its own that --all gives each cell, which measures it
    # as a one-cell run does
    rec, rc = dryrun.measured_in_child("gin-tu", "molecule", argparse.Namespace(
        device="cpu", seed=0, steps=1, batch=None))
    ref = REF["gin-tu"].cell("molecule")
    assert rc == 0
    assert rec["status"] == "ok" and rec["mesh"] == "card" and rec["reduced"] == {}
    assert rec["model_flops"] == pytest.approx(ref.model_flops, rel=1e-12)
    roof = rec["roofline"]
    for key in ("wall_s", "device_s", "traced_wall_s", "idle_share", "mfu"):
        assert roof[key] == "not measured"
    assert rec["memory"]["peak_bytes"] == "not measured"
    assert rec["memory"]["argument_bytes"] == roof["hbm_bytes"] > 0
    assert rec["top_ops"] and all(op["device_ms"] == "not measured" for op in rec["top_ops"])
    assert np.isfinite(rec["host_wall_s"]) and rec["launches"] == {}


def test_dryrun_measured_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["--arch", "gin-tu", "--shape", "molecule"])


def test_dryrun_writes_an_error_record_and_goes_on(capsys, monkeypatch):
    from repro_torch.configs import REGISTRY

    cell = REGISTRY["gin-tu"].cell("molecule")

    def broken(dev, b, seed):
        raise MemoryError("out of memory")

    monkeypatch.setattr(REGISTRY["gin-tu"], "cells", {
        "molecule": lambda: __import__("dataclasses").replace(cell, build_fn=broken)})
    assert dryrun.main(["--arch", "gin-tu", "--shape", "molecule", "--device", "cpu"]) == 1
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["status"] == "error" and "out of memory" in rec["error"]
