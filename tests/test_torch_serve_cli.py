"""``python -m repro_torch.launch.serve`` at a tiny size on the CPU: it
builds, warms, replays a Zipf trace through the micro-batcher and reports
0 steady-state recompiles (exit 0), sharded and codes runs included; an
``--index-dir`` run restores what the first one committed (with its
calibration) and writes the trace files ``scripts/tracereport.py`` reads.
Without ``--device cpu`` on a machine with no card it raises."""

import json

import pytest
import torch

from repro_torch.launch import serve
from repro_torch.obs import NULL_TRACER, get_tracer

TINY = ["--rows", "4000", "--dim", "16", "--images", "100", "--fanout", "8",
        "8", "--requests", "60", "--trace", "zipf", "--device", "cpu"]


@pytest.mark.parametrize("extra", [[], ["--shards", "2"],
                                   ["--codes", "--layout", "scan_codes",
                                    "--subvectors", "4", "--code-bits", "4"],
                                   ["--scheduler", "fifo", "--rate", "500"]])
def test_serve_cli_runs_on_the_cpu(capsys, extra):
    assert serve.main(TINY + extra) == 0
    out = capsys.readouterr().out
    assert "steady-state recompiles after warmup: 0 (OK)" in out
    assert "served 60/60 requests" in out
    assert get_tracer() is NULL_TRACER  # the scoped tracer came back


def test_serve_cli_index_dir_restores_and_traces(capsys, tmp_path):
    d = str(tmp_path / "idx")
    trace = str(tmp_path / "trace.jsonl")
    metrics = str(tmp_path / "m.json")
    assert serve.main(TINY + ["--index-dir", d, "--layout", "point_major"]) == 0
    first = capsys.readouterr().out
    assert "calibration:" in first and "committed" in first
    assert serve.main(TINY + ["--index-dir", d, "--layout", "point_major",
                              "--trace-out", trace, "--metrics-out", metrics,
                              "--json", str(tmp_path / "r.json")]) == 0
    out = capsys.readouterr().out
    assert "index: restored from" in out
    assert f"trace -> {trace}" in out
    with open(tmp_path / "r.json") as f:
        payload = json.load(f)
    assert payload["metrics"]["recompiles_after_warmup"] == 0
    assert payload["plan_observations"]
    with open(metrics) as f:
        assert "serving.requests" in json.dumps(json.load(f))


def test_serve_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main([a for a in TINY if a not in ("--device", "cpu")])
