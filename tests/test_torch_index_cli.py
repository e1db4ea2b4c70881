"""``python -m repro_torch.launch.index`` against the JAX package's
``launch/index.py``, on the CPU at small widths (4,000 rows, d 16, blocks
of 1,000, fanouts 4 x 4).

A job crashed by either package is resumed and finished by the other from
the ingest cursor in the index's meta; the final directory's segment
arrays and cursor equal those of the finishing side's uninterrupted run
over the same tree, bit for bit. The verification search prints the same
numbers on one directory. Then the port's own flags: the legacy run
(failures injected, verification, compaction), codes, incremental
compaction as the reference's policy steps it, trace and metrics export,
and a grown index served by ``launch.serve``. The reference runs on the
Auto-axis mesh (its ``local_mesh()`` builds Explicit axes, which jax 0.9
rejects on the search path), patched in for each call.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.distributed.meshutil as jmeshutil
from repro.distributed import wavescheduler as jws
from repro.index import Index as JIndex
from repro.launch import index as jcli
from repro_torch.distributed import meshutil as tmeshutil
from repro_torch.distributed import wavescheduler as tws
from repro_torch.distributed.meshutil import DeviceMesh
from repro_torch.index import Index
from repro_torch.launch import index as tcli
from repro_torch.launch import serve as tserve
from repro_torch.obs import NULL_TRACER, get_tracer

SRC = Path(__file__).resolve().parents[1] / "src"
STORE = ["--rows", "4000", "--dim", "16", "--block-rows", "1000",
         "--fanout", "4", "4", "--tree-sample", "1024"]
FIELDS = ("ids", "leaves", "offsets", "vecs")


@pytest.fixture(autouse=True)
def auto_mesh(monkeypatch):
    monkeypatch.setattr(
        jmeshutil, "local_mesh",
        lambda *a, **kw: Mesh(np.array(jax.devices()).reshape(1, 1),
                              ("data", "model")))


def _port(args):
    return tcli.main(STORE + ["--device", "cpu"] + list(args))


def _ref(args):
    return jcli.main(STORE + list(args))


RUN = {"port": _port, "reference": _ref}
SCHED = {"port": tws, "reference": jws}


def _crash_after_two(pkg, monkeypatch, args):
    """The job of ``pkg`` dies after its first 2 committed blocks (the
    reference's own test of the resume, ``test_index_lifecycle.py``)."""
    real = SCHED[pkg].WaveScheduler.run

    def two(self, waves, **kw):
        return real(self, list(waves)[:2], **kw)

    monkeypatch.setattr(SCHED[pkg].WaveScheduler, "run", two)
    with pytest.raises(AssertionError):  # dies before finishing
        RUN[pkg](args)
    monkeypatch.setattr(SCHED[pkg].WaveScheduler, "run", real)


def _arrays(d):
    idx = Index.open(d, device="cpu")
    return ([{f: getattr(s.index, f).numpy() for f in FIELDS}
             for s in idx.segments], idx.meta["ingest"], idx.rows)


@pytest.mark.parametrize("starter,finisher", [("reference", "port"),
                                              ("port", "reference")])
def test_cross_package_resume(tmp_path, monkeypatch, capsys, starter,
                              finisher):
    d = str(tmp_path / "job")
    args = ["--commit-every", "1", "--index-dir", d]
    _crash_after_two(starter, monkeypatch, args)
    assert Index.open(d, device="cpu").meta["ingest"]["next_block"] == 2
    assert JIndex.open(d, mesh=jmeshutil.local_mesh()).rows == 2000
    # the finishing side's uninterrupted run over the same tree
    tree = Index.open(d, device="cpu").tree
    clean = str(tmp_path / "clean")
    meta = {"corpus_seed": 0}
    if finisher == "port":
        Index.create(tree, clean, device="cpu", extra=meta)
    else:
        JIndex.create(JIndex.open(d, mesh=jmeshutil.local_mesh()).tree,
                      clean, mesh=jmeshutil.local_mesh(), extra=meta)
    capsys.readouterr()
    assert RUN[finisher](args) == 0
    out = capsys.readouterr().out
    assert "ingest: resuming this store at block 2/4 (base id 0)" in out
    assert "index job: 2/2 append waves" in out
    assert "indexed 2000 descriptors == remaining corpus size OK" in out
    assert RUN[finisher](["--commit-every", "1", "--index-dir", clean]) == 0
    got, cursor, rows = _arrays(d)
    want, want_cursor, _ = _arrays(clean)
    assert rows == 4000 and len(got) == len(want) == 4
    assert cursor == want_cursor and cursor["next_block"] == 4
    for g, w in zip(got, want):
        for f in FIELDS:
            np.testing.assert_array_equal(g[f], w[f], err_msg=f)
    ids = np.sort(np.concatenate([g["ids"][g["ids"] >= 0] for g in got]))
    np.testing.assert_array_equal(ids, np.arange(4000))


@pytest.fixture(scope="module")
def grown(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("grown") / "idx")
    assert _port(["--index-dir", d]) == 0
    return d


def _verify_line(out):
    return [ln for ln in out.splitlines() if ln.startswith("verify:")]


@pytest.mark.parametrize("layout,probes", [("point_major", 1),
                                           ("point_major", 2),
                                           ("query_routed", 1)])
def test_verify_matches_reference(grown, capsys, layout, probes):
    args = ["--index-dir", grown, "--verify-queries", "32", "--layout",
            layout, "--probes", str(probes)]
    capsys.readouterr()
    assert _ref(args) == 0
    ref = _verify_line(capsys.readouterr().out)
    assert _port(args) == 0
    out = capsys.readouterr().out
    assert "ingest: resuming this store at block 4/4" in out
    assert _verify_line(out) == ref and len(ref) == 1
    assert ref[0].endswith("q_cap_overflow 0")


def test_legacy_flags_run(tmp_path, capsys):
    """The historical flags: failures injected at (1, 0) and (3, 0) and
    retried, a verification search, a compaction to one segment."""
    d = str(tmp_path / "cli")
    assert _port(["--inject-failures", "--verify-queries", "16", "--probes",
                  "2", "--index-dir", d, "--compact"]) == 0
    out = capsys.readouterr().out
    assert "index job: 4/4 append waves" in out
    assert "2 failed attempts (retried)" in out
    assert "compacted -> " in out and "verify: layout=auto probes=2" in out
    idx = Index.open(d, device="cpu")
    assert idx.rows == 4000 and idx.n_segments == 1
    assert get_tracer() is NULL_TRACER


def _untimed(out):
    return [re.sub(r"\d+\.\d+s", "Ts", ln) for ln in out.splitlines()
            if not ln.startswith(("tree:", "wave stats:"))]


def test_ephemeral_job_prints_the_reference_lines(capsys):
    """No --index-dir: one commit at the end; every printed line but the
    timings and the (package-own) tree's build time is the reference's."""
    args = ["--verify-queries", "8", "--layout", "point_major",
            "--inject-failures"]
    capsys.readouterr()
    assert _ref(args) == 0
    ref = capsys.readouterr().out
    assert _port(args) == 0
    out = capsys.readouterr().out
    assert "tree: 16 leaves" in out and "committed v1 (4 segments" in out
    assert _untimed(out)[:3] == _untimed(ref)[:3]  # store, job, indexed
    assert "recall@1" in _untimed(out)[3]


def test_codes_then_scan_codes_verify(tmp_path, capsys):
    d = str(tmp_path / "codes")
    args = ["--index-dir", d, "--codes", "--subvectors", "4", "--code-bits",
            "4", "--verify-queries", "16", "--layout", "scan_codes"]
    assert _port(args) == 0
    out = capsys.readouterr().out
    assert "codes: trained m=4 bits=4 (4 B/row vs 64 raw, 16.0x)" in out
    assert "verify: layout=scan_codes" in out
    idx = Index.open(d, device="cpu")
    assert idx.quantizer is not None and idx.meta["ingest"]["next_block"] == 4
    # the reference reads the codes the port's job committed
    assert JIndex.open(d, mesh=jmeshutil.local_mesh()).quantizer is not None


def test_incremental_compaction_steps_as_the_reference(tmp_path, capsys):
    steps = {}
    for pkg in RUN:
        d = str(tmp_path / pkg)
        assert RUN[pkg](["--index-dir", d, "--compact-incremental"]) == 0
        out = capsys.readouterr().out
        steps[pkg] = [ln.split(":")[0] for ln in out.splitlines()
                      if ln.startswith("compact step")]
        assert "incremental compaction:" in out
        assert Index.open(d, device="cpu").rows == 4000
    assert steps["port"] == steps["reference"] and steps["port"]


def test_trace_and_metrics_export(tmp_path, capsys):
    trace, metrics = str(tmp_path / "t.jsonl"), str(tmp_path / "m.json")
    chrome = str(tmp_path / "t.json")
    assert _port(["--index-dir", str(tmp_path / "idx"), "--trace-out", trace,
                  "--metrics-out", metrics]) == 0
    out = capsys.readouterr().out
    assert f"trace -> {trace}" in out and f"metrics registry -> {metrics}" in out
    with open(trace) as f:
        spans = [json.loads(ln) for ln in f][1:]
    names = {s["name"] for s in spans}
    assert {"index.append", "index.commit"} <= names
    with open(metrics) as f:
        assert "index.appends" in json.dumps(json.load(f))
    assert _port(["--index-dir", str(tmp_path / "idx"), "--compact",
                  "--trace-out", chrome]) == 0
    rep = subprocess.run([sys.executable, str(SRC.parent / "scripts" /
                                              "tracereport.py"), chrome],
                         capture_output=True, text=True, timeout=120)
    assert rep.returncode == 0 and "trace report: 6 spans" in rep.stdout
    with open(chrome) as f:
        assert "index.compact" in f.read()
    assert get_tracer() is NULL_TRACER


def test_grow_then_serve_roundtrip(tmp_path):
    """An --index-dir grown by the port's index CLI (no corpus/ store) is
    servable by its serve CLI: the trace generator reads query rows from
    the segments."""
    d = str(tmp_path / "grown")
    assert tcli.main(["--rows", "4000", "--dim", "16", "--block-rows", "2000",
                      "--fanout", "4", "4", "--tree-sample", "1024",
                      "--index-dir", d, "--device", "cpu"]) == 0
    assert tserve.main([
        "--index-dir", d, "--dim", "16", "--desc-per-image", "20",
        "--trace", "uniform", "--requests", "20", "--buckets", "64",
        "--no-recall", "--device", "cpu",
    ]) == 0


def test_index_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(STORE)


def _four_cpu_shards(monkeypatch):
    """``local_mesh`` as a machine of four cards would give it: four
    shards, here on the CPU."""
    mesh = DeviceMesh((torch.device("cpu"),) * 4)
    monkeypatch.setattr(tmeshutil, "local_mesh", lambda device="cuda": mesh)
    return mesh


def test_job_on_a_four_shard_mesh_gives_the_one_shard_answers(tmp_path, capsys,
                                                              monkeypatch):
    """The CLI builds its index on ``local_mesh``: with four shards the
    job prints the one-shard job's lines (the verification search's
    numbers included), every segment is a four-shard segment, and it holds
    the one-shard index's rows and answers. A directory of four shards
    does not open on one."""
    args = ["--commit-every", "2", "--inject-failures", "--verify-queries", "32",
            "--layout", "point_major", "--probes", "2"]
    one = str(tmp_path / "one")
    assert _port(args + ["--index-dir", one]) == 0
    want = _untimed(capsys.readouterr().out)
    mesh = _four_cpu_shards(monkeypatch)
    four = str(tmp_path / "four")
    assert _port(args + ["--index-dir", four]) == 0
    assert _untimed(capsys.readouterr().out) == want
    a, b = Index.open(one, device="cpu"), Index.open(four, mesh=mesh)
    assert b.n_segments == a.n_segments == 4 and b.rows == a.rows == 4000
    assert all(s.index.mesh == mesh for s in b.segments)
    assert b.meta["ingest"] == a.meta["ingest"]
    q = np.random.default_rng(3).standard_normal((64, 16)).astype(np.float32)
    for kw in (dict(layout="point_major", probes=2), dict(layout="query_routed")):
        ra, rb = a.search(q, k=5, **kw), b.search(q, k=5, **kw)
        np.testing.assert_array_equal(rb.ids.numpy(), ra.ids.numpy())
        np.testing.assert_array_equal(rb.dists.numpy(), ra.dists.numpy())
    # the four-shard directory grows on the four-shard mesh, not on one
    assert _port(["--index-dir", four]) == 0
    assert "ingest: resuming this store at block 4/4" in capsys.readouterr().out
    monkeypatch.undo()
    with pytest.raises(ValueError, match="shard"):
        _port(["--index-dir", four])
