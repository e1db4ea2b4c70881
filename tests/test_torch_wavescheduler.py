"""The wave scheduler and failure injection (the jobtracker analog, paper
§2.2 and §3), repro_torch against the JAX package's.

Both schedulers run the same waves: the same folded state, the same
``(wave, attempt, ok)`` records and ``completed`` under injected failures,
the same exception once ``max_retries`` is spent, and the same result
after a ``CrashAfter`` crash and a resume from checkpoints taken every 2
waves -- the checkpoint files byte-identical, and each package resuming
from the other's. ``plan_waves`` agrees over a grid of sizes.
"""

import json
import os

import numpy as np
import pytest

from repro.distributed import failure as jfail
from repro.distributed import wavescheduler as jws
from repro.distributed.checkpoint import CheckpointManager as JCkpt
from repro_torch.distributed import failure as tfail
from repro_torch.distributed import wavescheduler as tws
from repro_torch.distributed.checkpoint import CheckpointManager as TCkpt

N_WAVES = 7
DIM = 5


def _waves():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 100, DIM).astype(np.float32) for _ in range(N_WAVES)]


def _fold(state, r):
    if state is None:
        state = {"sum": np.zeros(DIM, np.float32), "count": np.zeros((), np.int32)}
    return {"sum": state["sum"] + r, "count": state["count"] + np.int32(1)}


def _wave_fn(x):
    return x * np.float32(2)


PKGS = {
    "reference": (jws, jfail, JCkpt,
                  lambda t: {k: np.asarray(v) for k, v in t.items()}),
    "port": (tws, tfail, TCkpt, lambda t: {k: v.numpy() for k, v in t.items()}),
}


def _sched(pkg, injector=None, ckpt_dir=None, **kw):
    ws, _, ckpt, to_state = PKGS[pkg]
    return ws.WaveScheduler(
        _wave_fn, _fold, failure_injector=injector,
        checkpoint=ckpt(ckpt_dir) if ckpt_dir else None,
        tree_to_state=to_state, **kw)


def _records(result):
    return [(r.wave, r.attempt, r.ok) for r in result.records]


def _same_state(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))


@pytest.mark.parametrize("fail_at", [(), [(1, 0)], [(1, 0), (3, 0)],
                                     [(0, 0), (0, 1), (6, 1), (6, 0)]])
def test_injected_failures_are_retried_alike(fail_at):
    out = {}
    for pkg in PKGS:
        inj = PKGS[pkg][1].FailureInjector(fail_at=fail_at)
        out[pkg] = (_sched(pkg, inj).run(_waves()), inj.fired)
    (ja, jf), (ta, tf) = out["reference"], out["port"]
    assert _records(ja) == _records(ta)
    assert ja.completed == ta.completed == N_WAVES
    assert jf == tf and len(tf) == len(fail_at)
    _same_state(ja.state, ta.state)
    assert [r.wave for r in ta.stragglers] == [
        r.wave for r in ta.records if r in ta.stragglers]
    assert all(r.error.startswith("InjectedFailure") for r in ta.records
               if not r.ok)


@pytest.mark.parametrize("max_retries", [0, 1, 2])
def test_raise_after_max_retries(max_retries):
    msgs = []
    for pkg in PKGS:
        fail = PKGS[pkg][1]
        inj = fail.FailureInjector(
            fail_at=[(2, a) for a in range(max_retries + 1)])
        with pytest.raises(fail.InjectedFailure) as e:
            _sched(pkg, inj, max_retries=max_retries).run(_waves())
        msgs.append(str(e.value))
        assert inj.fired == [(2, a) for a in range(max_retries + 1)]
    assert msgs[0] == msgs[1]


def _crash_then_resume(run_pkg, resume_pkg, d, start_at=0):
    """Run ``run_pkg`` with checkpoints every 2 waves until CrashAfter(5)
    kills it, then resume with ``resume_pkg`` from the checkpoints."""
    crash = PKGS[run_pkg][1].CrashAfter(5)
    with pytest.raises(KeyboardInterrupt):
        _sched(run_pkg, crash, d, checkpoint_every=2).run(_waves())
    s = _sched(resume_pkg, None, d, checkpoint_every=2)
    cursor = s.resume_cursor()
    state = s.resume_state(_fold(None, np.zeros(DIM, np.float32)))
    return cursor, state, s.run(_waves(), init_state=state, start_at=cursor)


@pytest.mark.parametrize("run_pkg,resume_pkg", [
    ("reference", "reference"), ("port", "port"), ("reference", "port"),
    ("port", "reference")])
def test_crash_and_resume_from_checkpoints(tmp_path, run_pkg, resume_pkg):
    clean = _sched("reference").run(_waves())
    d = str(tmp_path / "ckpt")
    cursor, state, res = _crash_then_resume(run_pkg, resume_pkg, d)
    assert cursor == 4  # waves 0-3 checkpointed (every 2), 4 crashed
    assert int(np.asarray(state["count"])) == 4
    assert res.completed == N_WAVES
    assert [r.wave for r in res.records] == [4, 5, 6]
    _same_state(res.state, clean.state)


def test_checkpoint_files_are_byte_identical(tmp_path):
    """The two packages' checkpoints of the same crashed run: the same
    steps, files and bytes, the manifests equal."""
    dirs = {}
    for pkg in PKGS:
        d = str(tmp_path / pkg)
        with pytest.raises(KeyboardInterrupt):
            _sched(pkg, PKGS[pkg][1].CrashAfter(5), d,
                   checkpoint_every=2).run(_waves())
        dirs[pkg] = d
    ja, ta = dirs["reference"], dirs["port"]
    assert sorted(os.listdir(ja)) == sorted(os.listdir(ta)) == [
        "step_0000000002", "step_0000000004"]
    for step in os.listdir(ja):
        names = sorted(os.listdir(os.path.join(ja, step)))
        assert names == sorted(os.listdir(os.path.join(ta, step)))
        for name in names:
            a = open(os.path.join(ja, step, name), "rb").read()
            b = open(os.path.join(ta, step, name), "rb").read()
            if name == "manifest.json":
                assert json.loads(a) == json.loads(b)
            else:
                assert a == b, (step, name)


@pytest.mark.parametrize("n,per", [
    (n, per) for n in (0, 1, 7, 4096, 4099, 2**20 + 3)
    for per in (1, 3, 4096, 4194304)] + [(8388605, 4194304), (8388605, 4096)])
def test_plan_waves_matches_reference(n, per):
    got = tws.plan_waves(n, per)
    assert got == jws.plan_waves(n, per)
    assert sum(size for _, size in got) == n
