"""``python -m repro_torch.launch.train`` on the CPU, and its checkpoints
against the JAX package's launcher (``repro.launch.train``).

* The port's launcher trains a reduced config (the loss drops over 30
  steps) and a resume continues from its checkpoint.
* A run the JAX launcher checkpointed at step 10, resumed by the port to
  step 20, gives the JAX launcher's uninterrupted run: every printed loss
  within 2e-4 (the lines print 4 decimals; the two packages' fp32 sums
  differ in their last bits), and the final checkpoints' weights within
  1e-4 x each leaf's largest entry plus 10 steps x lr x 1e-3 (an Adam step
  moves an entry by up to lr whatever its gradient's size). And the
  reverse: a port checkpoint resumed by the JAX launcher gives the port's
  uninterrupted run.
* Without ``--device cpu`` on a machine with no card, the launcher raises.
"""

import contextlib
import io
import re
import shutil

import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.configs.lm import INTERNLM2_18B_SMOKE
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.launch import train as ttrain
from repro_torch.train import tree

ARCH = "internlm2-1.8b"
COMMON = ["--arch", ARCH, "--batch", "4", "--seq", "32", "--checkpoint-every", "10"]
LR = 1e-3  # the launchers' default


def _run(main, args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(args) == 0
    return out.getvalue()


def _losses(text):
    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"^step\s+(\d+) loss\s+(\S+) gnorm", text, re.M)}


def _port(args, ckpt):
    return _run(ttrain.main, [*COMMON, *args, "--ckpt-dir", str(ckpt), "--device", "cpu"])


def _jax(args, ckpt):
    return _run(jtrain.main, [*COMMON, *args, "--ckpt-dir", str(ckpt)])


def _final_weights(ckpt, step=20):
    mgr = CheckpointManager(f"{ckpt}/{ARCH}")
    names = [n for n in mgr.read_manifest(step)["leaves"]]
    arrays, manifest = mgr.restore(names, step=step)
    assert manifest["step"] == step
    return arrays


def _same_run(resumed_out, resumed_ckpt, whole_out, whole_ckpt):
    assert "resumed from step 10" in resumed_out
    got, want = _losses(resumed_out), _losses(whole_out)
    assert sorted(got) == list(range(10, 20))
    for step in got:
        assert abs(got[step] - want[step]) <= 2e-4, step
    a, b = _final_weights(resumed_ckpt), _final_weights(whole_ckpt)
    assert sorted(a) == sorted(b)
    names = [n for n in a if n.startswith("0/")]
    assert len(names) == len(list(tree.items(INTERNLM2_18B_SMOKE.param_specs())))
    for name in names:
        x, y = a[name].numpy(), b[name].numpy()
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-4 * float(np.abs(y).max())
                                   + 10 * LR * 1e-3, err_msg=name)
    assert int(a["1/step"]) == int(b["1/step"]) == 20


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each launcher to step 10 (then stopped) and to step 20 in one go."""
    root = tmp_path_factory.mktemp("train_cli")
    out = {}
    for name, fn in (("jax", _jax), ("port", _port)):
        out[name + "10"] = (fn(["--steps", "10"], root / f"{name}10"), root / f"{name}10")
        out[name + "20"] = (fn(["--steps", "20"], root / f"{name}20"), root / f"{name}20")
    return out


def test_port_launcher_trains_and_resumes(tmp_path):
    text = _port(["--steps", "30"], tmp_path)
    losses = _losses(text)
    assert sorted(losses) == list(range(30))
    assert re.search(r"^loss \S+ -> \S+ OK$", text, re.M)
    assert CheckpointManager(f"{tmp_path}/{ARCH}").all_steps() == [10, 20, 30]
    more = _port(["--steps", "34", "--resume"], tmp_path)
    assert more.splitlines()[0] == "resumed from step 30"
    assert sorted(_losses(more)) == [30, 31, 32, 33]


def test_port_checkpoint_names_are_the_references(runs):
    """The two launchers write the same leaves, names, shapes and dtypes."""
    a = CheckpointManager(f"{runs['port10'][1]}/{ARCH}").read_manifest(10)["leaves"]
    b = CheckpointManager(f"{runs['jax10'][1]}/{ARCH}").read_manifest(10)["leaves"]
    assert list(a) == list(b)
    for name in a:
        for key in ("file", "shape", "dtype"):
            assert a[name][key] == b[name][key], (name, key)
    assert "1/step" in a and "0/layers/wq" in a and "1/m/layers/wq" in a


def test_jax_checkpoint_resumes_in_the_port(runs, tmp_path):
    ckpt = tmp_path / "from_jax"
    shutil.copytree(runs["jax10"][1], ckpt)
    out = _port(["--steps", "20", "--resume"], ckpt)
    _same_run(out, ckpt, *runs["jax20"])


def test_port_checkpoint_resumes_in_jax(runs, tmp_path):
    ckpt = tmp_path / "from_port"
    shutil.copytree(runs["port10"][1], ckpt)
    out = _jax(["--steps", "20", "--resume"], ckpt)
    _same_run(out, ckpt, *runs["port20"])


def test_launcher_rejects_other_archs(tmp_path):
    with pytest.raises(SystemExit, match="LM archs"):
        ttrain.main(["--arch", "dlrm-rm2", "--ckpt-dir", str(tmp_path), "--device", "cpu"])


def test_launcher_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main([*COMMON, "--steps", "2", "--ckpt-dir", str(tmp_path)])
