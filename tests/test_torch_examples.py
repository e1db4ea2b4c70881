"""The port's examples (``examples/torch_*.py``) with ``--device cpu``:
each runs to its end and prints the lines its JAX counterpart in
``examples/`` prints, at the same sizes. On a machine without a card the
default device raises."""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart(capsys):
    assert _load("torch_quickstart").main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == ["index tree: 256 leaves, 0.07 MB",
                       "index: 50000 descriptors, routing overflow 0"]
    recall = [int(m.group(1)) for ln in out
              if (m := re.match(r"probes=\d: top-1 self-retrieval (\d+)%", ln))]
    assert len(recall) == 2 and recall[1] >= recall[0] >= 50


def test_copydays_eval(capsys):
    assert _load("torch_copydays_eval").main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == ["corpus: 800 images x 24 descriptors (d=48)",
                       "queries: 10300 descriptors from 100 originals x 7 variants"]
    rows = {ln.split()[0]: float(ln.split()[-1].rstrip("%")) for ln in out[4:11]}
    assert list(rows) == ["crop10", "crop30", "crop50", "crop80", "jpeg75",
                          "jpeg30", "strong"]
    assert rows["crop10"] >= 90.0
    assert out[11].startswith("AVERAGE") and out[11].endswith("(paper: ~82%)")


def test_index_and_search(capsys):
    """At a tenth of its size (its full size takes about 10 s here)."""
    mod = _load("torch_index_and_search")
    mod.ROWS, mod.BLOCK_ROWS, mod.IMAGES, mod.FANOUT = 12000, 3000, 200, 8
    mod.BATCH_IMAGES = 32
    assert mod.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "2 failed attempts (retried)" in out
    assert "indexed 12000 descriptors == remaining corpus size OK" in out
    assert "steady-state recompiles after warmup: 0 (OK)" in out
    assert "served 64/64 requests" in out


def test_train_lm(capsys):
    """Phase 1 trains 30 steps (the loss drops), phase 2 resumes at step 30
    and runs to 60, as ``examples/train_lm.py`` does."""
    assert _load("torch_train_lm").main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "=== phase 1: steps 0..30 (bf16-compressed grads, 2 microbatches)"
    steps = [int(m.group(1)) for ln in out if (m := re.match(r"step\s+(\d+) loss", ln))]
    assert steps == list(range(60))
    i = out.index("=== phase 2: simulated restart — resume from step 30, run to 60")
    assert out[i + 1] == "resumed from step 30"
    assert sum(bool(re.match(r"loss \S+ -> \S+ OK$", ln)) for ln in out) == 2


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_copydays_eval",
                                  "torch_index_and_search", "torch_train_lm"])
def test_examples_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        _load(name).main([])
