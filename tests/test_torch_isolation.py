"""repro_torch stands alone: it imports neither jax nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import interop
from repro_torch.configs import gnn as cgnn
from repro_torch.configs import recsys as crec
from repro_torch.configs.lm import GEMMA3_4B_SMOKE, MOONSHOT_V1_16B_SMOKE
from repro_torch.device import resolve
from repro_torch.launch import dryrun
from repro_torch.launch import index as index_cli
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models import gnn, recsys
from repro_torch.models import transformer as tfm
from repro_torch.models.module import init_params
from repro_torch.serving import SearchSession

SRC = Path(__file__).resolve().parents[1] / "src"
EXAMPLES = ("torch_quickstart", "torch_index_and_search", "torch_copydays_eval",
            "torch_train_lm")


def test_import_pulls_in_no_jax_and_no_reference():
    code = (
        "import sys, repro_torch, repro_torch.interop, repro_torch.data.synth\n"
        "import repro_torch.kernels.l2topk, repro_torch.kernels.fusedscan\n"
        "import repro_torch.kernels.l2nn, repro_torch.kernels._build\n"
        "import repro_torch.kernels.adcscan, repro_torch.codes\n"
        "import repro_torch.models.transformer, repro_torch.kernels.flashattn\n"
        "import repro_torch.configs.lm, repro_torch.data.batches\n"
        "import repro_torch.obs, repro_torch.obs.registry, repro_torch.obs.tracer\n"
        "import repro_torch.core.engine.costmodel, repro_torch.core.engine.plan\n"
        "import repro_torch.distributed.checkpoint, repro_torch.data.store\n"
        "import repro_torch.index, repro_torch.index.manifest\n"
        "import repro_torch.index.segment, repro_torch.index.sharding\n"
        "import repro_torch.index.lifecycle, repro_torch.obs.export\n"
        "import repro_torch.serving, repro_torch.serving.batching\n"
        "import repro_torch.serving.cache, repro_torch.serving.metrics\n"
        "import repro_torch.serving.persist, repro_torch.serving.session\n"
        "import repro_torch.serving.sharded, repro_torch.serving.slo\n"
        "import repro_torch.serving.trace, repro_torch.launch.serve\n"
        "import repro_torch.launch.index, repro_torch.distributed.wavescheduler\n"
        "import repro_torch.distributed.failure, repro_torch.data.copydays\n"
        "import repro_torch.configs.sift100m\n"
        "import repro_torch.distributed.meshutil, repro_torch.distributed.collectives\n"
        "import repro_torch.core.dispatch\n"
        "import repro_torch.models.recsys, repro_torch.models.gnn\n"
        "import repro_torch.data.graph, repro_torch.kernels.segsum\n"
        "import repro_torch.configs.recsys, repro_torch.configs.gnn\n"
        "import repro_torch.train, repro_torch.train.optimizer\n"
        "import repro_torch.train.grad_compress, repro_torch.train.step\n"
        "import repro_torch.train.tree, repro_torch.launch.train\n"
        "import repro_torch.configs, repro_torch.configs.base\n"
        "import repro_torch.configs.variants, repro_torch.configs.sift_variants\n"
        "import repro_torch.distributed.partitioning, repro_torch.distributed.shardutil\n"
        "import repro_torch.launch.mesh, repro_torch.launch.roofline\n"
        "import repro_torch.launch.trace_cost, repro_torch.launch.dryrun\n"
        "import importlib.util, pathlib\n"
        "for name in EXAMPLES:\n"
        "    path = pathlib.Path(EXAMPLE_DIR) / (name + '.py')\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    code = (f"EXAMPLES = {EXAMPLES!r}\nEXAMPLE_DIR = {str(SRC.parent / 'examples')!r}\n"
            + code)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_sources_name_no_jax_import():
    pkg = SRC / "repro_torch"
    chip_smoke = SRC.parent / "chip_smoke.py"
    examples = [SRC.parent / "examples" / f"{name}.py" for name in EXAMPLES]
    for path in [*pkg.rglob("*.py"), chip_smoke, *examples]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1].split(".")[0]
                assert mod not in ("jax", "repro"), f"{path}: {line}"


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")


@pytest.mark.parametrize("entry", ["build_tree", "build_index", "batch_search",
                                   "tree_from_numpy", "init_params", "prefill",
                                   "transformer_params_from_numpy",
                                   "Index.create", "Index.open",
                                   "SearchSession.load_or_build",
                                   "launch.serve", "launch.index",
                                   "local_mesh", "forward (MoE)", "launch.train",
                                   "loss_fn", "train_state_from_numpy",
                                   "dlrm_smoke", "gin_smoke", "dlrm_forward",
                                   "gnn.prepare", "launch.dryrun"])
def test_default_device_raises_without_cuda(entry, tmp_path):
    _no_cuda()
    x = np.zeros((16, 4), np.float32)
    tree = interop.tree_from_numpy([x[:2], np.zeros((2, 2, 4), np.float32)],
                                   device="cpu")
    cfg = GEMMA3_4B_SMOKE
    cpu_params = init_params(cfg.param_specs(), torch.Generator().manual_seed(0),
                             device="cpu")
    dlrm = recsys.DLRMConfig(vocab_per_field=8, embed_dim=4, bot_mlp=(4,), top_mlp=(4, 1))
    calls = {
        "build_tree": lambda: repro_torch.build_tree(
            x, (2, 2), generator=torch.Generator().manual_seed(0)),
        "build_index": lambda: repro_torch.build_index(x, tree),
        "batch_search": lambda: repro_torch.batch_search(None, tree, x, 1),
        "tree_from_numpy": lambda: interop.tree_from_numpy([x[:2]]),
        "init_params": lambda: init_params(
            cfg.param_specs(), torch.Generator().manual_seed(0)),
        "prefill": lambda: tfm.prefill(cpu_params, cfg, x[:1, :4].astype(np.int32), 8),
        "Index.create": lambda: repro_torch.Index.create(tree),
        "Index.open": lambda: repro_torch.Index.open(_cpu_index_dir(tree, tmp_path)),
        "SearchSession.load_or_build": lambda: SearchSession.load_or_build(
            _cpu_index_dir(tree, tmp_path), build_fn=None),
        "launch.serve": lambda: serve.main(["--rows", "64", "--dim", "4",
                                            "--images", "8"]),
        "launch.index": lambda: index_cli.main(["--rows", "64", "--dim", "4",
                                                "--block-rows", "32"]),
        "local_mesh": lambda: repro_torch.local_mesh(),
        "launch.train": lambda: train_cli.main(["--steps", "2",
                                                "--ckpt-dir", str(tmp_path)]),
        "loss_fn": lambda: tfm.loss_fn(
            cpu_params, cfg, {"tokens": x[:1, :4].astype(np.int32),
                              "labels": x[:1, :4].astype(np.int32)}),
        "train_state_from_numpy": lambda: interop.train_state_from_numpy(
            *interop.train_state_to_numpy(cpu_params, {
                "m": cpu_params, "v": cpu_params,
                "step": torch.zeros((), dtype=torch.int32)}), cfg),
        "dlrm_smoke": lambda: crec.dlrm_smoke(),
        "gin_smoke": lambda: cgnn.gin_smoke(),
        "dlrm_forward": lambda: recsys.dlrm_forward(
            init_params(dlrm.param_specs(), torch.Generator().manual_seed(0),
                        device="cpu"), dlrm,
            {"dense": np.zeros((2, 13), np.float32), "sparse": np.zeros((2, 26), np.int32)}),
        "gnn.prepare": lambda: gnn.prepare({"feats": x, "edges": np.zeros((2, 3), np.int32)}),
        "launch.dryrun": lambda: dryrun.main(["--arch", "gin-tu", "--shape", "molecule"]),
        "forward (MoE)": lambda: tfm.forward(
            init_params(MOONSHOT_V1_16B_SMOKE.param_specs(),
                        torch.Generator().manual_seed(0), device="cpu"),
            MOONSHOT_V1_16B_SMOKE, x[:1, :4].astype(np.int32)),
        "transformer_params_from_numpy": lambda: interop.transformer_params_from_numpy(
            dict(embed=cpu_params["embed"].numpy(),
                 final_norm=cpu_params["final_norm"].numpy(),
                 layers={k: t.numpy() for k, t in cpu_params["layers"].items()}), cfg),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def _cpu_index_dir(tree, tmp_path):
    d = str(tmp_path / "idx")
    repro_torch.Index.create(tree, d, device="cpu")
    return d


def test_resolve_cpu_when_asked():
    assert resolve("cpu") == torch.device("cpu")
