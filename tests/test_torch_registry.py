"""The port's cell registry (``configs/``) against the JAX package's: the
architectures, their shapes and ``ASSIGNED`` in the reference's order;
each cell's kind, skip, model FLOPs and per-device argument bytes on the
reference's layouts; the hill-climb variants; and each architecture's
smoke on the CPU. Reference objects are built only (``make_args`` on an
abstract mesh): nothing of the reference is lowered or run."""

import dataclasses
import math

import jax
import numpy as np
import pytest

from repro.configs import ASSIGNED as REF_ASSIGNED
from repro.configs import REGISTRY as REF
from repro.configs import variants as ref_variants
from repro.distributed.meshutil import abstract_mesh
from repro_torch.configs import ASSIGNED, REGISTRY, get_arch, variants
from repro_torch.configs.base import CARD_CAPACITY, halvings
from repro_torch.train import tree

LAYOUTS = {"16x16": ((16, 16), ("data", "model")),
           "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
           "1x1": ((1, 1), ("data", "model"))}
CELLS = [(a, s) for a in REF for s in REF[a].cells]
LM_ARCHS = [a for a in REF if REF[a].family == "lm"]
VARIANT_CASES = ([("head_pad", "llama3.2-3b", "train_4k"),
                  ("routed_moe", "phi3.5-moe-42b-a6.6b", "train_4k"),
                  ("query_routed", "sift100m", "search_1m")]
                 + [(v, a, "train_4k") for v in ref_variants.VARIANTS for a in LM_ARCHS])


def _ref_bytes(cell) -> dict:
    """Per layout: (bytes one device holds, leaf count) of the reference's
    ``make_args`` on its abstract mesh."""
    out = {}
    for name, (shape, axes) in LAYOUTS.items():
        args, shardings = cell.make_args(abstract_mesh(shape, axes))
        leaves, sh = jax.tree.leaves(args), jax.tree.leaves(shardings)
        out[name] = (sum(math.prod(s.shard_shape(a.shape)) * np.dtype(a.dtype).itemsize
                         for a, s in zip(leaves, sh)), len(leaves))
    return out


def _port_bytes(cell) -> dict:
    out = {}
    for name, (shape, axes) in LAYOUTS.items():
        layout = dict(zip(axes, shape))
        out[name] = (cell.argument_bytes(layout), len(tree.leaves(cell.abstract(layout))))
    return out


def test_architectures_shapes_and_assigned_in_the_reference_order():
    assert list(REGISTRY) == list(REF)
    for a in REF:
        assert list(REGISTRY[a].cells) == list(REF[a].cells), a
        assert REGISTRY[a].family == REF[a].family
    assert ASSIGNED == REF_ASSIGNED
    assert len(CELLS) == 44
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("gpt-5")
    with pytest.raises(KeyError, match="has no shape"):
        REGISTRY["gin-tu"].cell("train_4k")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_kind_skip_and_flops(arch, shape):
    ref, port = REF[arch].cell(shape), REGISTRY[arch].cell(shape)
    assert port.kind == ref.kind
    assert (port.skip is None) == (ref.skip is None)
    assert port.skip == ref.skip
    assert port.model_flops == pytest.approx(ref.model_flops, rel=1e-12)


def test_step_flops_are_the_model_flops_but_two_towers_train():
    # the reference's two-tower train_batch counts the step's factor of 3
    # twice; mfu reads the step's own count, a third of it
    for arch, shape in CELLS:
        cell = REGISTRY[arch].cell(shape)
        want = cell.model_flops / (3 if (arch, shape) == ("two-tower-retrieval",
                                                           "train_batch") else 1)
        assert cell.step_flops(cell.full_batch) == pytest.approx(want, rel=1e-12), (arch, shape)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_argument_bytes_per_device(arch, shape):
    assert _port_bytes(REGISTRY[arch].cell(shape)) == _ref_bytes(REF[arch].cell(shape))


def _ref_cfg(cell):
    """The config the reference's cell closes over (its ``make_fn``)."""
    fn = cell.make_fn
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__ or ()))).get("cfg")


def _diff(cfg, base) -> dict:
    if cfg is None:
        return {}
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if getattr(cfg, f.name) != getattr(base, f.name)}


@pytest.mark.parametrize("variant,arch,shape", VARIANT_CASES)
def test_variant_cells(variant, arch, shape):
    ref, port = ref_variants.apply(variant, arch, shape), variants.apply(variant, arch, shape)
    assert port.kind == ref.kind
    assert port.model_flops == pytest.approx(ref.model_flops, rel=1e-12)
    assert _port_bytes(port) == _ref_bytes(ref)
    if REF[arch].family == "lm":
        assert _diff(port.config, REGISTRY[arch].config) == _diff(
            _ref_cfg(ref), REF[arch].config)


def test_flat_mesh_variants_shard_rows_over_every_axis():
    for name, shape in (("flat_mesh", "index_wave"), ("query_routed_flat", "search_32k")):
        assert _port_bytes(variants.apply(name, "sift100m", shape)) == _ref_bytes(
            ref_variants.apply(name, "sift100m", shape)), name
    with pytest.raises(KeyError):
        variants.apply("query_routed", "din", "serve_p99")


def test_card_cuts_are_halvings_of_the_batch_within_the_card():
    assert halvings(256) == [256, 128, 64, 32, 16, 8, 4, 2, 1]
    assert halvings(1_000_000)[-2:] == [15625, 1]
    llama = REGISTRY["llama3.2-3b"]
    cut = llama.cell("decode_32k").card_cut()
    # the bf16 KV cache is 3.76 GB a sequence at 32k
    assert cut.fits and cut.batch < 128 and cut.need_bytes <= CARD_CAPACITY
    assert (cut.axis, cut.full) == ("sequences", 128)
    assert llama.cell("decode_32k").card_bytes(2 * cut.batch) > CARD_CAPACITY
    phi = REGISTRY["phi3.5-moe-42b-a6.6b"].cell("prefill_32k").card_cut()
    assert not phi.fits and "smallest layout holding it" in phi.reason
    assert REGISTRY["gin-tu"].cell("molecule").card_cut().batch == 1


def _ref_smoke_params(arch) -> int:
    """The parameter count of the reference's smoke config (its smoke is
    never run here: its jit compiles would cost minutes)."""
    from repro.models import gnn, recsys

    import importlib

    lm = {"llama3.2-3b": "llama32_3b", "gemma3-4b": "gemma3_4b",
          "internlm2-1.8b": "internlm2_18b", "moonshot-v1-16b-a3b": "moonshot_v1_16b",
          "phi3.5-moe-42b-a6.6b": "phi35_moe"}
    if arch in lm:
        return importlib.import_module(f"repro.configs.{lm[arch]}").SMOKE_CONFIG.param_count()
    return {
        "gin-tu": lambda: gnn.GINConfig(name="gin-smoke", n_layers=3, d_in=12,
                                        d_hidden=16, n_classes=4),
        "dlrm-rm2": lambda: recsys.DLRMConfig(name="dlrm-smoke", vocab_per_field=1000,
                                              embed_dim=16, bot_mlp=(32, 16),
                                              top_mlp=(32, 16, 1)),
        "din": lambda: recsys.DINConfig(name="din-smoke", vocab=2000, seq_len=20,
                                        gru_dim=0, attn_mlp=(16, 8), mlp=(24, 12)),
        "dien": lambda: recsys.DINConfig(name="din-smoke", vocab=2000, seq_len=20,
                                         gru_dim=16, attn_mlp=(16, 8), mlp=(24, 12)),
        "two-tower-retrieval": lambda: recsys.TwoTowerConfig(
            name="tt-smoke", vocab_per_field=1000, field_dim=16, tower_mlp=(64, 32),
            embed_dim=32),
    }[arch]().param_count()


@pytest.mark.parametrize("arch", list(REF))
def test_smoke_on_the_cpu(arch):
    out = REGISTRY[arch].smoke(device="cpu")
    assert all(math.isfinite(v) for v in out.values()), out
    if arch == "sift100m":
        assert out["leaves"] == 64 and out["top1_exact"] >= 62 / 64
    else:
        assert out["params"] == _ref_smoke_params(arch)
