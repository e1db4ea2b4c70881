"""The port's logical-axis partitioning (``distributed/partitioning.py``)
against the JAX package's: the reference's own cases as the port's
tuples, and every parameter of every architecture on four layouts."""

import jax
import pytest
import torch

from repro.configs import REGISTRY as REF_REGISTRY
from repro.distributed import partitioning as ref_part
from repro.distributed.meshutil import abstract_mesh
from repro.models.module import ParamSpec as RefParamSpec
from repro_torch.configs import REGISTRY
from repro_torch.distributed.partitioning import (
    DEFAULT_RULES,
    partition_spec,
    shard_shape,
    shard_specs,
)
from repro_torch.distributed.shardutil import Arg, abstract_opt_state, tree_shardings
from repro_torch.launch.mesh import card_layout, make_production_layout
from repro_torch.train import tree

LAYOUT_1POD = make_production_layout()
LAYOUT_2POD = make_production_layout(multi_pod=True)
LAYOUTS = {"16x16": LAYOUT_1POD, "2x16x16": LAYOUT_2POD,
           "1x4": {"data": 1, "model": 4}, "4x1": {"data": 4, "model": 1}}


def test_production_layouts():
    assert LAYOUT_1POD == {"data": 16, "model": 16}
    assert list(LAYOUT_2POD.items()) == [("pod", 2), ("data", 16), ("model", 16)]
    assert card_layout() == {"data": 1, "model": 1}


def test_batch_shards_over_pod_and_data():
    spec = partition_spec((256, 4096), ("batch", None), LAYOUT_2POD, DEFAULT_RULES)
    assert spec == (("pod", "data"), None)


def test_divisibility_fallback_heads():
    # llama3.2: 24 heads don't divide model=16 -> replicate that dim
    spec = partition_spec((28, 24, 128), ("layers", "heads", "head_dim"), LAYOUT_1POD)
    assert spec == (None, None, None)
    # but the fused qkv projection (3072) shards
    spec = partition_spec((28, 3072, 3072), ("layers", "embed", "qkv"), LAYOUT_1POD)
    assert spec == (None, None, "model")


def test_axis_used_once_per_array():
    # both dims want 'model'; first one wins, second replicates
    assert partition_spec((64, 1408), ("experts", "ffn"), LAYOUT_1POD) == ("model", None)


def test_kv_seq_takes_free_axes():
    # decode_32k: batch takes (pod,data); kv_seq gets model
    axes = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    spec = partition_spec((32, 128, 32768, 8, 128), axes, LAYOUT_2POD)
    assert spec == (None, ("pod", "data"), "model", None, None)
    # long_500k: batch=1 replicates; kv_seq gets all three axes
    spec = partition_spec((32, 1, 524288, 8, 128), axes, LAYOUT_2POD)
    assert spec == (None, None, ("pod", "data", "model"), None, None)


def test_non_divisible_batch_replicates():
    assert partition_spec((1, 128), ("batch", None), LAYOUT_2POD) == (None, None)


def test_rank_mismatch_raises():
    with pytest.raises(ValueError, match="rank"):
        partition_spec((4, 4), ("batch",), LAYOUT_1POD, DEFAULT_RULES)


def test_rules_extension():
    rules = DEFAULT_RULES.extend(qkv=None)
    assert partition_spec((32, 3072), ("embed", "qkv"), LAYOUT_1POD, rules) == (None, None)


def test_vocab_shards_all_lm_archs():
    for v in (128256, 262144, 92544, 163840, 32064):
        assert partition_spec((v, 2048), ("vocab", "embed"), LAYOUT_1POD) == (
            "model", None), v


def test_shard_shape_and_opt_state_layouts():
    assert shard_shape((256, 4096, 16), (("pod", "data"), None, "model"),
                       LAYOUT_2POD) == (8, 4096, 1)
    with pytest.raises(ValueError, match="split"):
        shard_shape((8,), ("model",), LAYOUT_1POD)
    params = {"w": Arg((64, 1408), torch.bfloat16, ("experts", "ffn"))}
    opt = abstract_opt_state(params)
    assert opt["m"]["w"].dtype == torch.float32 and opt["step"].shape == ()
    specs = tree_shardings(opt, LAYOUT_1POD)
    assert specs["m"]["w"] == specs["v"]["w"] == ("model", None)
    assert specs["step"] == ()


def _ref_param_specs(arch):
    specs = REF_REGISTRY[arch].config.param_specs()
    return jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, RefParamSpec))


@pytest.mark.parametrize("arch", [a for a in REGISTRY if a != "sift100m"])
def test_every_param_spec_equals_the_reference(arch):
    ref = _ref_param_specs(arch)
    specs = REGISTRY[arch].config.param_specs()
    port = tree.leaves(specs)
    assert [tuple(s.shape) for s in port] == [tuple(s.shape) for s in ref]
    for name, layout in LAYOUTS.items():
        mesh = abstract_mesh(tuple(layout.values()), tuple(layout))
        want = [tuple(ref_part.partition_spec(s.shape, s.axes, mesh)) for s in ref]
        assert want == [partition_spec(s.shape, s.axes, layout) for s in port], name
        assert want == _spec_leaves(shard_specs(specs, layout)), name


def _spec_leaves(specs) -> list:
    """A dict tree of spec tuples' leaves, in sorted-key order."""
    if isinstance(specs, dict):
        return [leaf for key in sorted(specs) for leaf in _spec_leaves(specs[key])]
    return [specs]
