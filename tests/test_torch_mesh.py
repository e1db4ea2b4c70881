"""repro_torch's mesh of devices: ``DeviceMesh``, ``local_mesh`` and
``shard_submeshes`` (the JAX package's grouping, read from a subprocess
on four host devices), the collectives against a numpy model of their
semantics (``all_to_all`` tiled on dim 0, ``psum``, ``gather``,
``broadcast``), and -- on two or more cards, skipped here -- every kernel
launched on ``cuda:1`` while ``cuda:0`` is current, equal bit for bit to
its launch on ``cuda:0`` and to its plain version, with its launch counted
on the device it ran on."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.distributed import collectives
from repro_torch.distributed.meshutil import (
    DeviceMesh,
    data_axis_size,
    local_mesh,
    round_up,
    shard_submeshes,
)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ref_groups(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ref") / "submeshes.npz"
    run = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "mesh_reference.py"),
         "submeshes", str(out)], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(out))


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4])
def test_shard_submeshes_group_as_the_reference(ref_groups, n_dev):
    # devices named by position: cpu:0 .. cpu:n-1 stand for the
    # reference's device ids 0 .. n-1
    mesh = DeviceMesh(tuple(torch.device("cpu", i) for i in range(n_dev)))
    for n in (1, 2, 3, 4):
        got = [[d.index for d in m.devices] for m in shard_submeshes(mesh, n)]
        assert got == ref_groups[f"sub_{n_dev}_{n}"].tolist(), (n_dev, n)


def test_device_mesh_basics():
    mesh = DeviceMesh((CPU,) * 4)
    assert mesh.n_shards == data_axis_size(mesh) == 4
    assert mesh.first == CPU and mesh.distinct == (CPU,)
    assert local_mesh("cpu") == DeviceMesh((CPU,))
    assert round_up(4097, 4) == 4100
    with pytest.raises(ValueError, match="at least one device"):
        DeviceMesh(())
    with pytest.raises(ValueError, match="n_shards=0"):
        shard_submeshes(mesh, 0)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a machine without a card")
def test_a_mesh_naming_a_missing_card_raises():
    with pytest.raises(RuntimeError, match="CUDA device"):
        DeviceMesh((torch.device("cuda", 0),))
    with pytest.raises(RuntimeError, match="CUDA device"):
        local_mesh()


def _model_all_to_all(sends):
    """numpy ``jax.lax.all_to_all(x, axis, 0, 0, tiled=True)``."""
    n = len(sends)
    c = sends[0].shape[0] // n
    return [np.concatenate([s[d * c:(d + 1) * c] for s in sends])
            for d in range(n)]


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("trailing", [(), (3,)])
def test_all_to_all_is_the_tiled_exchange(n, trailing):
    rng = np.random.default_rng(n)
    sends = [rng.integers(-9, 9, size=(n * 5,) + trailing).astype(np.int32)
             for _ in range(n)]
    mesh = DeviceMesh((CPU,) * n)
    got = collectives.all_to_all([torch.as_tensor(s) for s in sends], mesh)
    for g, want in zip(got, _model_all_to_all(sends)):
        np.testing.assert_array_equal(g.numpy(), want)


def test_psum_gather_broadcast():
    mesh = DeviceMesh((CPU,) * 3)
    parts = [torch.tensor(v) for v in (2, 5, 11)]
    assert int(collectives.psum(parts, mesh)) == 18
    assert collectives.gather(parts, mesh).tolist() == [2, 5, 11]
    t = torch.arange(4)
    assert all(torch.equal(b, t) for b in collectives.broadcast(t, mesh))
    with pytest.raises(ValueError, match="2 tensors for 3 shards"):
        collectives.gather(parts[:2], mesh)
    with pytest.raises(ValueError, match="does not split over 3"):
        collectives.all_to_all([torch.zeros(4)] * 3, mesh)


# ---------------------------------------------------------------------------
# every kernel on a card that is not the current one (two cards or more)
# ---------------------------------------------------------------------------


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def _scan_cases(k_dense, k_adc):
    from repro_torch.kernels.adcscan.ops import adc_topk
    from repro_torch.kernels.fusedscan.ops import fused_adc_topk, fused_topk
    from repro_torch.kernels.l2nn.ops import l2_nearest
    from repro_torch.kernels.l2topk.ops import l2_topk

    rng = np.random.default_rng(0)
    P, Q, d, m, C = 600, 90, 32, 4, 16
    plf = np.sort(rng.integers(0, 5, size=P)).astype(np.int32)
    qlf = rng.integers(0, 5, size=Q).astype(np.int32)
    pts = rng.integers(-8, 8, size=(P, d)).astype(np.float32)
    qrs = rng.integers(-8, 8, size=(Q, d)).astype(np.float32)
    ids = np.arange(P, dtype=np.int32)
    codes = rng.integers(0, C, size=(P, m)).astype(np.uint8)
    lut = rng.integers(0, 50, size=(Q, m, C)).astype(np.float32)
    return {
        "l2nn": (l2_nearest, (qrs, pts[:40]), {}),
        "l2topk": (l2_topk, (pts, plf, qrs, qlf), dict(k=k_dense)),
        "fusedscan": (fused_topk, (pts, plf, ids, qrs, qlf), dict(k=k_dense)),
        "adcscan": (adc_topk, (codes, plf, lut, qlf), dict(k=k_adc)),
        "fusedadc": (fused_adc_topk, (codes, plf, ids, lut, qlf), dict(k=k_adc)),
    }


def _launch_on(dev, fn, arrays, kw):
    args = [torch.as_tensor(a, device=dev) for a in arrays]
    out = fn(*args, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return [t.cpu() for t in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["l2nn", "l2topk", "fusedscan", "adcscan",
                                  "fusedadc"])
@pytest.mark.parametrize("wide", [False, True])
def test_cuda_scan_kernels_launch_on_a_card_that_is_not_current(
        two_cards, name, wide):
    if wide and name == "l2nn":
        pytest.skip("l2nn has no wide variant")
    c0, c1 = two_cards
    fn, arrays, kw = _scan_cases(*((100, 150) if wide else (20, 20)))[name]
    plain = _launch_on(CPU, fn, arrays, kw)
    torch.cuda.set_device(c0)
    # cuda:1 first: its shared-memory opt-in and cluster count are its own
    before = fn.by_device[1]
    on1 = _launch_on(c1, fn, arrays, kw)
    assert fn.by_device[1] == before + 1
    on0 = _launch_on(c0, fn, arrays, kw)
    on1_again = _launch_on(c1, fn, arrays, kw)
    assert torch.cuda.current_device() == 0
    for a, b, c, p in zip(on1, on0, on1_again, plain):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, p)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,dtype,hd", [("cuda_core", torch.float32, 8),
                                             ("tensor_core", torch.bfloat16, 64)])
def test_cuda_flashattn_launches_on_a_card_that_is_not_current(
        two_cards, kernel, dtype, hd):
    from repro_torch.kernels.flashattn.ops import flash_attention

    c0, c1 = two_cards
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 64, 4, hd), generator=g).to(dtype)
               for _ in range(3))
    torch.cuda.set_device(c0)
    outs = [flash_attention(q.to(dev), k.to(dev), v.to(dev), kernel=kernel).cpu()
            for dev in (c1, c0, c1)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.cuda
def test_cuda_kernel_refuses_tensors_on_two_cards(two_cards):
    from repro_torch.kernels.l2nn.ops import l2_nearest

    c0, c1 = two_cards
    with pytest.raises(ValueError, match="tensors on"):
        l2_nearest(torch.zeros((8, 4), device=c0), torch.zeros((2, 4), device=c1))


@pytest.mark.cuda
def test_cuda_one_card_mesh_of_two_shards_equals_one_shard():
    """A mesh that repeats the card (how one card runs S > 1): build and
    both dense layouts equal the one-shard index's search."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch import batch_search, build_index
    from repro_torch.core.tree import build_tree
    from repro_torch.data import synth

    dev = torch.device("cuda", 0)
    x, _ = synth.sample_descriptors(8192, 32, seed=0, n_centers=40)
    tree = build_tree(x, (8, 8), generator=torch.Generator().manual_seed(1),
                      device=dev)
    q = x[:100] + 1.0
    one = build_index(x, tree, device=dev)
    two = build_index(x, tree, mesh=DeviceMesh((dev, dev)))
    assert int(two.overflow) == 0
    for layout in ("point_major", "query_routed"):
        for impl in ("xla", "fused") if layout == "point_major" else ("xla",):
            a = batch_search(one, tree, q, 10, layout=layout, probes=2,
                             impl=impl, device=dev)
            b = batch_search(two, tree, q, 10, layout=layout, probes=2,
                             impl=impl, device=dev)
            assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
