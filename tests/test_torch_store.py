"""repro_torch's DescriptorStore and VirtualStore against the JAX
package's: the same directory format read both ways, the same virtual
blocks from the same seed, and the gather contract of ``read_rows``."""

import numpy as np
import pytest

from repro.data.store import DescriptorStore as JStore
from repro.data.store import VirtualStore as JVirtual
from repro_torch.data.store import DescriptorStore, VirtualStore


def _files(d):
    return sorted(p.name for p in d.iterdir())


def test_create_read_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    ids = np.arange(1000, 1300, dtype=np.int64)
    st = DescriptorStore.create(str(tmp_path / "s"), vecs, block_rows=128,
                                ids=ids)
    assert (st.n_rows, st.dim, st.block_rows, st.n_blocks) == (300, 16, 128, 3)
    st2 = DescriptorStore(str(tmp_path / "s"))
    np.testing.assert_array_equal(np.concatenate([b.vecs for b in st2.blocks()]),
                                  vecs)
    np.testing.assert_array_equal(np.concatenate([b.ids for b in st2.blocks()]),
                                  ids)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_cross_read(tmp_path, writer):
    """Each package reads the other's store; the files are byte-identical."""
    vecs = np.arange(250 * 4, dtype=np.float32).reshape(250, 4)
    ids = np.arange(250, dtype=np.int64) * 3
    a, b = tmp_path / "port", tmp_path / "ref"
    DescriptorStore.create(str(a), vecs, block_rows=64, ids=ids)
    JStore.create(str(b), vecs, block_rows=64, ids=ids)
    assert _files(a) == _files(b)
    for name in _files(a):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    reader = (JStore(str(a)) if writer == "port"
              else DescriptorStore(str(b)))
    rows = np.array([249, 0, 192, 63, 249, 64])
    np.testing.assert_array_equal(reader.read_rows(rows), vecs[rows])
    np.testing.assert_array_equal(reader.read_block(3).ids, ids[192:])


def test_virtual_store_matches_reference():
    t = VirtualStore(1000, 8, block_rows=256, seed=7)
    j = JVirtual(1000, 8, block_rows=256, seed=7)
    assert t.n_blocks == j.n_blocks == 4
    for b in range(4):
        np.testing.assert_array_equal(t.read_block(b).vecs, j.read_block(b).vecs)
        np.testing.assert_array_equal(t.read_block(b).ids, j.read_block(b).ids)
    np.testing.assert_array_equal(t.sample_for_tree(64), j.sample_for_tree(64))
    rows = np.array([5, 255, 256, 511, 999, 3])
    np.testing.assert_array_equal(t.read_rows(rows), j.read_rows(rows))


def test_non_divisible_tail_block(tmp_path):
    vecs = np.arange(250 * 4, dtype=np.float32).reshape(250, 4)
    st = DescriptorStore.create(str(tmp_path / "s"), vecs, block_rows=64)
    assert [st.read_block(b).vecs.shape[0] for b in range(4)] == [64, 64, 64, 58]
    rows = np.array([0, 63, 64, 191, 192, 249])
    np.testing.assert_array_equal(st.read_rows(rows), vecs[rows])


def test_read_rows_bounds(tmp_path):
    st = DescriptorStore.create(str(tmp_path / "s"),
                                np.zeros((10, 4), np.float32), block_rows=4)
    with pytest.raises(IndexError):
        st.read_rows(np.array([10]))
    with pytest.raises(IndexError):
        st.read_rows(np.array([-1]))
    assert st.read_rows([]).shape == (0, 4)
    with pytest.raises(ValueError):
        st.read_rows(np.zeros((2, 2), np.int64))


def test_read_rows_out_of_order_duplicates_and_tail(tmp_path):
    vecs = np.arange(250 * 4, dtype=np.float32).reshape(250, 4)
    st = DescriptorStore.create(str(tmp_path / "s"), vecs, block_rows=64)
    rows = np.array([249, 0, 192, 63, 249, 64, 0, 191, 248])
    np.testing.assert_array_equal(st.read_rows(rows), vecs[rows])
    np.testing.assert_array_equal(st.read_rows(list(rows)), vecs[rows])
    np.testing.assert_array_equal(st.read_rows(249), vecs[[249]])
    vst = VirtualStore(250, 4, block_rows=64, seed=3)
    all_vecs = np.concatenate([b.vecs for b in vst.blocks()])
    np.testing.assert_array_equal(vst.read_rows(rows), all_vecs[rows])
