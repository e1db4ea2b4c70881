"""repro_torch codes tier: the product quantizer and the exact rerank
against the JAX package's ``repro.codes`` on the CPU.

Training is numpy in both packages, so the same rows give byte-identical
codebooks. Encoding runs through the l2nn kernel's plain version here
(``||c||^2 - 2 x.c`` as a torch matmul) and through numpy in the
reference: the two sum in other orders, so a code may differ only where
the two nearest centroids lie within the fp32 bound of each other
(``kernels/fp32_bound.ties_within_bound``); those are counted, and any
other difference fails. The rerank is bit for bit on integer-valued rows
(every fp32 sum of squared integer differences is exact) and within 4 ulp
of the distance on real-valued rows (numpy sums pairwise, torch in another
order).
"""

import json

import numpy as np
import pytest
import torch

from repro.codes import ProductQuantizer as JPQ
from repro.codes import rerank_exact as j_rerank
from repro_torch import interop
from repro_torch.codes import IndexRowReader, ProductQuantizer, rerank_exact
from repro_torch.data import synth
from repro_torch.kernels.fp32_bound import ties_within_bound

DIM = 32


@pytest.fixture(scope="module")
def rows():
    x, _ = synth.sample_descriptors(6000, DIM, seed=0, n_centers=64)
    return x


@pytest.fixture(scope="module")
def trained(rows):
    kw = dict(m=8, bits=8, seed=0, sample=4000, iters=6)
    return JPQ.train(rows, **kw), ProductQuantizer.train(
        torch.as_tensor(rows), **kw)


@pytest.mark.parametrize("m,bits,sample,iters,seed",
                         [(8, 8, 4000, 6, 0), (4, 4, 100_000, 3, 1),
                          (16, 2, 500, 10, 2)])
def test_train_is_byte_identical_to_reference(rows, m, bits, sample, iters,
                                              seed):
    # sample > rows takes every row; bits=2 leaves dead centres to reseed
    kw = dict(m=m, bits=bits, seed=seed, sample=sample, iters=iters)
    ref = JPQ.train(rows, **kw)
    for given in (rows, torch.as_tensor(rows)):
        got = ProductQuantizer.train(given, **kw)
        assert got.codebooks.tobytes() == ref.codebooks.tobytes()
        assert got.meta == ref.meta
        assert (got.m, got.bits, got.dsub) == (ref.m, ref.bits, ref.dsub)


def test_json_cross_reads_both_ways(trained):
    ref, port = trained
    from_ref = ProductQuantizer.from_json(json.loads(json.dumps(ref.to_json())))
    from_port = JPQ.from_json(json.loads(json.dumps(port.to_json())))
    assert from_ref.codebooks.tobytes() == ref.codebooks.tobytes()
    assert from_port.codebooks.tobytes() == port.codebooks.tobytes()
    assert port.to_json() == ref.to_json()
    assert from_ref.meta == ref.meta and from_port.meta == port.meta
    q = interop.quantizer_from_numpy(ref.codebooks, ref.meta)
    assert q.codebooks.tobytes() == ref.codebooks.tobytes()


def test_footprint_matches_reference(trained):
    ref, port = trained
    assert port.bytes_per_row == ref.bytes_per_row
    assert port.codebook_bytes == ref.codebook_bytes
    assert port.compression_ratio() == ref.compression_ratio()


@pytest.mark.parametrize("noise", [0.0, 0.37])
def test_encode_matches_reference_up_to_fp32_near_ties(rows, trained, noise):
    ref, port = trained
    x = rows + np.float32(noise) * np.random.default_rng(3).standard_normal(
        rows.shape).astype(np.float32)
    want = ref.encode(x)
    got = port.encode(torch.as_tensor(x))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    got = got.numpy()
    ties = 0
    for j in range(port.m):
        sub = torch.as_tensor(x[:, j * port.dsub:(j + 1) * port.dsub])
        a = torch.as_tensor(got[:, j].astype(np.int64))
        b = torch.as_tensor(want[:, j].astype(np.int64))
        ok = ties_within_bound(sub, torch.as_tensor(port.codebooks[j]), a, b)
        assert bool(ok.all()), f"subspace {j}: {int((~ok).sum())} codes differ"
        ties += int((a != b).sum())
    # the near-ties are rare: a handful in 48,000 codes at most
    assert ties <= 0.001 * got.size, ties


@pytest.mark.cuda
@pytest.mark.parametrize("noise", [0.0, 0.37])
def test_cuda_encode_matches_plain_up_to_fp32_near_ties(rows, noise):
    # K3 at encode's shape (d = 16, 256 trained centroids) against the
    # plain version on the CPU: a code may differ only at a near-tie
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    x = np.tile(rows, (12, 1)) + np.float32(noise) * np.random.default_rng(
        4).standard_normal((12 * rows.shape[0], DIM)).astype(np.float32)
    port = ProductQuantizer.train(torch.as_tensor(x), m=2, bits=8, seed=0,
                                  sample=8000, iters=6)
    want = port.encode(torch.as_tensor(x))
    got = port.encode(torch.as_tensor(x, device="cuda"))
    assert got.device.type == "cuda" and got.dtype == torch.uint8
    got = got.cpu()
    for j in range(port.m):
        sub = torch.as_tensor(x[:, j * port.dsub:(j + 1) * port.dsub])
        ok = ties_within_bound(sub, torch.as_tensor(port.codebooks[j]),
                               got[:, j], want[:, j])
        assert bool(ok.all()), f"subspace {j}: {int((~ok).sum())} codes differ"
    assert int((got != want).sum()) <= 0.001 * got.numel()


def test_encode_decode_and_lut_match_reference(rows, trained):
    ref, port = trained
    codes = ref.encode(rows[:300])
    np.testing.assert_array_equal(port.decode(torch.as_tensor(codes)),
                                  ref.decode(codes))
    np.testing.assert_array_equal(port.lut(rows[:50]), ref.lut(rows[:50]))


def test_encode_refuses_non_finite_rows(trained):
    _, port = trained
    x = np.zeros((10, DIM), np.float32)
    x[4, 3] = np.inf
    with pytest.raises(ValueError, match="not finite"):
        port.encode(torch.as_tensor(x))


def _rerank_case(seed, n_rows, n_q, R, *, integer, dups=True):
    rng = np.random.default_rng(seed)
    if integer:
        vecs = rng.integers(0, 256, size=(n_rows, DIM)).astype(np.float32)
        q = rng.integers(0, 256, size=(n_q, DIM)).astype(np.float32)
        vecs[n_rows // 2:] = vecs[: n_rows - n_rows // 2]  # distance ties
    else:
        vecs = (rng.random((n_rows, DIM)) * 255).astype(np.float32)
        q = (rng.random((n_q, DIM)) * 255).astype(np.float32)
    ids = rng.permutation(3 * n_rows)[:n_rows].astype(np.int64)
    cand = ids[rng.integers(0, n_rows, size=(n_q, R))]
    if dups:
        cand[:, 1::5] = cand[:, ::5][:, : cand[:, 1::5].shape[1]]
    cand[rng.random((n_q, R)) < 0.2] = -1
    cand[0] = -1  # a query with no candidate
    cand[1, 3:] = -1  # fewer than k valid
    return vecs, ids, q, cand


def _reader(vecs, ids):
    order = np.argsort(ids)
    sid = ids[order]

    def read(u):
        return vecs[order[np.searchsorted(sid, np.asarray(u))]]

    return read


@pytest.mark.parametrize("k", [1, 10, 40])
@pytest.mark.parametrize("integer", [True, False])
def test_rerank_matches_reference(k, integer):
    vecs, ids, q, cand = _rerank_case(k, 500, 60, 32, integer=integer)
    read = _reader(vecs, ids)
    ji, jd = j_rerank(read, q, cand, k)
    calls = []

    def tread(u):
        calls.append(u)
        return torch.as_tensor(read(u.numpy()))

    ti, td = rerank_exact(tread, torch.as_tensor(q), torch.as_tensor(cand), k)
    assert len(calls) == 1  # one batched fetch of the sorted unique ids
    assert torch.equal(calls[0], torch.unique(calls[0]))
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    np.testing.assert_array_equal(np.isfinite(jd), np.isfinite(td.numpy()))
    if integer:
        np.testing.assert_array_equal(ji, ti.numpy())
        np.testing.assert_array_equal(jd, td.numpy())
    else:
        fin = np.isfinite(jd)
        ulp = np.spacing(np.abs(jd[fin]))
        assert (np.abs(jd[fin] - td.numpy()[fin]) <= 4 * ulp).all()
        # ids may swap only between candidates within those ulp
        assert (ji == ti.numpy()).mean() >= 0.99


def test_rerank_with_all_slots_empty():
    cand = np.full((3, 5), -1, np.int64)
    q = np.zeros((3, DIM), np.float32)
    ji, jd = j_rerank(lambda u: None, q, cand, 4)
    ti, td = rerank_exact(lambda u: None, torch.as_tensor(q),
                          torch.as_tensor(cand), 4)
    np.testing.assert_array_equal(ji, ti.numpy())
    np.testing.assert_array_equal(jd, td.numpy())


def test_index_row_reader_reads_by_id_and_refuses_missing_ids():
    rng = np.random.default_rng(0)
    vecs = rng.integers(0, 256, size=(40, DIM)).astype(np.float32)
    ids = rng.permutation(100)[:40].astype(np.int32)
    ids[[3, 17]] = -1  # tombstoned or padding rows
    index = interop.index_from_numpy(
        vecs=vecs, ids=ids, leaves=np.zeros(40, np.int32),
        offsets=np.array([[0, 40]], np.int32), n_valid=np.array([40]),
        overflow=np.int32(0), n_leaves=1, device="cpu")
    read = IndexRowReader(index)
    want = ids[[5, 0, 39]]
    np.testing.assert_array_equal(read(torch.as_tensor(want)).numpy(),
                                  vecs[[5, 0, 39]])
    for bad in (-1, 1000, int(np.setdiff1d(np.arange(100), ids)[0])):
        with pytest.raises(IndexError):
            read(torch.as_tensor([int(want[0]), bad]))
