"""The segment sum behind GIN's message passing (``kernels/segsum``) and
the recsys embedding gathers' backward, without JAX.

On the CPU: ``segment_csr`` cuts rows into work items of at most
``SEG_CHUNK`` edges in the edges' stable order; ``segsum`` (the plain
version here) equals a float64 scatter-add within ``fp32_bound``'s bound,
and bit for bit a sequential fp32 scatter-add in edge order;
``segment_sum``'s gradient is the transposed sum.

On the card (``cuda``): the kernel against the plain version run on the
CPU (sequential, the kernel's own order): bit for bit on every row of one
work item, within ``fp32_bound.segsum_f64``'s bound on every row, at
GIN's widths (16, 64, 100, 602, 1433) and on a power-law graph whose
longest row spans many items; two runs bit-identical; ``segment_sum``'s
gradient likewise; and ``F.embedding``'s backward (every recsys gather)
bit-identical over two runs on Zipf ids.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.data import graph as tgraph
from repro_torch.kernels import fp32_bound
from repro_torch.kernels.segsum import edge_graph, segment_sum, segsum
from repro_torch.kernels.segsum.ops import SEG_CHUNK, segment_csr


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _graph(n_nodes, avg_degree, seed, device="cpu"):
    g = tgraph.random_graph(n_nodes, avg_degree, seed=seed)
    e = torch.as_tensor(tgraph.to_edge_list(g), device=device)
    w = torch.as_tensor(np.random.default_rng(seed).random(e.shape[1]),
                        dtype=torch.float32, device=device)
    return e[0], e[1], w


def _sequential(h, keys, others, w, n_rows):
    """fp32 scatter-add in edge-list order, one edge after another."""
    out = np.zeros((n_rows, h.shape[1]), np.float32)
    hn, wn = h.numpy(), w.numpy()
    for e in np.argsort(keys.numpy(), kind="stable"):
        out[keys[e]] += wn[e] * hn[others[e]]
    return out


def test_work_items_cover_every_row_in_order():
    keys = torch.tensor([3, 0, 3, 3, 1, 3, 3])
    others = torch.arange(7)
    csr = segment_csr(keys, others, torch.ones(7), 5, chunk=2)
    assert csr.indptr.tolist() == [0, 1, 2, 2, 7, 7]
    assert csr.cols.tolist() == [1, 4, 0, 2, 3, 5, 6]  # stable: edge order kept
    # row 3 (5 edges) in three items of at most 2, writing partial slots 0-2
    assert csr.items.tolist() == [[0, 0, 1, -1], [1, 1, 2, -1], [2, 2, 2, -1],
                                  [3, 2, 4, 0], [3, 4, 6, 1], [3, 6, 7, 2],
                                  [4, 7, 7, -1]]
    assert csr.longs.tolist() == [[3, 0, 3, 0]] and csr.n_slots == 3


@pytest.mark.parametrize("d", [1, 5, 33])
def test_plain_version_is_the_sequential_sum(d):
    src, dst, w = _graph(200, 5.0, seed=d)
    h = torch.as_tensor(np.random.default_rng(d).standard_normal((200, d)),
                        dtype=torch.float32)
    graph = edge_graph(src, dst, w, 200)
    out = segsum(h, graph.fwd)
    np.testing.assert_array_equal(out.numpy(), _sequential(h, dst, src, w, 200))
    exact, tol = fp32_bound.segsum_f64(h, graph.fwd)
    assert fp32_bound.segsum_error_ratio(out, exact, tol) <= 1.0


def test_gradient_is_the_transposed_sum():
    src, dst, w = _graph(150, 4.0, seed=3)
    graph = edge_graph(src, dst, w, 150)
    h = torch.randn(150, 7, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    g = torch.randn(150, 7, generator=torch.Generator().manual_seed(1))
    (segment_sum(h, graph) * g).sum().backward()
    np.testing.assert_array_equal(h.grad.numpy(), _sequential(g, src, dst, w, 150))
    with pytest.raises(ValueError, match="no gradient"):
        edge_graph(src, dst, w.clone().requires_grad_(), 150)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _check_on_card(cuda, src, dst, w, n, d, seed):
    h = torch.as_tensor(np.random.default_rng(seed).standard_normal((n, d)),
                        dtype=torch.float32)
    for keys, others in ((dst, src), (src, dst)):  # the forward's and its transpose
        cpu = segment_csr(keys, others, w, n)
        dev = segment_csr(keys.to(cuda), others.to(cuda), w.to(cuda), n)
        plain = segsum(h, cpu)
        out = segsum(h.to(cuda), dev)
        again = segsum(h.to(cuda), dev)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        single = (cpu.indptr[1:] - cpu.indptr[:-1]) <= SEG_CHUNK
        assert torch.equal(out.cpu()[single], plain[single])
        exact, tol = fp32_bound.segsum_f64(h, cpu)
        assert fp32_bound.segsum_error_ratio(out.cpu(), exact, tol) <= 1.0
    return cpu


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64, 100, 602, 1433])
def test_cuda_segsum_matches_plain(cuda, d):
    src, dst, w = _graph(3000, 6.0, seed=d)
    _check_on_card(cuda, src, dst, w, 3000, d, seed=d)


@pytest.mark.cuda
def test_cuda_segsum_splits_long_rows(cuda):
    src, dst, w = _graph(20000, 25.0, seed=7)  # power-law out-degrees
    csr = _check_on_card(cuda, src, dst, w, 20000, 64, seed=7)
    assert csr.n_slots > 0 and int((csr.indptr[1:] - csr.indptr[:-1]).max()) > 4 * SEG_CHUNK


@pytest.mark.cuda
def test_cuda_segment_sum_gradient(cuda):
    src, dst, w = _graph(5000, 10.0, seed=2)
    g = torch.randn(5000, 64, generator=torch.Generator().manual_seed(1))
    grads = []
    for dev in ("cpu", cuda):
        graph = edge_graph(src.to(dev), dst.to(dev), w.to(dev), 5000)
        for _ in range(1 if dev == "cpu" else 2):
            h = torch.randn(5000, 64, generator=torch.Generator().manual_seed(0)).to(dev)
            h.requires_grad_()
            (segment_sum(h, graph) * g.to(dev)).sum().backward()
            grads.append(h.grad.cpu())
    assert torch.equal(grads[1], grads[2])
    exact, tol = fp32_bound.segsum_f64(g, edge_graph(src, dst, w, 5000).bwd)
    assert fp32_bound.segsum_error_ratio(grads[1], exact, tol) <= 1.0
    assert fp32_bound.segsum_error_ratio(grads[0], exact, tol) <= 1.0


@pytest.mark.cuda
def test_cuda_embedding_backward_is_deterministic(cuda):
    """The recsys gathers' backward: Zipf ids (a few rows take most of the
    lookups) give the same table gradient bit for bit on every run, within
    the fp32 bound of a float64 sum (gamma_n x the sum of |terms| for a row
    looked up n times)."""
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(np.minimum(rng.zipf(1.2, (65536, 26)), 99_999)).flatten()
    table = torch.randn(100_000, 64, generator=torch.Generator().manual_seed(0))
    g = torch.randn(ids.numel(), 64, generator=torch.Generator().manual_seed(1))
    grads = []
    for _ in range(2):
        t = table.to(cuda).requires_grad_()
        F.embedding(ids.to(cuda), t).backward(g.to(cuda))
        grads.append(t.grad.cpu())
    assert torch.equal(grads[0], grads[1])
    exact = torch.zeros(100_000, 64, dtype=torch.float64).index_add_(0, ids, g.double())
    mag = torch.zeros(100_000, 64, dtype=torch.float64).index_add_(0, ids, g.double().abs())
    n = torch.bincount(ids, minlength=100_000).double()[:, None]
    tol = n * fp32_bound.U32 / (1 - n * fp32_bound.U32) * mag
    assert ((grads[0].double() - exact).abs() <= tol).all()
