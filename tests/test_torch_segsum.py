"""The segment sum behind GIN's message passing (``kernels/segsum``) and
the recsys embedding gathers' backward, without JAX.

On the CPU: ``segment_csr`` cuts rows into work items of at most
``SEG_CHUNK`` edges in the edges' stable order and plans the tree that
adds a long row's partial rows (every partial row added exactly once, the
tree's shape fixed by the row's partial count alone, the kernel's order
of adds within the fp32 bound); ``segsum`` (the plain version here)
equals a float64 scatter-add within ``fp32_bound``'s bound, and bit for
bit a sequential fp32 scatter-add in edge order; ``segment_sum``'s
gradient is the transposed sum.

On the card (``cuda``): the kernel against the plain version run on the
CPU (sequential, the kernel's own order): bit for bit on every row of one
work item, within ``fp32_bound.segsum_f64``'s bound on every row, at
GIN's widths (16, 64, 100, 602, 1433) and on a power-law graph whose
longest row spans many items; bit for bit the kernel's own order of adds
(``_kernel_order``) on rows of 1, 2, 3 and 4,849 items and a 1,792-item
hub, both orders of the edges; two runs bit-identical; ``segment_sum``'s
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
from repro_torch.kernels.segsum.ops import (
    SEG_CHUNK,
    SEG_GROUP,
    items_pass,
    segment_csr,
    tree_pass,
    tree_plan,
)


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
    # its three partial rows added in order by one group, into output row 3
    assert csr.tree.tolist() == [[-4, 0, 3, 0]] and csr.tree_levels == (0, 1)
    assert csr.part_rows == 3


@pytest.mark.parametrize("group", [SEG_GROUP, 3])
def test_tree_adds_every_partial_row_once(group):
    # long rows of 2, 3, 4,849 and 1,792 partial rows (ogb_products'
    # padding row and the backward's hub at SEG_CHUNK), slots laid out as
    # segment_csr lays them, after 10 leaf slots of no row's
    n = torch.tensor([2, 3, 4849, 1792, 4849])
    rows = torch.tensor([5, 9, 0, 17, 40])
    first = 10 + torch.cumsum(n, 0) - n
    free = int(first[-1] + n[-1])
    tree, levels, part_rows = tree_plan(rows, first, n, free, group)
    assert levels[0] == 0 and levels[-1] == tree.shape[0]
    t = tree.long()
    reads = torch.zeros(part_rows, dtype=torch.long)
    written = torch.zeros(part_rows, dtype=torch.long)
    written[10:free] = 1  # the items' partial rows
    finals = []
    for lv in range(len(levels) - 1):
        g = t[levels[lv]:levels[lv + 1]]
        assert (g[:, 2] >= 1).all() and (g[:, 2] <= group).all()
        for dst, src, cnt, _ in g.tolist():
            # a group reads rows written before its level, each once
            assert (written[src:src + cnt] == 1).all()
            reads[src:src + cnt] += 1
        for dst, src, cnt, _ in g.tolist():
            if dst < 0:
                finals.append(-dst - 1)
            else:
                assert written[dst] == 0
                written[dst] = 1
    assert (reads[10:] == 1).all() and (reads[:10] == 0).all()
    assert sorted(finals) == sorted(rows.tolist())
    # integer partial rows: each output is its row's sum
    val = torch.zeros(part_rows, dtype=torch.float64)
    val[10:free] = torch.arange(free - 10, dtype=torch.float64) % 7 + 1
    out = {}
    for dst, src, cnt, _ in t.tolist():
        total = float(val[src:src + cnt].sum())
        if dst < 0:
            out[-dst - 1] = total
        else:
            val[dst] = total
    for r, f, c in zip(rows.tolist(), first.tolist(), n.tolist()):
        assert out[r] == float((torch.arange(f - 10, f - 10 + c) % 7 + 1).sum())
    # the shape depends on the partial count alone: a row planned alone at
    # other slots has the same levels and group counts, and rows 0 and 40
    # (both 4,849) alike
    shapes = {}
    for r, f, c in zip(rows.tolist(), first.tolist(), n.tolist()):
        for at in (f, f + 3):
            alone = tree_plan(torch.tensor([r]), torch.tensor([at]),
                              torch.tensor([c]), free + at, group)
            shape = [len(alone[1]) - 1, alone[0][:, 2].tolist()]
            assert shapes.setdefault(r, shape) == shape
    assert shapes[0] == shapes[40]
    if group == SEG_GROUP:  # 4,849 -> 152 -> 5 -> 1; 1,792 -> 56 -> 2 -> 1
        assert shapes[0][0] == 3 and shapes[17][0] == 3 and shapes[5][0] == 1


def _kernel_order(h, csr):
    """The kernel's sum in its own order of fp32 operations: each work
    item from 0 in edge order (one rounded product, one rounded add an
    edge), its partial rows then added group by group of the tree, each
    group in slot order from its first row."""
    d = h.shape[1]
    items = csr.items.long()
    out = torch.zeros((csr.n_rows, d), dtype=torch.float32)
    part = torch.zeros((max(1, csr.part_rows), d), dtype=torch.float32)
    acc = torch.zeros((items.shape[0], d), dtype=torch.float32)
    length = items[:, 2] - items[:, 1]
    cols, w = csr.cols.long(), csr.w
    for j in range(int(length.max()) if items.shape[0] else 0):
        live = torch.nonzero(length > j).flatten()
        e = items[live, 1] + j
        acc[live] = acc[live] + w[e][:, None] * h[cols[e]]
    own = items[:, 3] < 0
    out[items[own, 0]] = acc[own]
    part[items[~own, 3]] = acc[~own]
    t = csr.tree.long()
    for lv in range(len(csr.tree_levels) - 1):
        g = t[csr.tree_levels[lv]:csr.tree_levels[lv + 1]]
        s = part[g[:, 1]].clone()
        for j in range(1, int(g[:, 2].max())):
            live = torch.nonzero(g[:, 2] > j).flatten()
            s[live] = s[live] + part[g[live, 1] + j]
        fin = g[:, 0] < 0
        out[-g[fin, 0] - 1] = s[fin]
        part[g[~fin, 0]] = s[~fin]
    return out


def _hub_graph(seed):
    """Rows (by destination) of 1, 2, 3 and 4,849 work items (1,241,246
    edges: ogb_products' padding row) and, by source, a 1,792-item hub
    (458,564 edges), among 3,000 nodes of a few edges each."""
    rng = np.random.default_rng(seed)
    n = 3000
    dst = [np.full(c, r) for r, c in ((7, 200), (8, 300), (9, 700), (0, 1_241_246))]
    dst.append(rng.integers(0, n, size=20_000))
    dst = np.concatenate(dst)
    src = rng.integers(0, n - 1, size=dst.size)
    src[src >= 11] += 1  # node 11 is the hub's alone
    src[rng.permutation(dst.size)[:458_564]] = 11
    w = rng.random(dst.size).astype(np.float32)
    return torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(w), n


def test_kernel_order_holds_the_fp32_bound():
    # the tree's order of adds (small chunks and groups, so that a few
    # hundred edges make rows of many items and trees of several levels)
    # stays within fp32_bound's bound, and equals the plain version on
    # every row of one item
    src, dst, w = _graph(400, 30.0, seed=5)
    h = torch.as_tensor(np.random.default_rng(5).standard_normal((400, 9)),
                        dtype=torch.float32)
    for keys, others in ((dst, src), (src, dst)):
        csr = segment_csr(keys, others, w, 400, chunk=4, group=3)
        assert len(csr.tree_levels) - 1 >= 3
        got = _kernel_order(h, csr)
        exact, tol = fp32_bound.segsum_f64(h, csr)
        assert fp32_bound.segsum_error_ratio(got, exact, tol) <= 1.0
        single = (csr.indptr[1:] - csr.indptr[:-1]) <= 4
        assert torch.equal(got[single], segsum(h, csr)[single])


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


@pytest.mark.cuda
def test_cuda_segsum_long_rows_in_the_tree_order(cuda):
    # rows of 1, 2, 3 and 4,849 items and a 1,792-item hub (the transpose):
    # the kernel equals its own order of adds bit for bit, stays within the
    # float64 bound, and two runs are bit-identical
    src, dst, w, n = _hub_graph(0)
    h = torch.as_tensor(np.random.default_rng(1).standard_normal((n, 64)),
                        dtype=torch.float32)
    for keys, others, longest in ((dst, src, 4849), (src, dst, 1792)):
        cpu = segment_csr(keys, others, w, n)
        assert int(cpu.longs[:, 2].max()) == longest
        dev = segment_csr(keys.to(cuda), others.to(cuda), w.to(cuda), n)
        assert torch.equal(dev.tree.cpu(), cpu.tree) and dev.tree_levels == cpu.tree_levels
        n0 = segsum.launches
        out = segsum(h.to(cuda), dev)
        again = segsum(h.to(cuda), dev)
        torch.cuda.synchronize()
        assert segsum.launches == n0 + 2
        assert torch.equal(out, again)
        assert torch.equal(out.cpu(), _kernel_order(h, cpu))
        exact, tol = fp32_bound.segsum_f64(h, cpu)
        assert fp32_bound.segsum_error_ratio(out.cpu(), exact, tol) <= 1.0


@pytest.mark.cuda
def test_cuda_segsum_passes_apart_are_the_call(cuda):
    # the items pass then the tree pass, each as a timing calls it alone,
    # give the call's bits, and the tree pass repeated over the same
    # partial rows writes the same bits again (no launch is counted)
    src, dst, w, n = _hub_graph(0)
    h = torch.as_tensor(np.random.default_rng(2).standard_normal((n, 64)),
                        dtype=torch.float32).to(cuda)
    for keys, others in ((dst, src), (src, dst)):
        csr = segment_csr(keys.to(cuda), others.to(cuda), w.to(cuda), n)
        n0 = segsum.launches
        out, part = items_pass(h, csr)
        tree_pass(part, out, csr)
        first = out.clone()
        tree_pass(part, out, csr)
        torch.cuda.synchronize()
        assert segsum.launches == n0
        assert torch.equal(first, segsum(h, csr)) and torch.equal(out, first)
