"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a), then:

  1. device: the card's name and power limit, and the kernel build time;
  2. main path at the sift100m deployment's widths (d = 128, a 256 x 256
     vocabulary tree, k = 20, the search_32k batch): ``build_tree`` on a
     2^20-row sample, ``build_index`` on 2^24 quantized SIFT-like rows
     (bf16 wire; 2^25 index rows with the routing padding; one more build
     is traced after the search phases, for its device busy time and l2nn's
     share), and
     ``batch_search`` of 2^15 queries with ``impl="pallas"`` (l2topk in
     every wave), ``impl="fused"`` (one fusedscan launch), and ``"fused"``
     at probes = 2. It checks zero overflows, equal results on both search
     paths, the launch counts, in-leaf top-1 exactness against a brute-force
     scan of the query's leaf for 256 queries, and prints recall@1 against
     the exact full-corpus nearest neighbour;
  3. codes path on the same index and queries, as the JAX package's
     ``Index.search`` runs it on one segment: ``ProductQuantizer.train``
     (m = 8, bits = 8, a 65,536-row sample, 16 iterations, seed 0) on the
     live rows, ``encode`` of every index row (l2nn per subspace), then
     ``search_with_lookup`` with a ``scan_codes`` plan (rerank 128) at
     ``impl="pallas"`` (adcscan in every wave), ``"fused"`` (one fusedadc
     launch) and ``"fused"`` at probes = 2, each followed by
     ``rerank_exact`` to k = 20. It checks zero overflows, bit-identical
     candidates on both scan paths, reranked distances equal to the exact
     distances of their ids, the launch counts, and prints recall@1 next to
     the dense path's and the share of top-1 ids equal to the dense search's.
     For 256 sampled queries it finds where the exact nearest neighbour went
     (among the ADC candidates, in the query's leaf outside them, or in
     another leaf) and, for in-leaf misses, its rank under a plain numpy ADC
     of the leaf; the run fails if the scan dropped a row that numpy ranks
     inside its candidates;
  4. kernels against their plain PyTorch versions at the main path's own
     shapes and inputs: ids and distances bit for bit (the data are
     integers, so every fp32 sum is exact). fusedscan runs the main path's
     call (the whole 2^25-row shard against the padded 2^15-row lookup)
     and is held against the plain version on 256 sampled lookup rows,
     which scans the whole shard in point chunks. Integers in [0, 255] are
     exact in TF32 and bf16 as well, so each kernel is also run on the
     same inputs moved off the integer grid and held within the fp32 error
     bound of a float64 oracle (``kernels/fp32_bound.py``); the plain
     version computed in TF32 must break that bound, or the check fails.
     l2nn is also run at encode's shape: per subspace, one mid-shard
     2^21-row chunk (d = 16, 256 trained centroids), where its codes must
     equal encode's, differ from the plain version's only at near-ties
     within the fp32 bound, and hold that bound while TF32 breaks it; and
     at the shape of most of its launches, build_index's 4,096-row waves
     against the 256 level-0 centroids (64 waves). l2topk runs 64 real
     waves of the dense sweep (its bound counts only what their same-leaf
     pairs need), is timed again with every lookup leaf moved past the
     index's leaves (its floor) and on the wave with the most pairs alone,
     and the dense sweep's trace must show one l2topk kernel a wave.
     adcscan runs 64 waves of the codes sweep as the sweep calls it (the
     wave's sorted leaves and ids, the whole LUT table, the slab start on
     the device), one of them again with tombstones, and is timed once more
     with every lookup leaf moved past the index's leaves (its floor: the
     launch and the empty lists); fusedadc runs the codes
     path's own call (held on 256 sampled lookup rows, like fusedscan);
     their LUTs come from the trained, real-valued codebooks, and ADC adds
     without products, so both are held bit for bit on real values. Prints the
     kernel's, the plain version's and one PyTorch yardstick's time, and
     the roofline bound of the same work;
  5. index lifecycle (``Index``), after the P7 phase: a disk probe (1 GiB
     through ``np.save`` + fsync, ``np.load``, crc32) gives the disk's
     rates; the phase takes the main path's 2^24 rows, halved while the
     disk holds less than 2.5 x the segments' bytes, and 2^22 if the
     script is past 9 minutes when the phase starts. The directory lies in
     this checkout's git-ignored ``build/`` and is removed at the end.
     ``Index.create`` (bf16 wire, as the main path) then 4 ``append``s of
     2^22 of the main path's rows in id order (each segment 2^23 index
     rows, about 4.06 GiB of float32 vectors, ids and leaves), ``commit``;
     the handle is dropped and the main path's index freed. Checks: (1)
     ``Index.open`` on the card (every file crc-checked), point-major at
     ``impl="pallas"`` and ``"fused"`` bit-identical to the main path's
     one-shot results at probes 1, and at probes 2 the distances
     bit-identical with ids differing only inside exact distance ties
     (counted); (2) ``layout="query_routed"`` (K1 on query tiles, each
     tile's point slab read in place from its device-side start)
     bit-identical to (1), overflow 0, traced; (3) the default
     ``idx.search(q, k=20)`` (layout and model "auto") equal to the plan
     it picks, run explicitly; (4) ``delete`` of 1 % of the ids (from
     ``--seed``), ``commit``, reopen: both dense impls return
     no deleted id and equal a one-shot ``build_index`` + ``batch_search``
     of the live rows; K1 and K2 on 64 waves holding dead rows and K2 on
     a segment's call held against their plain versions bit for bit after
     the scan's id mapping; (5) ``compact()`` leaves one segment whose ids,
     leaves, offsets and vectors equal that rebuild's, search results
     unchanged, and ``gc`` leaves only its files; (6) ``enable_codes()``
     (m 8, bits 8): ``scan_codes`` candidates bit-identical between
     fusedadc and adcscan, ``Index.search`` at ``"fused"`` and ``"pallas"``
     equal, and the reranked distances the exact distances of their ids
     read through ``read_rows`` on the card. Every kernel of the path
     (l2topk, fusedscan, l2nn, adcscan, fusedadc) must have been launched
     by the ``Index`` calls themselves (the one-shot references and the
     kernel checks are not counted). Prints each step's wall time, the bytes on disk, the write
     and read rates, peak device memory, and K1's query-tile row (64 real
     tiles against the plain version on the slab's copy, timed with it, a
     library top-k and the bound of the tiles' same-leaf pairs);
     Inside it, after check (3), the serving phase (``repro_torch.serving``)
     on the 4 appended segments: 4,096 one-image requests (256 of the
     index's rows an image, moved by the trace's noise of 4; Zipf s = 1.1
     over the 65,536 images, trace seed 1, all at t = 0) through
     ``MicroBatcher`` (EDF) over a fused ``SearchSession`` (rungs 8192,
     16384, 32768 rows): latency percentiles on the batcher's clock, engine
     ms an image, 0 steady-state recompiles, and over the steady state
     exactly 4 fusedscan launches and 1 l2nn launch a dispatch; 8
     dispatched batches replayed through ``Index.search`` with their rung's
     plan, and a FIFO replay, bit-identical; two ``impl="xla"`` sessions
     (point-major, query-routed; one 2^15-row rung, 2 recorded dispatches
     each) calibrate the card, ``commit`` persists the records, and the
     default ``idx.search(q, k=20)`` is then planned again and timed
     (ROADMAP P10); a 2-shard ``ShardedSearchSession`` equal to the
     unsharded one over 256 requests. After check (4)'s delete + commit the
     session's ``maybe_refresh`` adopts the new cut and equals
     ``Index.search`` with no deleted id; after (6) a fused ``scan_codes``
     session (fusedadc, then the exact rerank) equals ``Index.search`` on
     256 requests; the phase's tracer is written under ``build/`` as a
     Chrome trace and as JSONL, each read by ``scripts/tracereport.py``.
     After the phase, ``python -m repro_torch.launch.serve`` (200,000 rows,
     d = 128, 2,000 images, fanouts 32 x 32, a Zipf trace of 500 requests)
     runs as a subprocess on the card and must exit 0 with 0 steady-state
     recompiles;
  6. LM serving path, after the search phases' tensors are dropped: gemma3-4b
     at full width and depth (34 layers, bf16 weights drawn on the card from
     ``--seed``) serves 4 prompts of 2048 tokens (``lm_batch``): ``prefill``
     with ``attn_impl="chunked"`` (flashattn in every layer), then 32 greedy
     ``decode_step``s; every flashattn launch of the prefill must go to the
     tensor-core kernel (bf16 at hd 256). Checks: (a) the prefill logits
     against the same prefill with ``attn_impl="full"`` (plain
     ``attend``), within the bf16
     model's own rounding error (the largest |bf16 - fp32| logit of the
     full-attention prefill with the same weights in fp32), and layer 0's KV
     cache bit for bit; (b) each decode step against ``forward`` over the
     prompt and the generated tokens at the same position, within that
     rounding error over the prompt's last 33 positions; (c) flashattn
     against its plain version on the q, k, v that the prefill fed to layer
     0 (local) and layer 5 (global): bf16 within
     ``fp32_bound.attention_bf16_tol`` (the tensor-core kernel, and the
     CUDA-core kernel on the same inputs), and fp32 copies moved off the
     bf16 grid (the CUDA-core kernel, which serves fp32) within the fp32
     bound of a float64 oracle, which the plain version in TF32 must break;
     plain variants with the window, the causal diagonal or the GQA head
     map off by one must fail the bf16 check. Prints wall times, tokens/s,
     peak memory, a profiler breakdown of one prefill and one decode step,
     and flashattn's time at layer 5's shape beside the CUDA-core kernel's
     on the same bf16 inputs, its plain version's,
     ``scaled_dot_product_attention``'s and its bound.

Prints one JSON line of per-kernel numbers, then as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when no CUDA device is present or any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

DIM = 128
FANOUTS = (256, 256)
K = 20
SAMPLE_ROWS = 2**20
INDEX_ROWS = 2**24
CHUNK_ROWS = 2**20
N_QUERIES = 2**15
Q_CAP = 1024
BLOCK_ROWS = 4096
N_CHECK = 256  # queries checked against brute force
K1_WAVES = 64  # distinct waves the l2topk kernel is timed over
N_SAMPLE = 256  # lookup rows the fusedscan output is checked on
CHUNK_POINTS = 2**20  # point rows per chunk of the sampled plain version
N_REAL_WAVES = 8  # l2topk waves of the real-valued check
# csrc/fusedscan.cu: rows of a group tile, runs split across a cluster past
F_G, F_LONG = 8, 4096
# the P7 phase: a k and a rerank depth past the KCAP kernels' lists (64, 128)
P7_K, P7_RERANK = 100, 256
# the lifecycle phase: the index grown on disk in LC_APPENDS appends of the
# main path's rows (halved while the disk is short, and to LC_MIN_ROWS in
# all if the phase starts late), in a directory of this checkout's
# git-ignored build/, which the phase removes
LC_APPENDS = 4
LC_MIN_ROWS = 2**22
LC_DIR = Path(__file__).resolve().parent / "build" / "lifecycle_index"
LC_FREE_FACTOR = 2.5  # free disk needed, over the segments' bytes
LC_PROBE_BYTES = 2**30  # the disk probe's array
# the latest script time at which the phase starts at full size: on the
# H100 it has started at about 5.5 min, and it and the LM phase after it
# have taken about 5 min
LC_LATEST_START_S = 9 * 60
N_DEAD_WAVES = 64  # K1 waves held on dense tombstones
N_TILES = 64  # K1 query tiles held and timed
LC_KERNELS = ("l2topk", "fusedscan", "l2nn", "adcscan", "fusedadc")
# the serving phase: one-image requests over the grown index's images
SV_DPI = 256  # descriptors an image (the paper's collection: about 300)
SV_REQUESTS = 4096
SV_SEED = 1  # trace seed
SV_NOISE = 4.0
SV_ZIPF = 1.1
SV_BUCKETS = (8192, 16384, 32768)  # the fused session's rungs
SV_RATE = 4000.0  # paced trace: images a second, about half the H100's burst rate
SV_CACHE_REQUESTS = 512  # paced requests of the cache step
SV_CACHE_LEAVES = 8192  # the cache step's capacity (hot leaves hold about 400 KiB)
SV_REPLAYS = 8  # dispatched batches replayed through Index.search
SV_SUBSET = 256  # requests of the sharded and codes checks
SV_CAL_DISPATCHES = 2  # recorded dispatches of each calibrating session
SV_TRACE = Path(__file__).resolve().parent / "build" / "serving_trace.json"
SV_CLI = ("--rows", "200000", "--dim", "128", "--images", "2000", "--fanout",
          "32", "32", "--trace", "zipf", "--requests", "500")
SIZES = dict(index_rows=INDEX_ROWS, n_queries=N_QUERIES, sample_rows=SAMPLE_ROWS,
             fanouts=FANOUTS, k=K, q_cap=Q_CAP, block_rows=BLOCK_ROWS,
             k1_waves=K1_WAVES, n_sample=N_SAMPLE, lc_appends=LC_APPENDS,
             n_leaves=FANOUTS[0] * FANOUTS[1])
# PQ codes at the JAX package's defaults (Index.enable_codes)
PQ = dict(m=8, bits=8, sample=65_536, iters=16, seed=0)
# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
# LM serving phase: gemma3-4b, 4 prompts of 2048 tokens, 32 decode steps
LM_BATCH = 4
LM_PROMPT = 2048
LM_DECODE = 32
LM_CHECK_LAYERS = (0, 5)  # one local (window 1024), one global layer


def log(msg: str) -> None:
    print(msg, flush=True)


def sync_now() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def time_ms(fn, args_list, warmup: int = 2) -> tuple[float, float]:
    """(ms, wall_ms) per call of ``fn(*args)`` over ``args_list``, from CUDA
    events around the whole run, after a warm-up.

    ``wall_ms``: the host issues the calls as it goes, so the card may wait
    for it between calls. ``ms``: the stream is first held by a spin kernel
    long enough for the host to enqueue every call, so the calls run back
    to back and the events see device time only (none of the timed calls
    synchronises inside, which would drain the hold).
    """
    for args in args_list[:warmup]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for args in args_list:
        fn(*args)
    end.record()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / len(args_list)
    torch.cuda._sleep(int((2 * host_s + 1e-3) * 2e9))  # cycles at <= 2 GHz
    start.record()
    for args in args_list:
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(args_list), wall


def bound(bytes_moved: float, flops: float, peak: float = FP32_FLOPS
          ) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def tf32_matmuls():
    """fp32 matmuls in TF32 inside (the port keeps them in fp32)."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def jitter(x, g):
    """``x`` moved by uniform noise in [-0.5, 0.5): rows in the same range
    but off the integer grid, so neither TF32 nor bf16 holds them exactly."""
    return torch.rand(x.shape, generator=g, device=x.device).sub_(0.5).add_(x)


def real_check(name, kernel_ratio, tf32_ratio):
    """Raise unless the kernel's real-valued error is within the fp32 bound
    and the TF32 control's is not (else the check could not see TF32)."""
    if not kernel_ratio <= 1.0:
        raise AssertionError(f"{name}: real-valued error {kernel_ratio} x the "
                             f"fp32 bound")
    if not tf32_ratio > 1.0:
        raise AssertionError(f"{name}: the plain version in TF32 stays within "
                             f"the fp32 bound ({tf32_ratio} x), so the check "
                             f"cannot tell TF32 from fp32")
    return kernel_ratio, tf32_ratio


def bitwise(kernel_out, plain_out, what):
    """Max |distance| difference of a kernel's (dists, ids) against its
    plain version's; raises unless the two are bitwise equal."""
    (da, ia), (db, ib) = kernel_out, plain_out
    fin = torch.isfinite(db)
    err = float((da[fin] - db[fin]).abs().max()) if fin.any() else 0.0
    if not (torch.equal(da, db) and torch.equal(ia, ib)):
        raise AssertionError(f"{what}: kernel differs from its plain version "
                             f"(max |d| {err})")
    return err


def chunked_plain(rt, points, leaves, q, qleaves, k):
    """The l2topk plain version over a whole shard, in point chunks folded
    by (distance, shard row): (dists (Q,k), shard rows (Q,k), -1 where none).
    Equals one pass, whose (P, Q) matrix would not fit."""
    best_d = torch.full((q.shape[0], k), torch.inf, device=q.device)
    best_r = torch.full((q.shape[0], k), -1, dtype=torch.int32, device=q.device)
    for s in range(0, points.shape[0], CHUNK_POINTS):
        e = s + CHUNK_POINTS
        d, r = rt.l2_topk_ref(points[s:e], leaves[s:e], q, qleaves, k)
        best_d, best_r = rt.fold_topk(best_d, best_r, d, torch.where(r >= 0, r + s, -1))
    return best_d, best_r


def make_corpus(rt, n: int, seed: int, dev, mixture):
    """(n, DIM) quantized SIFT-like rows on ``dev``, made in chunks of
    ``CHUNK_ROWS`` (chunk c from seed ``seed * 1009 + c``) on host threads;
    numpy's generators release the interpreter lock while they fill."""
    out = torch.empty((n, DIM), dtype=torch.float32, device=dev)
    starts = list(range(0, n, CHUNK_ROWS))

    def chunk(c):
        m = min(CHUNK_ROWS, n - starts[c])
        return rt.synth.sample_descriptors(m, DIM, mixture=mixture,
                                           seed=seed * 1009 + c)[0]

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        for c, x in enumerate(pool.map(chunk, range(len(starts)))):
            out[starts[c]:starts[c] + x.shape[0]] = torch.from_numpy(x).to(dev)
    return out


def run_main_path(rt, args, dev, sizes):
    """Drive build_tree -> build_index -> batch_search; return what the
    checks and the kernel phase need."""
    mix = rt.synth.make_mixture(256, DIM, seed=args.seed)
    t0 = sync_now()
    corpus = make_corpus(rt, sizes["index_rows"], args.seed, dev, mix)
    # copy-detection queries: indexed descriptors under a small distortion
    # (each coordinate moved by -4..4, kept in [0, 255]: still integers)
    g = torch.Generator().manual_seed(args.seed + 1)
    src = torch.randint(0, sizes["index_rows"], (sizes["n_queries"],), generator=g)
    noise = torch.randint(-4, 5, (sizes["n_queries"], DIM), generator=g)
    queries = (corpus[src.to(dev)] + noise.to(dev)).clamp(0, 255).contiguous()
    log(f"data: {sizes['index_rows']} index rows, {sizes['n_queries']} queries "
        f"in {sync_now() - t0:.3f} s (host generation)")

    t0 = sync_now()
    tree = rt.build_tree(corpus[: sizes["sample_rows"]], sizes["fanouts"],
                         generator=torch.Generator().manual_seed(args.seed),
                         device=dev)
    t_tree = sync_now() - t0
    t0 = sync_now()
    index = rt.build_index(corpus, tree, wire_dtype=torch.bfloat16, device=dev)
    t_index = sync_now() - t0
    del corpus  # the index holds every row (bf16 is exact on integers)
    torch.cuda.empty_cache()
    log(f"build_tree {t_tree:.3f} s, build_index {t_index:.3f} s: "
        f"{index.rows} rows, n_valid {int(index.n_valid[0])}, "
        f"overflow {int(index.overflow)}")
    if int(index.overflow) != 0:
        raise AssertionError("index routing overflow")

    results, times = {}, {}
    k1_before = rt.l2_topk.launches
    for name, impl, probes in (("pallas", "pallas", 1), ("fused", "fused", 1),
                               ("fused_p2", "fused", 2)):
        t0 = sync_now()
        res = rt.batch_search(index, tree, queries, sizes["k"], probes=probes,
                              q_cap=sizes["q_cap"], block_rows=sizes["block_rows"],
                              impl=impl, device=dev)
        times[name] = sync_now() - t0
        results[name] = res
        if name == "pallas":
            k1_wave_launches = rt.l2_topk.launches - k1_before
        log(f"batch_search {name}: {times[name]:.3f} s, pairs "
            f"{float(res.pairs):.0f}, q_cap_overflow {int(res.q_cap_overflow)}")
    return dict(index=index, tree=tree, queries=queries, results=results,
                times=dict(times, build_tree=t_tree, build_index=t_index),
                k1_wave_launches=k1_wave_launches)


def check_main_path(rt, run, sizes, seed):
    index, tree, queries, res = run["index"], run["tree"], run["queries"], run["results"]
    for name, r in res.items():
        if int(r.q_cap_overflow) != 0:
            raise AssertionError(f"{name}: q_cap overflow")
        if r.ids.shape != (sizes["n_queries"], sizes["k"]):
            raise AssertionError(f"{name}: shape {tuple(r.ids.shape)}")
        if not torch.isfinite(r.dists[:, 0]).all():
            raise AssertionError(f"{name}: a query found no neighbour")
    a, b = res["pallas"], res["fused"]
    if not (torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
            and torch.equal(a.pairs, b.pairs)):
        raise AssertionError("l2topk and fusedscan search paths differ")
    n_waves = index.rows // sizes["block_rows"]
    if run["k1_wave_launches"] != n_waves:
        raise AssertionError(f"l2topk launched {run['k1_wave_launches']} "
                             f"times for {n_waves} waves")

    g = torch.Generator().manual_seed(seed)
    pick = torch.randperm(sizes["n_queries"], generator=g)[:N_CHECK].to(queries.device)
    q = queries[pick]
    qleaf = rt.tree_assign(tree, q).long()
    exact = in_leaf_top1(index, q, qleaf, a.ids[pick, 0])

    # recall@1 against the exact nearest neighbour over the whole corpus
    nv = int(index.n_valid[0])
    qn = (q * q).sum(1)
    best_d = torch.full((N_CHECK,), float("inf"), device=q.device)
    best_row = torch.zeros((N_CHECK,), dtype=torch.int64, device=q.device)
    for s in range(0, nv, 2**22):
        v = index.vecs[s:min(nv, s + 2**22)]
        d2 = qn[:, None] - 2.0 * (q @ v.T) + (v * v).sum(1)[None, :]
        dmin, arg = d2.min(1)
        better = dmin < best_d  # earlier chunks keep ties: the lowest row
        best_d = torch.where(better, dmin, best_d)
        best_row = torch.where(better, arg + s, best_row)
    run["nn"] = (pick, best_d, best_row, qleaf)
    recall = {name: float((r.dists[pick, 0] == best_d).float().mean())
              for name, r in res.items()}
    log(f"in-leaf top-1 exact {exact}/{N_CHECK}; recall@1 vs exact full-corpus "
        f"NN: probes=1 {recall['pallas']}, probes=2 {recall['fused_p2']}")
    return recall


def in_leaf_top1(index, q, qleaf, top1):
    """Raise unless each query's top-1 id equals a brute-force scan of its
    leaf (first minimum = lowest shard row); returns the count."""
    offs = index.offsets[0].long()
    exact = 0
    for j in range(q.shape[0]):
        lo, hi = int(offs[qleaf[j]]), int(offs[qleaf[j] + 1])
        d2 = ((index.vecs[lo:hi] - q[j]) ** 2).sum(1)
        best = lo + int(torch.argmin(d2))
        exact += int(index.ids[best]) == int(top1[j])
    if exact != q.shape[0]:
        raise AssertionError(f"in-leaf top-1 exact for {exact}/{q.shape[0]}")
    return exact


def run_codes_path(rt, run, sizes):
    """Train and encode PQ codes on the main path's index, then search
    its queries three ways through the scan_codes layout and rerank."""
    index, tree, queries = run["index"], run["tree"], run["queries"]
    n = queries.shape[0]
    t0 = sync_now()
    live = index.vecs[index.ids >= 0]  # the live rows, as enable_codes trains
    pq = rt.ProductQuantizer.train(live, **PQ)
    t_train = sync_now() - t0
    del live
    torch.cuda.empty_cache()
    t0 = sync_now()
    codes = pq.encode(index.vecs)  # every index row, padding included
    t_encode = sync_now() - t0
    t0 = sync_now()
    reader = rt.IndexRowReader(index)
    t_reader = sync_now() - t0
    log(f"codes: train {t_train:.3f} s ({pq.meta}), encode {t_encode:.3f} s "
        f"({index.rows} rows x {pq.m} B), row reader {t_reader:.3f} s")
    out, times = {}, dict(train=t_train, encode=t_encode, reader=t_reader)
    k4_before = rt.adc_topk.launches
    for name, impl, probes in (("pallas", "pallas", 1), ("fused", "fused", 1),
                               ("fused_p2", "fused", 2)):
        t0 = sync_now()
        lookup = rt.build_lookup(tree, queries, probes=probes)
        plan = rt.make_plan(
            rows=index.rows, n_leaves=index.n_leaves, n_queries=n, n_shards=1,
            k=sizes["k"], probes=probes, layout="scan_codes", impl=impl,
            q_cap=sizes["q_cap"], block_rows=sizes["block_rows"],
            code_m=pq.m, code_bits=pq.bits)
        cand = rt.search_with_lookup(index, lookup, plan, n_queries=n,
                                     codes=codes, codebooks=pq.codebooks)
        t_search = sync_now() - t0
        if name == "pallas":
            run["k4_wave_launches"] = rt.adc_topk.launches - k4_before
        t0 = sync_now()
        ids, dists = rt.rerank_exact(reader, queries, cand.ids, sizes["k"])
        t_rerank = sync_now() - t0
        times[name], times[name + "_rerank"] = t_search, t_rerank
        out[name] = dict(cand=cand, ids=ids, dists=dists, plan=plan)
        log(f"codes search {name}: {t_search:.3f} s (rerank {plan.rerank}), "
            f"rerank_exact {t_rerank:.3f} s, pairs {float(cand.pairs):.0f}, "
            f"q_cap_overflow {int(cand.q_cap_overflow)}")
    run["codes"] = dict(pq=pq, codes=codes, reader=reader, results=out,
                        times=times)


def check_codes_path(rt, run, sizes):
    """Overflows, wave sweep == fused scan, exact reranked distances,
    launch counts; recall@1 and agreement with the dense search."""
    index, queries, c = run["index"], run["queries"], run["codes"]
    res, k = c["results"], sizes["k"]
    for name, r in res.items():
        cand = r["cand"]
        if int(cand.q_cap_overflow) != 0:
            raise AssertionError(f"codes {name}: q_cap overflow")
        if cand.ids.shape != (sizes["n_queries"], r["plan"].rerank):
            raise AssertionError(f"codes {name}: shape {tuple(cand.ids.shape)}")
        if r["ids"].shape != (sizes["n_queries"], k):
            raise AssertionError(f"codes {name}: reranked {tuple(r['ids'].shape)}")
        if not torch.isfinite(r["dists"][:, 0]).all():
            raise AssertionError(f"codes {name}: a query found no neighbour")
        # exact distances of the reranked ids, in float64 (the data are
        # integers, so every fp32 sum below 2^24 is exact): bit for bit
        for s in range(0, r["ids"].shape[0], 4096):
            ids, d = r["ids"][s:s + 4096], r["dists"][s:s + 4096]
            ok = ids >= 0
            rows = c["reader"](ids[ok])
            q = queries[s:s + 4096][:, None, :].expand(-1, k, -1)[ok]
            d64 = ((rows.double() - q.double()) ** 2).sum(-1)
            if not (torch.equal(d64.float(), d[ok]) and bool((d64 < 2**24).all())
                    and bool(torch.isinf(d[~ok]).all())):
                raise AssertionError(f"codes {name}: reranked distances are "
                                     f"not the exact distances of their ids")
    a, b = res["pallas"]["cand"], res["fused"]["cand"]
    if not (torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
            and torch.equal(a.pairs, b.pairs)):
        raise AssertionError("adcscan and fusedadc search paths differ")
    n_waves = index.rows // sizes["block_rows"]
    if run["k4_wave_launches"] != n_waves:
        raise AssertionError(f"adcscan launched {run['k4_wave_launches']} "
                             f"times for {n_waves} waves")
    log(f"codes checks: q_cap_overflow 0 on all three searches; adcscan and "
        f"fusedadc paths bit-identical (ids, ADC distances, pairs); reranked "
        f"distances equal the exact distances of their ids for "
        f"{len(res)} x {sizes['n_queries']} queries; adcscan launched "
        f"{run['k4_wave_launches']} times for {n_waves} waves")
    pick, best_d = run["nn"][:2]
    recall = {name: float((r["dists"][pick, 0] == best_d).float().mean())
              for name, r in res.items()}
    dense = run["results"]["pallas"].ids[:, 0]
    same = float((res["pallas"]["ids"][:, 0] == dense).float().mean())
    log(f"codes recall@1 vs exact full-corpus NN ({N_CHECK} queries): "
        f"probes=1 {recall['pallas']} (dense {run['recall']['pallas']}), "
        f"probes=2 {recall['fused_p2']} (dense {run['recall']['fused_p2']}); "
        f"reranked top-1 equal to the dense point-major top-1: {same}")
    adc_miss_witness(run, res["pallas"]["cand"])
    return recall, same


def adc_miss_witness(run, cand):
    """Where the exact nearest neighbour of each sampled query went in the
    probes = 1 ADC scan: among the rerank candidates, in the query's leaf
    but outside them, or in another leaf (which the dense path misses too).
    For the in-leaf misses, a plain numpy ADC over the leaf (``pq.lut``'s
    difference form, independent of the kernels and of the device LUT)
    gives the neighbour's rank; the scan is at fault, and the run fails,
    if that ADC distance lies below the scan's last candidate's by more
    than 1e-3 of it (the device builds its LUT by the norm expansion,
    whose fp32 rounding moves a sum of 8 entries by far less)."""
    index, queries, c = run["index"], run["queries"], run["codes"]
    pick, best_d, best_row, qleaf = run["nn"]
    pq, codes = c["pq"], c["codes"]
    nn_id = index.ids[best_row]
    ids = cand.ids[pick]
    in_cand = (ids == nn_id[:, None]).any(1)
    same_leaf = index.leaves[best_row].long() == qleaf
    offs = index.offsets[0].long()
    ranks, sizes = [], []
    for j in torch.nonzero(~in_cand & same_leaf)[:, 0].tolist():
        lo, hi = int(offs[qleaf[j]]), int(offs[qleaf[j] + 1])
        lut = pq.lut(queries[pick[j]][None].cpu().numpy())[0]  # (m, C)
        cd = codes[lo:hi].cpu().numpy().astype(np.int64)
        adc = lut[np.arange(pq.m)[None, :], cd].sum(1, dtype=np.float32)
        me = int(best_row[j]) - lo
        rank = int((adc < adc[me]).sum() + (adc[:me] == adc[me]).sum())
        last = float(cand.dists[pick[j], -1])
        if adc[me] < last * (1 - 1e-3):
            raise AssertionError(
                f"adc witness: query {int(pick[j])}'s nearest neighbour has "
                f"numpy ADC {adc[me]} (rank {rank} of {hi - lo} in its leaf) "
                f"below the scan's last candidate's {last}")
        ranks.append(rank)
        sizes.append(hi - lo)
    n_in, n_leaf = int(in_cand.sum()), len(ranks)
    log(f"adc witness ({N_CHECK} queries, probes=1, rerank "
        f"{cand.ids.shape[1]}): exact NN id among the ADC candidates "
        f"{n_in}/{N_CHECK} ({n_in / N_CHECK}); in the query's leaf but outside "
        f"them {n_leaf}; in another leaf {N_CHECK - n_in - n_leaf}; numpy ADC "
        f"rank of the in-leaf misses (sorted) {sorted(ranks)}, their leaf sizes "
        f"{[sizes[i] for i in np.argsort(ranks, kind='stable')]}")
    run["adc_witness"] = dict(in_candidates=n_in, in_leaf_missed=n_leaf,
                              other_leaf=N_CHECK - n_in - n_leaf,
                              in_leaf_miss_ranks=sorted(ranks))


def kernel_checks(rt, run, sizes, seed):
    """Each kernel against its plain version at the main path's shapes."""
    index, tree, queries = run["index"], run["tree"], run["queries"]
    dev, k, B = index.vecs.device, sizes["k"], sizes["block_rows"]
    g = torch.Generator(device=dev).manual_seed(seed + 2)  # real-valued noise
    out = []

    def record(name, src, replaces, launches, max_err, real, kern, plain, bnd,
               lib, **extra):
        """``real``: the (kernel, TF32 plain) real-valued error over the
        fp32 bound, or None for the ADC kernels, which add without
        products and are held bit for bit on real-valued LUTs instead."""
        real = real or (None, None)
        out.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                        launches=launches, max_abs_err=max_err, ms=kern[0],
                        plain_ms=plain[0], bound_ms=bnd[0], bound_by=bnd[1],
                        library_ms=lib and lib[0], wall_ms=kern[1],
                        fp32_bound_ratio=real[0], tf32_bound_ratio=real[1],
                        **extra))
        log(f"{name}: {kern[0]} ms back to back, {kern[1]} ms wall per call; "
            f"plain {plain[0]} ms, {plain[1]} ms wall; library "
            f"{lib and lib[0]} ms, {lib and lib[1]} ms wall; bound {bnd[0]} ms "
            f"by {bnd[1]}; main-path launches {launches}; max_abs_err {max_err}; "
            f"real-valued error {real[0]} x the fp32 bound (TF32 plain "
            f"{real[1]} x){'; ' + json.dumps(extra) if extra else ''}")

    lk = rt.build_lookup(tree, queries, probes=1)  # sorted by leaf
    waves, k3_waves = dense_waves(run, sizes, lk)
    times = dense_kernel_times(rt, run, sizes, waves, k3_waves)

    # --- K1 l2topk: real waves of the main path with their query slabs ---
    d = index.vecs.shape[1]
    pairs = sum(times["k1_pairs"])
    # what the waves' pairs need: the points of the leaves some slab row
    # holds and the slab rows whose leaf some point holds
    need = sum(int(torch.isin(w[1], w[3]).sum()) for w in waves)
    matched = sum(int(torch.isin(w[3], w[1]).sum()) for w in waves)
    err = max(bitwise(rt.l2_topk(*w, k=k), rt.l2_topk_ref(*w, k), "l2topk")
              for w in waves)
    ratios = []
    for p, plf, q, qlf in waves[:N_REAL_WAVES]:
        p, q = jitter(p, g), jitter(q, g)
        exact, _, tol = rt.topk_f64(p, plf, q, qlf, k)
        runs = [rt.l2_topk(p, plf, q, qlf, k=k)]
        with tf32_matmuls():
            runs.append(rt.l2_topk_ref(p, plf, q, qlf, k))
        ratios.append([rt.topk_error_ratio(*r, p, q, exact, tol) for r in runs])
    real = real_check("l2topk", max(r[0] for r in ratios), max(r[1] for r in ratios))
    kern = times["k1_wave"]
    plain = time_ms(lambda *w: rt.l2_topk_ref(*w, k), waves)

    def lib_topk(p, plf, q, qlf):
        d2 = torch.where(qlf[:, None] == plf[None, :],
                         torch.addmm((p * p).sum(1)[None, :], q, p.T, alpha=-2.0),
                         torch.inf)
        return torch.topk(d2, k, dim=1, largest=False)

    lib = time_ms(lib_topk, waves)
    nw, qc = len(waves), sizes["q_cap"]
    # bytes a pair needs (points and lookup rows of shared leaves, both
    # leaf arrays, the (Q, k) output) and the same-leaf fp32 operations
    byt = (need + matched) * d * 4 + nw * ((B + qc) * 4 + qc * k * 8)
    bnd = bound(byt / nw, (pairs + need) * 2 * d / nw)
    # the earlier yardstick, kept beside it: every input of the wave read once
    whole = bound(B * d * 4 + B * 4 + qc * (d * 4 + 4) + qc * k * 8,
                  (pairs * 2 * d + nw * B * 2 * d) / nw)
    record("l2topk", "src/repro_torch/csrc/l2topk.cu",
           "src/repro/kernels/l2topk/kernel.py:105", run["launches"]["l2topk"],
           err, real, kern, plain, bnd, lib, bound_ms_whole_wave=whole[0],
           floor_ms=times["k1_floor"][0], pairs_per_wave=pairs / nw,
           points_needed_per_wave=need / nw, rows_matched_per_wave=matched / nw,
           busiest_wave_ms=times["k1_busiest"][0],
           busiest_wave_pairs=times["k1_busiest_pairs"],
           clusters=rt.l2topk_ops.resident_clusters(), **run["sweep_trace"])

    # --- K2 fusedscan: the main path's call, the whole shard against the
    # padded probes=1 lookup. Each output row depends on its own lookup row
    # only, so the plain version (which forms a (P, rows) matrix) is run on
    # sampled lookup rows, over the whole shard in point chunks ---
    flk, full = fused_inputs(rt, run, sizes, lk)
    kd, ki = rt.fused_topk(*full, k=k)
    pick = sample_rows(flk, sizes["n_sample"], seed + 3)
    sq, sl = flk.vecs[pick], flk.leaves[pick]

    def plain_sample(q, qlf):
        return rt.map_ids(*chunked_plain(rt, index.vecs, index.leaves, q, qlf, k),
                          index.ids)

    want = plain_sample(sq, sl)
    if not torch.isfinite(want[0][:, 0]).all():
        raise AssertionError("fusedscan: a sampled lookup row has no same-leaf point")
    err = bitwise((kd[pick], ki[pick]), want, "fusedscan")
    kern = fused_time(rt, full, k)
    plain = time_ms(plain_sample, [(sq, sl)], warmup=1)
    need, pairs, Q = fused_need(index, flk)
    bnd = fused_bound(need, pairs, Q, d, k)
    groups = group_structure(index, flk)
    log(f"fusedscan group structure: {json.dumps(groups)}")
    del kd, ki, want
    # real-valued: the same call on rows off the integer grid, shard rows
    # as ids so that the result names rows
    noisy, nq = jitter(index.vecs, g), jitter(flk.vecs, g)
    rows_as_ids = torch.arange(index.rows, dtype=torch.int32, device=dev)
    nd, nr = rt.fused_topk(noisy, index.leaves, rows_as_ids, nq, flk.leaves, k=k)
    sq = nq[pick]
    exact, _, tol = rt.topk_f64(noisy, index.leaves, sq, sl, k,
                                chunk_rows=CHUNK_POINTS)
    with tf32_matmuls():
        ctrl = chunked_plain(rt, noisy, index.leaves, sq, sl, k)
    real = real_check(
        "fusedscan",
        rt.topk_error_ratio(nd[pick], nr[pick], noisy, sq, exact, tol),
        rt.topk_error_ratio(*ctrl, noisy, sq, exact, tol))
    del noisy, nq, nd, nr, rows_as_ids
    torch.cuda.empty_cache()
    # no single PyTorch call fits: the (P, Q) distance matrix is 4 TB
    record("fusedscan", "src/repro_torch/csrc/fusedscan.cu",
           "src/repro/kernels/fusedscan/kernel.py:206", run["launches"]["fusedscan"],
           err, real, kern, plain, bnd, None, rows=Q, plain_rows=pick.numel(),
           points_needed=need, pairs=pairs, **groups, **run["fused_trace"])

    # --- K3 l2nn: tree level 0 against the build_tree sample's shape ---
    n = sizes["sample_rows"]
    x = index.vecs[:n]
    c = tree.levels[0]
    err = bitwise(rt.l2_nearest(x, c)[::-1], rt.l2_nearest_ref(x, c)[::-1], "l2nn")
    xr, cr = jitter(x, g), jitter(c, g)
    kr = rt.nearest_error_ratio(*rt.l2_nearest(xr, cr), xr, cr)
    with tf32_matmuls():
        cr_ratio = rt.nearest_error_ratio(*rt.l2_nearest_ref(xr, cr), xr, cr)
    real = real_check("l2nn", kr, cr_ratio)
    del xr, cr
    kern = times["k3_level0"]
    plain = time_ms(lambda x, c: rt.l2_nearest_ref(x, c), [(x, c)] * 5)
    lib = time_ms(lambda x, c: torch.cdist(x, c).min(1), [(x, c)] * 5)
    C = c.shape[0]
    bnd = bound(n * d * 4 + C * d * 4 + n * 8, n * C * 2 * d + (n + C) * 2 * d)
    del x, c
    wave = l2nn_wave_shape(rt, k3_waves, times["k3_wave"])
    enc = encode_check(rt, run, g)
    record("l2nn", "src/repro_torch/csrc/l2nn.cu",
           "src/repro/kernels/l2nn/kernel.py:60", run["launches"]["l2nn"],
           err, real, kern, plain, bnd, lib,
           codes_path_launches=run["codes_launches"]["l2nn"], **wave, **enc)
    adc_checks(rt, run, sizes, seed, record)
    return out


def fused_inputs(rt, run, sizes, lk):
    """The main path's fused call: the probes = 1 lookup ``lk`` padded as
    the fused plan pads it, and K2's arguments (the whole shard against
    it). Returns (padded lookup, arguments)."""
    index, n = run["index"], run["queries"].shape[0]
    fplan = rt.make_plan(rows=index.rows, n_leaves=index.n_leaves, n_queries=n,
                         n_shards=1, k=sizes["k"], probes=1, impl="fused",
                         block_rows=sizes["block_rows"], q_cap=sizes["q_cap"])
    flk = rt.pad_lookup(lk, rt.lookup_q_total(fplan, n))
    return flk, (index.vecs, index.leaves, index.ids, flk.vecs, flk.leaves)


def sample_rows(flk, n, seed):
    """``n`` lookup rows of ``flk`` that are not padding, ascending, drawn
    from ``seed``."""
    real_rows = torch.nonzero(flk.leaves >= 0)[:, 0]
    g = torch.Generator().manual_seed(seed)
    pick = torch.randperm(real_rows.numel(), generator=g)[:n]
    return real_rows[pick.to(real_rows.device)].sort().values


def fused_time(rt, full, k):
    """K2's (device ms, wall ms) a call on the main path's call."""
    return time_ms(lambda *a: rt.fused_topk(*a, k=k), [full] * 5, warmup=1)


def fused_need(index, flk):
    """(points whose leaf some lookup row holds, same-leaf pairs, lookup
    rows) of a whole-shard dense call."""
    nl = index.n_leaves
    pl = index.leaves[(index.leaves >= 0) & (index.leaves < nl)].long()
    hp = torch.bincount(pl, minlength=nl)
    hq = torch.bincount(flk.leaves[flk.leaves >= 0].long(), minlength=nl)
    return int(hp[hq > 0].sum()), int((hp * hq).sum()), flk.vecs.shape[0]


def fused_bound(need, pairs, Q, d, k):
    """Each needed row (and its leaf and id), each lookup row and the
    (Q, k) output once; the same-leaf pairs' fp32 operations."""
    return bound(need * (d * 4 + 8) + Q * (d * 4 + 4) + Q * k * 8,
                 pairs * 2 * d + need * 2 * d)


def group_structure(index, flk):
    """K2's work at this call (csrc/fusedscan.cu): the lookup's leaf groups
    (maximal runs of consecutive rows with one leaf that the shard holds),
    cut into group tiles of at most F_G rows; each tile reads its leaf's
    run once and evaluates its rows against it. Runs over F_LONG rows go
    to the cluster kernel."""
    nl = index.n_leaves
    pl = index.leaves[(index.leaves >= 0) & (index.leaves < nl)].long()
    hp = torch.bincount(pl, minlength=nl).cpu().numpy()
    ql = flk.leaves.cpu().numpy()
    starts = np.flatnonzero(np.r_[True, ql[1:] != ql[:-1]])
    size = np.diff(np.r_[starts, ql.size])
    leaf = ql[starts]
    run = np.where((leaf >= 0) & (leaf < nl), hp[np.clip(leaf, 0, nl - 1)], 0)
    real = run > 0
    size, leaf, run = size[real], leaf[real], run[real]
    tiles = -(-size // F_G)
    reads = tiles * run
    long_ = run > F_LONG
    return dict(groups=int(size.size), distinct_leaves=int(np.unique(leaf).size),
                group_tiles=int(tiles.sum()), largest_group=int(size.max()),
                longest_run=int(run.max()),
                pairs_evaluated=int((size * run).sum()),
                rows_read=int(reads.sum()), long_tiles=int(tiles[long_].sum()),
                long_rows_read=int(reads[long_].sum()),
                long_pairs=int((size * run)[long_].sum()))


def dense_waves(run, sizes, lk):
    """The main path's waves that K1 and K3 are held and timed on: the
    ``k1_waves`` consecutive mid-shard waves of ``block_rows`` index rows.
    Returns (K1's: each wave's points and leaves with the ``q_cap``-row
    slab of the leaf-sorted lookup ``lk`` that starts at the wave's first
    leaf, as the dense sweep gives them; K3's: each wave's rows against
    the level-0 centroids, as build_index's tree assignment gives them)."""
    index, B, q_cap = run["index"], sizes["block_rows"], sizes["q_cap"]
    c = run["tree"].levels[0]
    mid = int(index.n_valid[0]) // 2 // B * B
    k1, k3 = [], []
    for i in range(sizes["k1_waves"]):
        s = mid + i * B
        plf = index.leaves[s:s + B]
        start = int(lk.offsets[int(plf[0])].clamp(0, lk.n_queries - q_cap))
        sl = slice(start, start + q_cap)
        k1.append((index.vecs[s:s + B], plf, lk.vecs[sl].contiguous(),
                   lk.leaves[sl].contiguous()))
        k3.append((index.vecs[s:s + B], c))
    return k1, k3


def dense_kernel_times(rt, run, sizes, k1_waves, k3_waves):
    """K1's and K3's (device ms, wall ms) a call at the main path's shapes
    (``time_ms``): K1 over the real waves, over the same waves with every
    lookup leaf moved past the index's leaves (its floor: launch, leaf
    test, empty lists) and alone on the wave with the most pairs, whose
    busiest lookup row sets its time; K3 over the build's waves and at
    tree level 0 (the build_tree sample's rows against 256 centroids)."""
    k, nl = sizes["k"], run["index"].n_leaves
    pairs = [int(rt.count_pairs(w[1], w[3])) for w in k1_waves]
    top = max(range(len(pairs)), key=pairs.__getitem__)
    past = [(p, plf, q, torch.where(qlf >= 0, qlf + nl, qlf))
            for p, plf, q, qlf in k1_waves]

    def k1(*w):
        return rt.l2_topk(*w, k=k)

    level0 = (run["index"].vecs[:sizes["sample_rows"]], run["tree"].levels[0])
    return dict(k1_wave=time_ms(k1, k1_waves), k1_floor=time_ms(k1, past),
                k1_busiest=time_ms(k1, [k1_waves[top]] * 20),
                k1_pairs=pairs, k1_busiest_pairs=pairs[top],
                k3_wave=time_ms(rt.l2_nearest, k3_waves),
                k3_level0=time_ms(rt.l2_nearest, [level0] * 10))


def l2nn_wave_shape(rt, waves, kern):
    """K3 at the shape most of its main-path launches have: build_index's
    tree assignment calls it once a wave of ``block_rows`` rows against
    the 256 level-0 centroids. The distinct mid-corpus ``waves``, each held
    against the plain version (bit for bit: integer data); the kernel's
    times ``kern`` beside the plain version's, the library's and the
    bound of one wave. Returns the numbers for the kernels line."""
    err = max(bitwise(rt.l2_nearest(x, c)[::-1], rt.l2_nearest_ref(x, c)[::-1],
                    "l2nn wave") for x, c in waves)
    plain = time_ms(lambda x, c: rt.l2_nearest_ref(x, c), waves)
    lib = time_ms(lambda x, c: torch.cdist(x, c).min(1), waves)
    B, (C, d) = waves[0][0].shape[0], waves[0][1].shape
    bnd = bound(B * d * 4 + C * d * 4 + B * 8, B * C * 2 * d + (B + C) * 2 * d)
    out = dict(wave_shape=[B, C, d], wave_ms=kern[0], wave_plain_ms=plain[0],
               wave_library_ms=lib[0], wave_bound_ms=bnd[0], wave_bound_by=bnd[1],
               wave_max_abs_err=err)
    log(f"l2nn at the build's wave shape: {json.dumps(out)}")
    return out


def encode_check(rt, run, g):
    """K3 at the shape the codes path gives it: per subspace, one mid-shard
    encode chunk (``pq.encode``'s own 2^21-row call, d = 16, 256 trained
    real-valued centroids) through the kernel and its plain version. The
    codes must equal those ``encode`` wrote; where kernel and plain version
    pick different centroids, the two must be a near-tie within the fp32
    bound (``fp32_bound.ties_within_bound``); the kernel's distances must
    hold the fp32 bound and the TF32 plain version's must not. Returns the
    numbers for the kernels line."""
    index, c = run["index"], run["codes"]
    pq, codes = c["pq"], c["codes"]
    n = rt.encode_chunk
    s = int(index.n_valid[0]) // 2 // n * n
    ratios, tf32, differ, kern, plain = [], [], 0, [], []
    for j in range(pq.m):
        x = index.vecs[s:s + n, j * pq.dsub:(j + 1) * pq.dsub].contiguous()
        cb = torch.as_tensor(pq.codebooks[j], device=x.device)
        ki, kd = rt.l2_nearest(x, cb)
        ri, _ = rt.l2_nearest_ref(x, cb)
        if not torch.equal(ki.to(torch.uint8), codes[s:s + n, j]):
            raise AssertionError(f"l2nn encode: subspace {j}'s codes differ "
                                 f"from the kernel's on the same rows")
        bad = torch.nonzero(ki != ri)[:, 0]
        differ += bad.numel()
        if bad.numel() and not bool(rt.ties_within_bound(
                x[bad], cb, ki[bad], ri[bad]).all()):
            raise AssertionError(f"l2nn encode: subspace {j}: a code differs "
                                 f"from the plain version's past a near-tie")
        for t in range(0, n, 2**19):  # bounded float64 temporaries
            sl = slice(t, t + 2**19)
            ratios.append(rt.nearest_error_ratio(ki[sl], kd[sl], x[sl], cb))
            with tf32_matmuls():
                tf32.append(rt.nearest_error_ratio(
                    *rt.l2_nearest_ref(x[sl], cb), x[sl], cb))
        kern.append(time_ms(lambda x, cb: rt.l2_nearest(x, cb), [(x, cb)] * 5)[0])
        plain.append(time_ms(lambda x, cb: rt.l2_nearest_ref(x, cb), [(x, cb)] * 3)[0])
    kr, tr = real_check("l2nn encode", max(ratios), max(tf32))
    out = dict(encode_shape=[n, pq.n_centers, pq.dsub], encode_rows_checked=n * pq.m,
               encode_codes_differing_near_ties=differ,
               encode_fp32_bound_ratio=kr, encode_tf32_bound_ratio=tr,
               encode_ms=sum(kern) / len(kern), encode_plain_ms=sum(plain) / len(plain))
    log(f"l2nn at the encode shape: {json.dumps(out)}")
    return out


def adc_checks(rt, run, sizes, seed, record):
    """K4 on 64 waves of the codes sweep and K5 on the codes path's own
    call, each against its plain version on the same real-valued LUTs."""
    index, c = run["index"], run["codes"]
    dev, B, qc = index.vecs.device, sizes["block_rows"], sizes["q_cap"]
    pq = c["pq"]
    r = c["results"]["pallas"]["plan"].rerank
    m, C = pq.m, pq.n_centers
    ci = codes_inputs(rt, run, sizes)
    flk, lut, live, waves, slabs = (ci[f] for f in ("flk", "lut", "live", "waves",
                                                    "slabs"))
    Q = flk.vecs.shape[0]

    # --- K4 adcscan: real waves of the codes sweep, called as the sweep
    # calls it (the wave's sorted leaves and ids, the whole LUT table, the
    # slab start on the device); the plain version and the yardstick get
    # the slab's rows and the masked leaves ---
    def k4(cd, plf, ids, start, qleaves=flk.leaves):
        return rt.adc_topk(cd, plf, lut, qleaves, k=r, point_ids=ids,
                           q_start=start, q_rows=qc)

    err = max(bitwise(k4(*w), rt.adc_topk_ref(*sw, r), "adcscan")
              for w, sw in zip(waves, slabs))
    # a wave with tombstones (every 5th id dead; they keep their leaf)
    cd, plf, ids, start = waves[0]
    dead = ids.clone()
    dead[::5] = -1
    err = max(err, bitwise(k4(cd, plf, dead, start),
                         rt.adc_topk_ref(cd, rt.live_leaves(plf, dead),
                                         *slabs[0][2:], r), "adcscan tombstones"))
    kern = k4_time(rt, ci, r)
    # the floor: the same waves with every lookup leaf past the index's
    # leaves, so that no block finds a run (launch, leaf test, empty lists)
    past = torch.where(flk.leaves >= 0, flk.leaves + index.n_leaves, flk.leaves)
    floor = time_ms(lambda *w: k4(*w, qleaves=past), waves)
    plain = time_ms(lambda *w: rt.adc_topk_ref(*w, r), slabs)
    offs = torch.arange(m, device=dev) * C

    def lib_adc(cd, plf, lt, qlf):
        d2 = lt.reshape(lt.shape[0], m * C)[:, (cd.long() + offs).view(-1)]
        d2 = torch.where(qlf[:, None] == plf[None, :],
                         d2.view(lt.shape[0], -1, m).sum(-1), torch.inf)
        return torch.topk(d2, r, dim=1, largest=False)

    lib = time_ms(lib_adc, slabs)
    bnd = k4_bound(ci, B, qc, m, C, r)
    nw = len(waves)
    record("adcscan", "src/repro_torch/csrc/adcscan.cu",
           "src/repro/kernels/adcscan/kernel.py:101", run["codes_launches"]["adcscan"],
           err, None, kern, plain, bnd, lib, luts_needed_per_wave=ci["need"] / nw,
           floor_ms=floor[0], tombstone_wave_checked=True)

    # --- K5 fusedadc: the codes path's call, the whole shard's codes
    # against the padded probes=1 lookup's LUTs; the plain version on
    # sampled lookup rows, over the shard in point chunks ---
    full = ci["full"]
    kd, ki = rt.fused_adc_topk(*full, k=r)
    pick = sample_rows(flk, sizes["n_sample"], seed + 4)
    sq, sl = lut[pick], flk.leaves[pick]

    def plain_sample(lt, qlf):
        return adc_plain_sample(rt, run, live, lt, qlf, r)

    want = plain_sample(sq, sl)
    if not torch.isfinite(want[0][:, 0]).all():
        raise AssertionError("fusedadc: a sampled lookup row has no same-leaf row")
    err = bitwise((kd[pick], ki[pick]), want, "fusedadc")
    kern = k5_time(rt, ci, r)
    plain = time_ms(plain_sample, [(sq, sl)], warmup=1)
    bnd, need = k5_bound(ci, index, m, C, r)
    runs = k5_runs(index, flk)
    log(f"fusedadc runs: {json.dumps(runs)}")
    # no single PyTorch call fits: the (P, Q) distance matrix is 4 TB
    record("fusedadc", "src/repro_torch/csrc/fusedadc.cu",
           "src/repro/kernels/fusedscan/kernel.py:223", run["codes_launches"]["fusedadc"],
           err, None, kern, plain, bnd, None, rows=Q, plain_rows=pick.numel(),
           **need, **runs, **run["fused_codes_trace"])


def codes_inputs(rt, run, sizes):
    """The codes path's kernel inputs at the main path's shapes: the padded
    probes = 1 lookup ``flk`` and its LUTs from the trained codebooks, the
    live-masked leaves, K5's arguments (``full``: the whole shard's codes
    against every LUT), and ``k1_waves`` mid-shard waves of the codes sweep
    as the sweep calls K4 (``waves``: the wave's codes, sorted leaves and
    ids, the slab start on the device) and as the plain version takes them
    (``slabs``: the slab's LUTs and the masked leaves), with the LUTs and
    same-leaf pairs the waves need."""
    index, tree, queries, c = run["index"], run["tree"], run["queries"], run["codes"]
    dev, B, qc = index.vecs.device, sizes["block_rows"], sizes["q_cap"]
    pq, codes = c["pq"], c["codes"]
    m, C, n = pq.m, pq.n_centers, queries.shape[0]
    lk = rt.build_lookup(tree, queries, probes=1)
    flk = rt.pad_lookup(lk, rt.lookup_q_total(c["results"]["fused"]["plan"], n))
    Q = flk.vecs.shape[0]
    lut = rt.build_adc_lut(flk.vecs, torch.as_tensor(pq.codebooks, device=dev),
                           q_total=Q, m=m, n_centers=C).view(Q, m, C)
    live = rt.live_leaves(index.leaves, index.ids)
    mid = int(index.n_valid[0]) // 2 // B * B
    waves, slabs, need, pairs = [], [], 0, 0
    for i in range(sizes["k1_waves"]):
        s = mid + i * B
        plf = live[s:s + B]
        start = int(flk.offsets[int(index.leaves[s])].clamp(0, Q - qc))
        qlf = flk.leaves[start:start + qc]
        waves.append((codes[s:s + B], index.leaves[s:s + B], index.ids[s:s + B],
                      torch.tensor([start], device=dev)))
        slabs.append((codes[s:s + B], plf, lut[start:start + qc], qlf))
        need += int(torch.isin(qlf, plf).sum())  # LUTs the wave needs
        pairs += int(rt.count_pairs(plf, qlf))
    return dict(flk=flk, lut=lut, live=live, waves=waves, slabs=slabs, need=need,
                pairs=pairs, full=(codes, index.leaves, index.ids, lut, flk.leaves),
                q_cap=qc)


def k4_time(rt, ci, r):
    """K4's (device ms, wall ms) a real wave of the codes sweep at rerank
    depth ``r``, called as the sweep calls it."""
    lut, qlf, qc = ci["lut"], ci["flk"].leaves, ci["q_cap"]
    return time_ms(lambda cd, plf, ids, start: rt.adc_topk(
        cd, plf, lut, qlf, k=r, point_ids=ids, q_start=start, q_rows=qc),
        ci["waves"])


def k4_bound(ci, B, qc, m, C, r):
    """A wave's codes, leaves and ids, the LUTs its slab rows need, the
    slab's leaves and the (q_cap, r) output; m adds a same-leaf pair."""
    nw = len(ci["waves"])
    byt = nw * (B * (m + 4) + qc * 4 + qc * r * 8) + ci["need"] * m * C * 4
    return bound(byt / nw, ci["pairs"] * m / nw)


def k5_time(rt, ci, r):
    """K5's (device ms, wall ms) on the codes path's fused call."""
    return time_ms(lambda *a: rt.fused_adc_topk(*a, k=r), [ci["full"]] * 5,
                   warmup=1)


def k5_bound(ci, index, m, C, r):
    """(bound, counts): the live rows whose leaf a lookup row holds (codes,
    leaf, id), the LUTs of the lookup rows whose leaf holds a live row,
    the lookup leaves and the (Q, r) output; m adds a same-leaf pair."""
    nl, live, flk = index.n_leaves, ci["live"], ci["flk"]
    Q = flk.vecs.shape[0]
    ok = (live >= 0) & (live < nl)
    hp = torch.bincount(live[ok].long(), minlength=nl)
    hq = torch.bincount(flk.leaves[flk.leaves >= 0].long(), minlength=nl)
    rows_needed, luts = int(hp[hq > 0].sum()), int(hq[hp > 0].sum())
    kpairs = int((hp * hq).sum())
    bnd = bound(rows_needed * (m + 8) + luts * m * C * 4 + Q * 4 + Q * r * 8,
                kpairs * m)
    return bnd, dict(rows_needed=rows_needed, luts_needed=luts, pairs=kpairs)


def k5_runs(index, flk):
    """K5's runs at this call (K4's kernel over the shard: one block of 8
    warps a lookup row, 32 rows a warp a step): the lookup rows whose leaf
    holds rows, their mean and longest run, and the longest run's steps
    a warp."""
    nl = index.n_leaves
    pl = index.leaves[(index.leaves >= 0) & (index.leaves < nl)].long()
    hp = torch.bincount(pl, minlength=nl)
    ql = flk.leaves[(flk.leaves >= 0) & (flk.leaves < nl)].long()
    run = hp[ql]
    run = run[run > 0]
    longest = int(run.max())
    return dict(lookup_rows_with_a_run=int(run.numel()),
                mean_run=float(run.float().mean()), longest_run=longest,
                longest_run_steps_per_warp=-(-longest // (8 * 32)))


def adc_plain_sample(rt, run, live, lt, qlf, r):
    """The fused ADC plain version for the LUT rows ``lt`` over the whole
    shard, in point chunks folded by (distance, shard row), ids mapped."""
    index, codes = run["index"], run["codes"]["codes"]
    dev = lt.device
    best_d = torch.full((lt.shape[0], r), torch.inf, device=dev)
    best_r = torch.full((lt.shape[0], r), -1, dtype=torch.int32, device=dev)
    for s in range(0, codes.shape[0], CHUNK_POINTS):
        e = s + CHUNK_POINTS
        d, rr = rt.adc_topk_ref(codes[s:e], live[s:e], lt, qlf, r)
        best_d, best_r = rt.fold_topk(best_d, best_r, d,
                                      torch.where(rr >= 0, rr + s, -1))
    return rt.map_ids(best_d, best_r, index.ids)


def p7_phase(rt, run, sizes, seed, kernels):
    """Every k the plan accepts, on the card (ROADMAP P7): ``batch_search``
    at k = P7_K and a codes search at rerank P7_RERANK, past the KCAP
    kernels' lists, so that every call goes to the wide kernels. Checks the
    sweep and the fused scan bit-identical, their launches, the k = 20
    results as a prefix, in-leaf top-1 exactness, and the wide kernels
    against their plain versions (real waves, sampled lookup rows of the
    fused calls); puts their times on the K1, K2, K4 and K5 rows."""
    index, tree, queries = run["index"], run["tree"], run["queries"]
    dev, B, qc, d = index.vecs.device, sizes["block_rows"], sizes["q_cap"], DIM
    rows = {row["name"]: row for row in kernels}
    n, k, n_waves = queries.shape[0], P7_K, index.rows // B

    # --- dense: batch_search at k = P7_K, both paths ---
    res, wall = {}, {}
    rt.reset_counts()
    for impl in ("pallas", "fused"):
        t0 = sync_now()
        res[impl] = rt.batch_search(index, tree, queries, k, q_cap=qc, block_rows=B,
                                    impl=impl, device=dev)
        wall[impl] = sync_now() - t0
    launches = rt.counts()
    a, b = res["pallas"], res["fused"]
    for name, r in res.items():
        if int(r.q_cap_overflow) != 0 or r.ids.shape != (n, k):
            raise AssertionError(f"p7 {name}: overflow {int(r.q_cap_overflow)}, "
                                 f"shape {tuple(r.ids.shape)}")
    if not (torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
            and torch.equal(a.pairs, b.pairs)):
        raise AssertionError(f"p7: the sweep and the fused scan differ at k = {k}")
    want = {"l2topk": n_waves, "l2topk.wide": n_waves, "fusedscan": 1,
            "fusedscan.wide": 1}
    if any(launches[key] != v for key, v in want.items()):
        raise AssertionError(f"p7: launches {json.dumps(launches)}, expected "
                             f"{json.dumps(want)}")
    k20 = run["results"]["pallas"]
    if not (torch.equal(a.ids[:, :sizes["k"]], k20.ids)
            and torch.equal(a.dists[:, :sizes["k"]], k20.dists)):
        raise AssertionError(f"p7: the k = {sizes['k']} results are not the first "
                             f"columns of the k = {k} results")
    pick, _, _, qleaf = run["nn"]
    exact = in_leaf_top1(index, queries[pick], qleaf, a.ids[pick, 0])

    # the wide kernels at the shapes the two paths gave them
    lk = rt.build_lookup(tree, queries, probes=1)
    waves, _ = dense_waves(run, sizes, lk)
    err = max(bitwise(rt.l2_topk(*w, k=k), rt.l2_topk_ref(*w, k), "l2topk wide")
              for w in waves)
    kern = time_ms(lambda *w: rt.l2_topk(*w, k=k), waves)
    plain = time_ms(lambda *w: rt.l2_topk_ref(*w, k), waves)
    need = sum(int(torch.isin(w[1], w[3]).sum()) for w in waves)
    matched = sum(int(torch.isin(w[3], w[1]).sum()) for w in waves)
    pairs = sum(int(rt.count_pairs(w[1], w[3])) for w in waves)
    nw = len(waves)
    bnd = bound(((need + matched) * d * 4 + nw * ((B + qc) * 4 + qc * k * 8)) / nw,
                (pairs + need) * 2 * d / nw)
    rows["l2topk"].update(wide_k=k, wide_ms=kern[0], wide_plain_ms=plain[0],
                          wide_bound_ms=bnd[0], wide_bound_by=bnd[1],
                          wide_launches=launches["l2topk.wide"],
                          wide_max_abs_err=err, wide_search_wall_s=wall["pallas"])
    flk, full = fused_inputs(rt, run, sizes, lk)
    kd, ki = rt.fused_topk(*full, k=k)
    fpick = sample_rows(flk, sizes["n_sample"], seed + 5)
    sq, sl = flk.vecs[fpick], flk.leaves[fpick]

    def plain_sample(q, qlf):
        return rt.map_ids(*chunked_plain(rt, index.vecs, index.leaves, q, qlf, k),
                          index.ids)

    err = bitwise((kd[fpick], ki[fpick]), plain_sample(sq, sl), "fusedscan wide")
    del kd, ki
    kern = fused_time(rt, full, k)
    plain = time_ms(plain_sample, [(sq, sl)], warmup=1)
    need, pairs, Q = fused_need(index, flk)
    bnd = fused_bound(need, pairs, Q, d, k)
    rows["fusedscan"].update(wide_k=k, wide_ms=kern[0], wide_plain_ms=plain[0],
                             wide_plain_rows=fpick.numel(), wide_bound_ms=bnd[0],
                             wide_bound_by=bnd[1],
                             wide_launches=launches["fusedscan.wide"],
                             wide_max_abs_err=err, wide_search_wall_s=wall["fused"])
    log(f"p7 dense: batch_search k = {k} pallas {wall['pallas']} s, fused "
        f"{wall['fused']} s, bit-identical; the k = {sizes['k']} results their "
        f"prefix; in-leaf top-1 exact {exact}/{pick.numel()}; launches "
        f"{json.dumps(launches)}; l2topk wide {rows['l2topk']['wide_ms']} ms a wave, "
        f"fusedscan wide {kern[0]} ms")
    del res, a, b

    # --- codes: a search at rerank P7_RERANK, both paths ---
    c, r = run["codes"], P7_RERANK
    pq = c["pq"]
    cand, wall = {}, {}
    rt.reset_counts()
    for impl in ("pallas", "fused"):
        t0 = sync_now()
        lookup = rt.build_lookup(tree, queries, probes=1)
        plan = rt.make_plan(
            rows=index.rows, n_leaves=index.n_leaves, n_queries=n, n_shards=1,
            k=sizes["k"], probes=1, layout="scan_codes", impl=impl, q_cap=qc,
            block_rows=B, code_m=pq.m, code_bits=pq.bits, rerank=r)
        cand[impl] = rt.search_with_lookup(index, lookup, plan, n_queries=n,
                                           codes=c["codes"], codebooks=pq.codebooks)
        wall[impl] = sync_now() - t0
    launches = rt.counts()
    a, b = cand["pallas"], cand["fused"]
    if int(a.q_cap_overflow) != 0 or a.ids.shape != (n, r):
        raise AssertionError(f"p7 codes: overflow {int(a.q_cap_overflow)}, shape "
                             f"{tuple(a.ids.shape)}")
    if not (torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
            and torch.equal(a.pairs, b.pairs)):
        raise AssertionError(f"p7: adcscan and fusedadc paths differ at rerank {r}")
    want = {"adcscan": n_waves, "adcscan.wide": n_waves, "fusedadc": 1,
            "fusedadc.wide": 1}
    if any(launches[key] != v for key, v in want.items()):
        raise AssertionError(f"p7 codes: launches {json.dumps(launches)}, expected "
                             f"{json.dumps(want)}")
    c128 = c["results"]["pallas"]["cand"]
    w128 = c128.ids.shape[1]
    if not (torch.equal(a.ids[:, :w128], c128.ids)
            and torch.equal(a.dists[:, :w128], c128.dists)):
        raise AssertionError(f"p7 codes: the rerank {w128} candidates are not the "
                             f"first columns of the rerank {r} candidates")
    del cand, a, b
    ci = codes_inputs(rt, run, sizes)
    m, C = pq.m, pq.n_centers
    lut, qlf = ci["lut"], ci["flk"].leaves
    err = max(bitwise(rt.adc_topk(cd, plf, lut, qlf, k=r, point_ids=ids,
                                q_start=start, q_rows=qc),
                    rt.adc_topk_ref(*sw, r), "adcscan wide")
              for (cd, plf, ids, start), sw in zip(ci["waves"], ci["slabs"]))
    kern = k4_time(rt, ci, r)
    plain = time_ms(lambda *w: rt.adc_topk_ref(*w, r), ci["slabs"])
    bnd = k4_bound(ci, B, qc, m, C, r)
    rows["adcscan"].update(wide_k=r, wide_ms=kern[0], wide_plain_ms=plain[0],
                           wide_bound_ms=bnd[0], wide_bound_by=bnd[1],
                           wide_launches=launches["adcscan.wide"],
                           wide_max_abs_err=err, wide_search_wall_s=wall["pallas"])
    kd, ki = rt.fused_adc_topk(*ci["full"], k=r)
    fpick = sample_rows(ci["flk"], sizes["n_sample"], seed + 6)
    sq, sl = lut[fpick], qlf[fpick]

    def plain_adc(lt, ql):
        return adc_plain_sample(rt, run, ci["live"], lt, ql, r)

    err = bitwise((kd[fpick], ki[fpick]), plain_adc(sq, sl), "fusedadc wide")
    del kd, ki
    kern = k5_time(rt, ci, r)
    plain = time_ms(plain_adc, [(sq, sl)], warmup=1)
    bnd, _ = k5_bound(ci, index, m, C, r)
    rows["fusedadc"].update(wide_k=r, wide_ms=kern[0], wide_plain_ms=plain[0],
                            wide_plain_rows=fpick.numel(), wide_bound_ms=bnd[0],
                            wide_bound_by=bnd[1],
                            wide_launches=launches["fusedadc.wide"],
                            wide_max_abs_err=err, wide_search_wall_s=wall["fused"])
    log(f"p7 codes: rerank {r} pallas {wall['pallas']} s, fused {wall['fused']} s, "
        f"bit-identical; the rerank {w128} candidates their prefix; launches "
        f"{json.dumps(launches)}; adcscan wide {rows['adcscan']['wide_ms']} ms a "
        f"wave, fusedadc wide {kern[0]} ms")


def lc_segment_bytes(sizes, append_rows):
    """Bytes on disk of the phase's segments: each append of ``append_rows``
    rows is an index of twice as many rows (the routing padding), float32
    vectors plus int32 ids and leaves, and its CSR offsets."""
    rows = 2 * append_rows
    per = rows * (DIM * 4 + 8) + (sizes["n_leaves"] + 1) * 4
    return sizes["lc_appends"] * per


def disk_probe(directory: Path, nbytes: int) -> dict:
    """One ``nbytes`` array through ``np.save`` + fsync, ``np.load`` and
    crc32 in the phase's directory: (write, read, crc32) bytes/s."""
    a = np.random.default_rng(0).integers(0, 2**31 - 1, size=nbytes // 4,
                                          dtype=np.int32)
    p = directory / "probe.npy"
    t0 = time.perf_counter()
    np.save(p, a)
    fd = os.open(p, os.O_RDONLY)
    os.fsync(fd)
    os.close(fd)
    t1 = time.perf_counter()
    b = np.load(p)
    t2 = time.perf_counter()
    zlib.crc32(b.view(np.uint8))
    t3 = time.perf_counter()
    p.unlink()
    return dict(write=nbytes / (t1 - t0), read=nbytes / (t2 - t1),
                crc32=nbytes / (t3 - t2))


def lc_plan_rows(sizes, free, elapsed):
    """The rows each append takes: the sift100m index split in
    ``lc_appends``; halved (not below ``LC_MIN_ROWS`` in all) while
    ``free`` bytes of disk hold less than ``LC_FREE_FACTOR`` times the
    segments, and cut to ``LC_MIN_ROWS`` in all if the script's ``elapsed``
    seconds pass ``LC_LATEST_START_S``. Returns (rows an append, cut note
    or None)."""
    rows = sizes["index_rows"] // sizes["lc_appends"]
    least = LC_MIN_ROWS // sizes["lc_appends"]
    cut = []
    while rows > least and free < LC_FREE_FACTOR * lc_segment_bytes(sizes, rows):
        rows //= 2
        cut.append(f"halved to {rows} rows an append: {free / 2**30:.1f} GiB free")
    if rows > least and elapsed > LC_LATEST_START_S:
        rows = least
        cut.append(f"cut to {rows} rows an append: the phase starts at "
                   f"{elapsed:.0f} s, past {LC_LATEST_START_S} s")
    return rows, "; ".join(cut) or None


def dir_bytes(directory) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(directory) for f in fs)


def span_s(tracer, name) -> float:
    return sum(s.dur_ms for s in tracer.spans if s.name == name) / 1e3


def tie_only_differences(a, b, k):
    """Raise unless (ids, dists) tables ``a`` and ``b`` have bit-identical
    distances and differ in ids only inside exact distance ties: sorted
    by (distance, id) within each row, the ids agree wherever the distance
    is below the row's k-th (whose tie group the top-k may cut). Returns
    how many ids differ in place."""
    if not torch.equal(a.dists, b.dists):
        raise AssertionError("distances differ")
    ia, ib, d = a.ids.cpu().numpy(), b.ids.cpu().numpy(), a.dists.cpu().numpy()
    oa = np.lexsort((ia, d), axis=1)
    ob = np.lexsort((ib, d), axis=1)
    sa, sb = np.take_along_axis(ia, oa, 1), np.take_along_axis(ib, ob, 1)
    ds = np.take_along_axis(d, oa, 1)
    inner = ds < d[:, k - 1:k]
    if not np.array_equal(sa[inner], sb[inner]):
        raise AssertionError("ids differ outside exact distance ties")
    return int((ia != ib).sum())


def same_result(a, b, what):
    if not (torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)):
        raise AssertionError(f"{what}: ids or distances differ")


def dead_row_checks(rt, idx, run, sizes, seed):
    """K1 and K2 on a segment with dense tombstones (rows whose vector is
    ``TOMBSTONE_VEC`` and whose id is -1, keeping their leaf): both on 64
    waves holding dead rows, each against its query slab, and K2 on the
    segment's whole-shard call (held on sampled lookup rows), against
    their plain versions bit for bit after the scan's id mapping (a dead or
    absent row reads -1 / inf; the dead rows' own distances, about 1e32,
    are no part of any result). Returns the numbers for the kernels line."""
    seg, view = idx.segments[0], idx.segment_views()[0]
    B, qc, k = sizes["block_rows"], sizes["q_cap"], sizes["k"]
    dead = (view.ids < 0) & (seg.index.ids >= 0)
    per_wave = dead[: view.rows // B * B].reshape(-1, B).sum(1)
    with_dead = torch.nonzero(per_wave > 0)[:, 0]
    if with_dead.numel() < N_DEAD_WAVES:
        raise AssertionError(f"only {with_dead.numel()} waves hold dead rows")
    mid = min(with_dead.numel() // 2, with_dead.numel() - N_DEAD_WAVES)
    picks = with_dead[mid:mid + N_DEAD_WAVES].tolist()
    lk = rt.build_lookup(run["tree"], run["queries"], probes=1)

    def mapped(out, pid):
        d, r = out
        i = torch.where(r >= 0, pid[r.clamp(min=0).long()], -1)
        return torch.where(i >= 0, d, torch.inf), i

    err, err_k2, short = 0.0, 0.0, 0
    for w in picks:
        s = w * B
        pv, plf, pid = view.vecs[s:s + B], view.leaves[s:s + B], view.ids[s:s + B]
        start = int(lk.offsets[int(plf[0])].clamp(0, lk.n_queries - qc))
        qv, qlf = lk.vecs[start:start + qc], lk.leaves[start:start + qc]
        kern = mapped(rt.l2_topk(pv, plf, qv, qlf, k=k), pid)
        plain = mapped(rt.l2_topk_ref(pv, plf, qv, qlf, k), pid)
        err = max(err, bitwise(kern, plain, "l2topk on dead rows"))
        err_k2 = max(err_k2, bitwise(rt.fused_topk(pv, plf, pid, qv, qlf, k=k),
                                     plain, "fusedscan on a wave's dead rows"))
        # matched lookup rows with dead rows and fewer than k live rows of
        # their leaf in the wave: their tails are the -1 / inf slots
        live = torch.bincount(plf[pid >= 0].clamp(0, view.n_leaves - 1).long(),
                              minlength=view.n_leaves)
        dl = torch.bincount(plf[dead[s:s + B]].long(), minlength=view.n_leaves)
        ql = qlf.clamp(0, view.n_leaves - 1).long()
        short += int(((qlf >= 0) & (dl[ql] > 0) & (live[ql] < k)).sum())
    flk, _ = fused_inputs(rt, dict(index=view, queries=run["queries"]), sizes, lk)
    kd, ki = rt.fused_topk(view.vecs, view.leaves, view.ids, flk.vecs,
                           flk.leaves, k=k)
    pick = sample_rows(flk, sizes["n_sample"], seed + 7)
    want = rt.map_ids(*chunked_plain(rt, view.vecs, view.leaves, flk.vecs[pick],
                                     flk.leaves[pick], k), view.ids)
    err2 = bitwise((kd[pick], ki[pick]), want, "fusedscan on dead rows")
    tail = int((~torch.isfinite(kd[pick])).sum())
    log(f"dead rows: l2topk and fusedscan on {len(picks)} waves with "
        f"{int(per_wave[picks].sum())} dead rows, {short} matched lookup rows with "
        f"fewer than {k} live rows of their leaf, bit-identical (max_abs_err "
        f"{err}, {err_k2}); fusedscan on the "
        f"segment's call ({int(dead.sum())} dead rows), {pick.numel()} sampled rows "
        f"bit-identical with {tail} -1 / inf tail slots (max_abs_err {err2})")
    return dict(dead_row_waves=len(picks), dead_row_short_rows=short,
                dead_row_max_abs_err=err), dict(
                    dead_row_waves=len(picks), dead_row_wave_max_abs_err=err_k2,
                    dead_row_rows=int(dead.sum()), dead_row_sample=pick.numel(),
                    dead_row_tail_slots=tail, dead_row_max_abs_err=err2)


def query_tile_entry(rt, idx, queries, launches, sizes):
    """K1 at the query-routed executor's shape: ``N_TILES`` real query
    tiles of the first segment (``q_tile`` routed lookup rows against the
    ``p_cap``-row point slab at the tile's first leaf, read in place
    through the slab's device-side start) against the plain version on the
    slab's copy, bit for bit; timed with the plain version and a library
    top-k on the same tiles; the bound counts what the tiles' same-leaf
    pairs need. Returns the kernels line's row."""
    seg = idx.segments[0].index
    n, k, d = queries.shape[0], sizes["k"], DIM
    p = rt.make_plan(rows=seg.rows, n_leaves=seg.n_leaves, n_queries=n,
                     n_shards=1, k=k, layout="query_routed")
    lk = rt.build_lookup(idx.tree, queries, probes=1)
    q_total = rt.lookup_q_total(p, n)
    lk = rt.pad_lookup(lk, q_total)
    cap = rt.routed_capacity(p, q_total)
    routed = rt.route.route_by_leaf(lk.vecs, lk.qids, lk.leaves, n_shards=1,
                                    leaves_per_shard=seg.n_leaves, capacity=cap,
                                    wire_dtype=p.wire_dtype)
    qv, _, ql, _, n_valid = rt.route.cluster_sort(routed, leaf_base=0,
                                                  leaves_per_shard=seg.n_leaves)
    starts = rt.leaf_slab(seg.offsets[0], ql[::p.q_tile], n_entries=seg.n_leaves,
                          total_rows=seg.rows, cap=p.p_cap).start
    n_real = -(-int(n_valid) // p.q_tile)
    tiles = np.linspace(0, n_real - 1, N_TILES).astype(int)
    args, copies = [], []
    for w in tiles:
        sl = slice(w * p.q_tile, (w + 1) * p.q_tile)
        s = int(starts[w])
        args.append((seg.vecs, seg.leaves, qv[sl], ql[sl], starts[w:w + 1]))
        copies.append((seg.vecs[s:s + p.p_cap], seg.leaves[s:s + p.p_cap],
                       qv[sl], ql[sl]))

    def kern(pv, pl, q, qlf, start):
        return rt.l2_topk(pv, pl, q, qlf, k=k, p_start=start, p_rows=p.p_cap)

    err = max(bitwise(kern(*a), rt.l2_topk_ref(*c, k), "l2topk query tile")
              for a, c in zip(args, copies))
    t = time_ms(kern, args)
    plain = time_ms(lambda *c: rt.l2_topk_ref(*c, k), copies)

    def lib_topk(pv, plf, q, qlf):
        d2 = torch.where(qlf[:, None] == plf[None, :],
                         torch.addmm((pv * pv).sum(1)[None, :], q, pv.T, alpha=-2.0),
                         torch.inf)
        return torch.topk(d2, k, dim=1, largest=False)

    lib = time_ms(lib_topk, copies)
    need = sum(int(torch.isin(c[1], c[3]).sum()) for c in copies)
    matched = sum(int(torch.isin(c[3], c[1]).sum()) for c in copies)
    pairs = sum(int(rt.count_pairs(c[1], c[3])) for c in copies)
    qt = p.q_tile
    bnd = bound(((need + matched) * d * 4 + need * 4 + N_TILES * qt * (4 + k * 8))
                / N_TILES, (pairs + need) * 2 * d / N_TILES)
    row = dict(name="l2topk.query_tile", route="cuda",
               source="src/repro_torch/csrc/l2topk.cu",
               replaces="src/repro/kernels/l2topk/kernel.py:105",
               launches=launches, max_abs_err=err, ms=t[0], plain_ms=plain[0],
               bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib[0], wall_ms=t[1],
               q_tile=qt, p_cap=p.p_cap, tiles_timed=N_TILES, real_tiles=n_real,
               routed_tiles=cap // qt, pairs_per_tile=pairs / N_TILES,
               points_needed_per_tile=need / N_TILES)
    log(f"l2topk query tile: {t[0]} ms a tile back to back ({t[1]} ms wall), "
        f"{N_TILES} of {n_real} real tiles (of {cap // qt} routed), q_tile {qt}, "
        f"p_cap {p.p_cap}, slab read in place; plain (slab copy) {plain[0]} ms; "
        f"library {lib[0]} ms; bound {bnd[0]} ms by {bnd[1]}; launches {launches}; "
        f"bit-identical to the copying form (max_abs_err {err})")
    return row


def lifecycle_phase(rt, run, sizes, seed, kernels, t_start):
    """The segment lifecycle on the card (``Index``): grow an index on disk
    from the main path's rows, commit, open, search it four ways, delete,
    compact, enable codes; each step checked as the docstring's phase 5
    says. Frees the main path's index once the rows are appended. Adds the
    K1 query-tile row and the dead-row checks to ``kernels``. The path's
    launch counts are those of the ``Index`` calls alone: the one-shot
    references, the kernel checks and the traced search run outside them."""
    dev, k = run["queries"].device, sizes["k"]
    queries, tree = run["queries"], run["tree"]
    n = queries.shape[0]
    rows_kw = dict(q_cap=sizes["q_cap"], block_rows=sizes["block_rows"])
    directory = LC_DIR
    shutil.rmtree(directory, ignore_errors=True)
    directory.mkdir(parents=True)
    tracer = rt.obs.Tracer()
    prev_tracer = rt.obs.set_tracer(tracer)
    torch.cuda.reset_peak_memory_stats()
    times, rows_of = {}, {r["name"]: r for r in kernels}
    path = dict.fromkeys(LC_KERNELS, 0)  # launches of the lifecycle path

    def on_path(fn, *a, **kw):
        """One ``Index`` call: its launches, and only they, go to the path."""
        rt.reset_counts()
        out = fn(*a, **kw)
        for name in path:
            path[name] += rt.counts()[name]
        rt.reset_counts()
        return out

    def search(idx, **kw):
        """One timed ``Index.search`` of the main path's queries."""
        t0 = sync_now()
        res = on_path(idx.search, queries, k=k, **kw)
        return res, sync_now() - t0

    try:
        elapsed = time.perf_counter() - t_start
        rates = disk_probe(directory, LC_PROBE_BYTES)
        free = shutil.disk_usage(directory).free
        append_rows, cut = lc_plan_rows(sizes, free, elapsed)
        total = append_rows * sizes["lc_appends"]
        need = LC_FREE_FACTOR * lc_segment_bytes(sizes, append_rows)
        log(f"lifecycle: starts at {elapsed:.0f} s; disk probe {json.dumps(rates)} "
            f"B/s; {sizes['lc_appends']} appends of {append_rows} rows ({total} in "
            f"all{'; ' + cut if cut else ', no cut'}); {free / 2**30:.1f} GiB free, "
            f"{need / 2**30:.1f} GiB needed")
        if free < need:
            raise AssertionError(f"lifecycle: {free / 2**30:.1f} GiB free on the "
                                 f"disk, {need / 2**30:.1f} GiB needed")

        # --- grow: create, then the main path's rows in id order ---
        index = run["index"]
        valid = index.ids >= 0
        row_of = torch.empty(sizes["index_rows"], dtype=torch.int64, device=dev)
        row_of[index.ids[valid].long()] = torch.nonzero(valid)[:, 0]
        idx = on_path(rt.Index.create, tree, str(directory), device=dev,
                      wire_dtype=torch.bfloat16)
        for c in range(sizes["lc_appends"]):
            lo, hi = c * append_rows, (c + 1) * append_rows
            chunk = index.vecs[row_of[lo:hi]]
            t0 = sync_now()
            on_path(idx.append, chunk, ids=np.arange(lo, hi))
            times[f"append_{c}"] = sync_now() - t0
            del chunk
        del row_of, valid, index
        t0 = sync_now()
        version = on_path(idx.commit)
        times["commit"] = sync_now() - t0
        written = dir_bytes(directory)
        save_s = span_s(tracer, "index.save")
        # the main path's index is no longer needed: free it (the codes
        # phase's row reader holds it too)
        run.pop("index")
        run["codes"].pop("reader", None)
        run["codes"].pop("codes", None)
        del idx
        gc.collect()
        torch.cuda.empty_cache()

        # --- 1. open, and search point-major at both impls ---
        t0 = sync_now()
        idx = on_path(rt.Index.open, str(directory), device=dev)
        times["open"] = sync_now() - t0
        load_s = span_s(tracer, "index.load")
        if idx.version != version or idx.rows != total:
            raise AssertionError(f"open: version {idx.version}, rows {idx.rows}")
        if total == sizes["index_rows"]:
            ref = run["results"]
        else:  # a cut: the one-shot reference over the appended rows
            ref = lc_oneshot(rt, idx, run, sizes, np.arange(total))
        res = {}
        for name, impl, probes in (("pallas", "pallas", 1), ("fused", "fused", 1),
                                   ("fused_p2", "fused", 2)):
            res[name], times[f"search_{name}"] = search(
                idx, layout="point_major", impl=impl, probes=probes, **rows_kw)
            if int(res[name].q_cap_overflow) != 0:
                raise AssertionError(f"segmented {name}: q_cap overflow")
        same_result(res["pallas"], ref["pallas"], "segmented pallas vs one-shot")
        same_result(res["fused"], ref["pallas"], "segmented fused vs one-shot")
        ties = tie_only_differences(res["fused_p2"], ref["fused_p2"], k)
        log(f"lifecycle 1: {sizes['lc_appends']} segments opened on the card (every "
            f"file crc-checked); point-major pallas and fused at probes 1 "
            f"bit-identical to the one-shot index; at probes 2 the distances "
            f"bit-identical, {ties} ids differ, each inside an exact distance tie")

        # --- 2. query-routed on the opened index ---
        before = path["l2topk"]
        qr, times["search_query_routed"] = search(
            idx, layout="query_routed", impl="xla", probes=1)
        qr_launches = path["l2topk"] - before
        if int(qr.q_cap_overflow) != 0:
            raise AssertionError("query-routed: overflow")
        if dev.type == "cuda" and qr_launches <= 0:
            raise AssertionError("query-routed: l2topk was not launched")
        same_result(qr, res["pallas"], "query-routed vs point-major")
        ev, busy = device_trace(lambda: idx.search(queries, k=k,
                                                   layout="query_routed"))
        log_trace("query_routed", ev, busy, times["search_query_routed"], 5)
        times["query_routed_busy"] = busy
        log(f"lifecycle 2: query-routed bit-identical to point-major, overflow 0, "
            f"l2topk launched {qr_launches} times (one a real query tile, each "
            f"tile's point slab read in place)")
        kernels.append(query_tile_entry(rt, idx, queries, qr_launches, sizes))

        # --- 3. the default call: layout "auto", the heuristic model ---
        plans = [rt.make_plan(rows=s.rows, n_leaves=idx.n_leaves, n_queries=n,
                              n_shards=1, k=k, layout="auto",
                              calibration=idx.calibration)
                 for s in idx.segments]
        if len(set(plans)) != 1:
            raise AssertionError(f"segments of one size got plans {plans}")
        p = plans[0]
        auto, times["search_auto"] = search(idx)
        explicit, _ = search(idx, layout=p.layout, impl=p.impl,
                             block_rows=p.block_rows, q_cap=p.q_cap,
                             q_tile=p.q_tile, p_cap=p.p_cap)
        same_result(auto, explicit, "search(layout='auto') vs its plan")
        log(f"lifecycle 3: idx.search(q, k={k}) planned every segment as "
            f"{p.layout}/{p.impl} block_rows {p.block_rows} q_cap {p.q_cap} "
            f"q_tile {p.q_tile} p_cap {p.p_cap} (heuristic: no calibration of "
            f"this backend), equal to that plan run explicitly; overflow "
            f"{int(auto.q_cap_overflow)}")
        del auto, explicit, qr

        # --- the serving phase on the grown index (steps 1-5) ---
        t0 = time.perf_counter()
        sv = serving_phase(rt, idx, run, sizes, times, p)
        times["serving"] = time.perf_counter() - t0
        for name, n_launch in sv["stats"]["launches"].items():
            rows_of[name]["serving_launches"] = n_launch
        rows_of["l2topk"]["serving_launches"] = sum(
            c["l2topk"] for c in sv["stats"]["calibration"].values()
        ) + sv["stats"]["cache"]["launches"]["l2topk"]

        # --- 4. delete, commit, reopen; a one-shot rebuild of the live rows
        # is the reference ---
        n_dead = total // 100
        dead = np.sort(np.random.default_rng(seed + 17).choice(
            total, n_dead, replace=False))
        t0 = sync_now()
        if on_path(idx.delete, dead) != n_dead:
            raise AssertionError("delete: not every id was tombstoned")
        on_path(idx.commit)
        times["delete_commit"] = sync_now() - t0
        t0 = time.perf_counter()
        serving_refresh(rt, sv, idx, dead, k)
        times["serving_refresh"] = time.perf_counter() - t0
        del sv["session"]
        del idx
        gc.collect()
        torch.cuda.empty_cache()
        t0 = sync_now()
        idx = on_path(rt.Index.open, str(directory), device=dev)
        times["reopen"] = sync_now() - t0
        live = np.setdiff1d(np.arange(total), dead)
        t0 = sync_now()
        rebuilt, rref = lc_oneshot(rt, idx, run, sizes, live, keep=True)
        times["oneshot_rebuild"] = sync_now() - t0
        dead_t = torch.as_tensor(dead, device=dev)
        dres = {}
        for impl in ("pallas", "fused"):
            dres[impl], times[f"search_deleted_{impl}"] = search(
                idx, layout="point_major", impl=impl, **rows_kw)
            if bool(torch.isin(dres[impl].ids, dead_t).any()):
                raise AssertionError(f"delete: a deleted id came back ({impl})")
            same_result(dres[impl], rref, f"delete {impl} vs rebuild")
        k1_dead, k2_dead = dead_row_checks(rt, idx, run, sizes, seed)
        rows_of["l2topk"].update(k1_dead)
        rows_of["fusedscan"].update(k2_dead)
        log(f"lifecycle 4: {n_dead} ids deleted (1 % of {total}); both dense "
            f"impls return no deleted id and equal a one-shot build_index + "
            f"batch_search of the {live.size} live rows")

        # --- 5. compact: the arrays of that rebuild; gc ---
        ref_small = {f: getattr(rebuilt, f) for f in ("ids", "leaves", "offsets")}
        ref_vecs = rebuilt.vecs.cpu()  # on the host while the compaction builds
        del rebuilt
        gc.collect()
        torch.cuda.empty_cache()
        t0 = sync_now()
        merged = on_path(idx.compact)
        times["compact"] = sync_now() - t0
        seg = idx.segments[0].index
        if idx.n_segments != 1 or seg.rows != ref_vecs.shape[0]:
            raise AssertionError(f"compact: {idx.n_segments} segments")
        for f, t in ref_small.items():
            if not torch.equal(getattr(seg, f), t):
                raise AssertionError(f"compact: {f} differ from the rebuild's")
        for s in range(0, seg.rows, 2**22):
            if not torch.equal(seg.vecs[s:s + 2**22].cpu(), ref_vecs[s:s + 2**22]):
                raise AssertionError("compact: vecs differ from the rebuild's")
        del ref_vecs, ref_small
        after, times["search_compacted"] = search(
            idx, layout="point_major", impl="fused", **rows_kw)
        same_result(after, dres["fused"], "compacted vs before compaction")
        report = on_path(idx.gc)
        seg_dir = directory / "segments"
        left = sorted(os.listdir(seg_dir))
        if left != [merged] or len(rt.manifest_versions(str(directory))) != 1:
            raise AssertionError(f"gc left segments {left}")
        block = rt.make_plan(rows=seg.rows, n_leaves=idx.n_leaves, n_queries=n,
                             n_shards=1, k=k, **rows_kw).block_rows
        log(f"lifecycle 5: compact() left one segment ({merged}, {seg.rows} rows, "
            f"block_rows {block} of the {sizes['block_rows']} asked: "
            f"{seg.rows // block} waves a sweep) whose ids, leaves, offsets and "
            f"vecs equal the rebuild's; results unchanged; gc removed "
            f"{json.dumps({k_: len(v) for k_, v in report.items()})}")
        del dres, after

        # --- 6. codes: K5 and K4 give the same candidates; the reranked
        # distances are the exact distances of their ids ---
        t0 = sync_now()
        pq = on_path(idx.enable_codes)
        times["enable_codes"] = sync_now() - t0
        t0 = sync_now()
        on_path(idx.commit)
        times["codes_commit"] = sync_now() - t0
        view = idx.segment_views()[0]
        lookup = rt.build_lookup(tree, queries, probes=1)
        cand = {}
        for impl in ("fused", "pallas"):
            cp = rt.make_plan(rows=view.rows, n_leaves=idx.n_leaves, n_queries=n,
                              n_shards=1, k=k, layout="scan_codes", impl=impl,
                              dim=DIM, code_m=pq.m, code_bits=pq.bits, **rows_kw)
            cand[impl] = rt.search_with_lookup(
                view, lookup, cp, n_queries=n, codes=idx._codes[idx.segments[0].name],
                codebooks=pq.codebooks)
        a, b = cand["fused"], cand["pallas"]
        if not (torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)):
            raise AssertionError("codes: fusedadc and adcscan candidates differ")
        # the searches themselves: the same candidates rerank to the same rows
        cres = {}
        for impl in ("fused", "pallas"):
            cres[impl], times[f"search_codes_{impl}"] = search(
                idx, layout="scan_codes", impl=impl, **rows_kw)
        same_result(cres["pallas"], cres["fused"], "codes: Index.search pallas vs fused")
        r = cres["fused"]
        ok = r.ids >= 0
        rows = on_path(idx.read_rows, r.ids[ok])
        q = queries[:, None, :].expand(-1, k, -1)[ok]
        diff = rows - q
        if not (torch.equal((diff * diff).sum(-1), r.dists[ok])
                and bool(torch.isinf(r.dists[~ok]).all())):
            raise AssertionError("codes: reranked distances are not the exact "
                                 "distances of their ids")
        log(f"lifecycle 6: enable_codes (m {pq.m}, bits {pq.bits}); scan_codes "
            f"candidates bit-identical between fusedadc and adcscan "
            f"(rerank {a.ids.shape[1]}), and so the two searches' results; "
            f"reranked top-{k} distances equal the exact distances of their ids "
            f"read through read_rows on the card")
        del cand, cres, a, b, r, rows, q, diff, lookup, view
        t0 = time.perf_counter()
        serving_codes(rt, sv, idx, k)
        rows_of["fusedadc"]["serving_launches"] = sv["stats"]["codes"]["fusedadc"]
        serving_trace_files(rt, tracer, sv["stats"])
        times["serving_codes_trace"] = time.perf_counter() - t0

        missing = [name for name, v in path.items() if v <= 0]
        if dev.type == "cuda" and missing:
            raise AssertionError(f"lifecycle path: {missing} never launched "
                                 f"({json.dumps(path)})")
        on_disk = dir_bytes(directory)
        stats = dict(append_rows=append_rows, appends=sizes["lc_appends"],
                     rows=total, cut=cut, start_s=elapsed, probe=rates,
                     segment_bytes=written, bytes_on_disk_end=on_disk,
                     save_s=save_s, write_gib_s=written / save_s / 2**30,
                     load_s=load_s, read_gib_s=written / load_s / 2**30,
                     deleted=int(n_dead), compacted_block_rows=block,
                     launches=path, serving=sv["stats"],
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                     times=times)
        log(f"lifecycle: {json.dumps(stats)}")
        del idx
    finally:
        rt.obs.set_tracer(prev_tracer)
        shutil.rmtree(directory, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return stats


# ---------------------------------------------------------------------------
# the serving phase (repro_torch.serving on the lifecycle's grown index)
# ---------------------------------------------------------------------------


class ImageRows:
    """The traces' images' descriptor rows, read in one call from the index
    on the card (``Index.read_rows``) and held on the host: a store with
    ``read_rows`` for ``TraceLoadGenerator`` (image ``i`` owns ids
    ``[i * dpi, (i + 1) * dpi)``, the main path's row ids). Without an
    index it reads zeros (a dry pass that learns a trace's image ids)."""

    def __init__(self, idx, image_ids, dpi: int, dim: int = DIM):
        self.dpi, self.dim, self.rows = dpi, dim, None
        if idx is None:
            return
        uniq = np.unique(np.asarray(image_ids, np.int64))
        ids = (uniq[:, None] * dpi + np.arange(dpi)).reshape(-1)
        rows = idx.read_rows(torch.as_tensor(ids, device=idx.device))
        self.rows = rows.cpu().numpy().reshape(uniq.size, dpi, -1)
        self.slot = dict(zip(uniq.tolist(), range(uniq.size)))

    def read_rows(self, rows):
        rows = np.asarray(rows, np.int64)
        if self.rows is None:
            return np.zeros((rows.size, self.dim), np.float32)
        img = np.array([self.slot[int(i)] for i in rows // self.dpi])
        return self.rows[img, rows % self.dpi]


def serving_requests(rt, idx, n_images: int):
    """The phase's two traces of ``SV_REQUESTS`` one-image requests over the
    index's images (``SV_DPI`` rows each, moved by the trace's noise, trace
    seed ``SV_SEED``): a paced multi-tenant stream (``default_tenant_mix``
    at ``SV_RATE`` images a second: interactive and standard traffic Zipf
    over their own hot sets, batch traffic uniform in 8-fold bursts), and a
    burst, Zipf s = ``SV_ZIPF``, all at t = 0 (the throughput reading)."""
    mix = rt.serving.default_tenant_mix(SV_REQUESTS, rate=SV_RATE)
    image_ids, arrivals = rt.synth.sample_trace(
        SV_REQUESTS, n_images, skew="zipf", zipf_s=SV_ZIPF, seed=SV_SEED)
    # the multi-tenant draw picks its images inside: a dry pass over zeros
    # learns them, so the index is read once for both traces
    dry = rt.serving.TraceLoadGenerator(ImageRows(None, (), SV_DPI, idx.dim),
                                        SV_DPI, noise=SV_NOISE, seed=SV_SEED)
    paced_ids = [r.image_id for r in dry.multi_tenant(mix, n_images)]
    rows = ImageRows(idx, np.concatenate([paced_ids, image_ids]), SV_DPI)
    gen = rt.serving.TraceLoadGenerator(rows, SV_DPI, noise=SV_NOISE,
                                        seed=SV_SEED)
    return gen.multi_tenant(mix, n_images), gen.requests(image_ids, arrivals)


def per_request(results, reqs):
    """Split one search's ``(ids, dists)`` rows back into the requests'."""
    ids, dists = (results.ids.cpu().numpy(), results.dists.cpu().numpy()) \
        if hasattr(results, "ids") else results
    out, off = [], 0
    for r in reqs:
        out.append((ids[off:off + r.rows], dists[off:off + r.rows]))
        off += r.rows
    return out


def same_requests(a, b, what):
    """Raise unless two lists of per-request ``(ids, dists)`` are equal bit
    for bit."""
    for i, ((ia, da), (ib, db)) in enumerate(zip(a, b)):
        if not (np.array_equal(ia, ib) and np.array_equal(da, db)):
            raise AssertionError(f"{what}: request {i} differs")


def replay_direct(rt, idx, session, reqs, k):
    """``Index.search`` over one dispatch's requests with the rung's plan."""
    q = np.concatenate([r.queries for r in reqs])
    rung = session._runtimes[rt.snap_to_bucket(q.shape[0], session.buckets)]
    return per_request(idx.search(q, k=k, plan=rung.plan), reqs)


def steady_launches(rt, fn):
    """Kernel launches of ``fn()`` alone (counts zeroed before, read after)."""
    rt.reset_counts()
    out = fn()
    counts = rt.counts()
    rt.reset_counts()
    return out, counts


def latency_line(m):
    lat = m.latency.summary()
    return (f"p50 {lat['p50_ms']:.1f} ms, p95 {lat['p95_ms']:.1f} ms, p99 "
            f"{lat['p99_ms']:.1f} ms on the batcher's clock; engine "
            f"{m.ms_per_image:.3f} ms an image over {m.engine_batches} dispatches")


def class_latency(m) -> dict:
    """Per priority class: p50 / p99 on the batcher's clock (ms), and the
    requests shed or rejected."""
    out = {}
    for name, cm in sorted(m.per_class.items()):
        lat = cm.latency.summary()
        out[name] = dict(p50_ms=lat["p50_ms"], p99_ms=lat["p99_ms"],
                         completed=cm.completed, shed=cm.shed,
                         rejected=cm.rejected)
    return out


def engine_order(done) -> list:
    """The engine-served requests' ids in completion order (each dispatch's
    requests together): the dispatch sequence a scheduler produced."""
    return [c.rid for c in done if c.source == "engine"]


def served(done) -> dict:
    return {c.rid: (c.ids, c.dists) for c in done if c.ids is not None}


def default_plan(rt, idx, n, k):
    """What the default ``idx.search(q, k)`` resolves every segment to
    (layout and model "auto"; the segments are one size): the plan, the
    candidates whose signature the calibration lacks at those shapes, and
    which model decided."""
    seg_rows = idx.segment_views()[0].rows
    shape_kw = dict(rows=seg_rows, n_leaves=idx.n_leaves, n_queries=n,
                    n_shards=1)
    p = rt.make_plan(k=k, layout="auto", calibration=idx.calibration,
                     **shape_kw)
    shapes = rt.PlanShapes(**shape_kw)
    cands = tuple(rt.make_plan(k=k, layout=lay, **shape_kw)
                  for lay in ("point_major", "query_routed"))
    missing = [rt.signature_key(rt.plan_signature(c)) for c in cands
               if idx.calibration.mean_ms(c, shapes) is None]
    _, decided_by = rt.resolve_model("auto", idx.calibration).decide(
        cands, shapes)
    return p, missing, decided_by


def serving_phase(rt, idx, run, sizes, times, plan_before):
    """Steps 1-5 of the serving phase on the grown index: the fused dense
    session under EDF, its batches replayed through ``Index.search``, FIFO
    equal to EDF, the calibration that decides the default search (P10),
    and the sharded session equal to the unsharded one. Returns the state
    the later steps need."""
    dev, k = run["queries"].device, sizes["k"]
    queries = run["queries"]
    nq = queries.shape[0]  # the calibration rung: the default search's batch
    n_images = idx.rows // SV_DPI
    t0 = time.perf_counter()
    paced, burst = serving_requests(rt, idx, n_images)
    out = dict(requests=len(paced), images=n_images,
               distinct=len({r.image_id for r in paced}),
               rate_images_per_s=SV_RATE, trace_s=time.perf_counter() - t0)

    # --- 1. the fused dense session, EDF, on the paced multi-tenant trace ---
    s = rt.serving.SearchSession(idx, k=k, layout="point_major", impl="fused",
                                 buckets=SV_BUCKETS)
    out["warmup_ms"] = s.warmup()
    out["warmed_builds"] = s.recompiles()
    edf, counts = steady_launches(rt, lambda: rt.serving.MicroBatcher(
        s, max_queue=SV_REQUESTS, scheduler="edf").run(paced))
    m = s.metrics
    n_disp = m.engine_batches
    segs = len(s._segments)
    steady = s.steady_state_recompiles()
    want = {"fusedscan": n_disp * segs, "l2nn": n_disp, "l2topk": 0}
    got = {name: counts[name] for name in want}
    classes = class_latency(m)
    log(f"serving 1: {len(paced)} one-image requests ({out['distinct']} "
        f"distinct of {n_images} images, {SV_DPI} descriptors each), paced "
        f"multi-tenant at {SV_RATE:.0f} images/s, through MicroBatcher (EDF) "
        f"over the fused session (rungs {list(SV_BUCKETS)}, {segs} segments): "
        f"{latency_line(m)}; per class {json.dumps(classes)}; steady-state "
        f"recompiles {steady} (executors and device segments); launches "
        f"{json.dumps(got)}")
    if steady != 0:
        raise AssertionError(f"serving: {steady} steady-state recompiles")
    if dev.type == "cuda" and got != want:
        raise AssertionError(f"serving launches {got}, want {want}")
    lat = m.latency.summary()
    out.update(edf_dispatches=n_disp, edf_ms_per_image=m.ms_per_image,
               edf_engine_ms=m.engine_ms, p50_ms=lat["p50_ms"],
               p95_ms=lat["p95_ms"], p99_ms=lat["p99_ms"], edf_classes=classes,
               launches={"fusedscan": got["fusedscan"], "l2nn": got["l2nn"]},
               steady_state_recompiles=steady)
    votes = [np.bincount(c.ids[:, 0][c.ids[:, 0] >= 0] // SV_DPI).argmax()
             == c.image_id for c in edf if c.ids is not None]
    out["recall_at_1_images"] = float(np.mean(votes))

    # --- 2. dispatched batches replayed through Index.search ---
    by_rid = served(edf)
    req_of = {r.rid: r for r in paced}
    dispatches = [sp.attrs["rids"] for sp in rt.obs.get_tracer().spans
                  if sp.name == "engine.dispatch"][-n_disp:]
    t0 = sync_now()
    for rids in dispatches[:SV_REPLAYS]:
        batch = [req_of[r] for r in rids]
        same_requests([by_rid[r] for r in rids],
                      replay_direct(rt, idx, s, batch, k),
                      "serving 2: a dispatched batch vs Index.search")
    out["replay_s"] = sync_now() - t0
    log(f"serving 2: {min(SV_REPLAYS, len(dispatches))} dispatched batches "
        f"replayed through Index.search with their rung's plan: ids and "
        f"distances bit-identical")

    # the burst: every request at t = 0, so every dispatch is a full rung
    # (the throughput reading; its percentiles are the queue's drain)
    s.metrics = rt.serving.ServingMetrics()
    rt.serving.MicroBatcher(s, max_queue=SV_REQUESTS, scheduler="edf").run(burst)
    mb = s.metrics
    out.update(burst_dispatches=mb.engine_batches,
               burst_ms_per_image=mb.ms_per_image,
               burst_images_per_s=1e3 / mb.ms_per_image)
    log(f"serving 1b: a burst of {len(burst)} requests at t = 0 "
        f"({len({r.image_id for r in burst})} distinct images, Zipf s = "
        f"{SV_ZIPF}): {mb.engine_batches} dispatches, engine "
        f"{mb.ms_per_image:.4f} ms an image ({1e3 / mb.ms_per_image:.0f} "
        f"images/s)")

    # one full dispatch (128 images) timed, then traced: where its wall goes
    batch = [r.queries for r in burst[:nq // SV_DPI]]
    t0 = sync_now()
    s.serve_many(batch)
    wall = sync_now() - t0
    ev, busy = device_trace(lambda: s.serve_many(batch))
    log_trace("serving dispatch", ev, busy, wall, 6)
    out.update(dispatch_wall_s=wall, dispatch_busy_s=busy)

    # --- 3. FIFO on the paced trace: another dispatch sequence ---
    s.metrics = rt.serving.ServingMetrics()
    fifo = rt.serving.MicroBatcher(s, max_queue=SV_REQUESTS,
                                   scheduler="fifo").run(paced)
    f_by = served(fifo)
    both = sorted(set(by_rid) & set(f_by))
    same_requests([by_rid[r] for r in both], [f_by[r] for r in both],
                  "serving 3: FIFO vs EDF")
    if engine_order(fifo) == engine_order(edf):
        raise AssertionError("serving 3: EDF dispatched the paced trace in "
                             "FIFO's order: the check compares nothing")
    out.update(fifo_dispatches=s.metrics.engine_batches,
               fifo_classes=class_latency(s.metrics), fifo_edf_compared=len(both))
    log(f"serving 3: FIFO on the paced trace ({s.metrics.engine_batches} "
        f"dispatches against EDF's {n_disp}, another order): ids and "
        f"distances of all {len(both)} requests both served bit-identical to "
        f"EDF's; FIFO per class {json.dumps(out['fifo_classes'])}")
    s.metrics = m

    # --- 3b. the hot-leaf cache on the card: hits through K1 ---
    out["cache"] = serving_cache(rt, idx, k, paced[:SV_CACHE_REQUESTS], by_rid)

    # --- 4. calibration: the default search's plan before and after ---
    p_b = plan_before
    log(f"serving 4: before: idx.search(q, k={k}) resolves to {p_b.layout}/"
        f"{p_b.impl} ({times['search_auto']:.3f} s in lifecycle 3)")
    cal = {}
    for layout in ("point_major", "query_routed"):
        cs = rt.serving.SearchSession(idx, k=k, layout=layout, impl="xla",
                                      buckets=(nq,))
        t0 = sync_now()
        cs.warmup()
        warm = sync_now() - t0
        per = nq // SV_DPI
        recorded, counts = steady_launches(rt, lambda: [
            cs.serve_many([r.queries for r in burst[i * per:(i + 1) * per]])
            for i in range(SV_CAL_DISPATCHES)])
        cal[layout] = dict(warmup_s=warm, ms_per_image=cs.metrics.ms_per_image,
                           dispatch_s=cs.metrics.engine_ms / 1e3
                           / cs.metrics.engine_batches,
                           l2topk=counts["l2topk"], l2nn=counts["l2nn"],
                           steady=cs.steady_state_recompiles())
        if cal[layout]["steady"] != 0:
            raise AssertionError(f"serving 4: {layout} session rebuilt")
        if dev.type == "cuda" and (counts["l2topk"] <= 0 or counts["l2nn"]
                                   != SV_CAL_DISPATCHES):
            raise AssertionError(f"serving 4: {layout} launches {counts}")
        del cs, recorded
    version = idx.commit()
    p_a, missing, decided_by = default_plan(rt, idx, nq, k)
    t0 = sync_now()
    res = idx.search(queries, k=k)
    wall = sync_now() - t0
    explicit = idx.search(queries, k=k, layout=p_a.layout, impl=p_a.impl,
                          block_rows=p_a.block_rows, q_cap=p_a.q_cap,
                          q_tile=p_a.q_tile, p_cap=p_a.p_cap)
    same_result(res, explicit, "serving 4: default search vs its plan")
    out.update(calibration=cal, commit_version=version,
               plan_before=f"{p_b.layout}/{p_b.impl}",
               wall_before_s=times["search_auto"],
               plan_after=f"{p_a.layout}/{p_a.impl}", wall_after_s=wall,
               decided_by=decided_by,
               missing_signatures=missing)
    log(f"serving 4: two xla sessions (rung {nq}) recorded "
        f"{SV_CAL_DISPATCHES} dispatches each after warmup "
        f"({json.dumps(cal)}); commit -> manifest v{version}; after: "
        f"idx.search(q, k={k}) resolves to {p_a.layout}/{p_a.impl} (decided by "
        f"{out['decided_by']}), {wall:.3f} s, equal to that plan run "
        f"explicitly" + (f"; signatures missing: {missing}" if missing else ""))
    del res, explicit

    # --- 5. sharded equals unsharded ---
    sub = paced[:SV_SUBSET]
    q_sub = np.concatenate([r.queries for r in sub])
    sh = rt.serving.ShardedSearchSession(idx, shards=2, k=k,
                                         layout="point_major", impl="fused",
                                         buckets=SV_BUCKETS)
    sh.warmup()
    a, b = sh.search(q_sub), s.search(q_sub)
    same_requests(per_request(a, sub), per_request(b, sub),
                  "serving 5: sharded vs unsharded")
    if sh.steady_state_recompiles() != 0:
        raise AssertionError("serving 5: the sharded session rebuilt")
    log(f"serving 5: ShardedSearchSession (2 shards, "
        f"{sh.shard_plan.describe()}) over {len(sub)} requests: bit-identical "
        f"to the unsharded session; steady-state recompiles 0")
    del sh, a, b
    return dict(session=s, requests=paced, stats=out, nq=nq)


def serving_cache(rt, idx, k, reqs, reference):
    """Step 3b: a fused session with the hot-leaf cache on over the paced
    trace's first requests. Its slabs live on the card and every hit is one
    K1 launch; every answer, hit or dispatch, equals the cache-free EDF
    run's bit for bit."""
    dev = idx.device
    cs = rt.serving.SearchSession(
        idx, k=k, layout="point_major", impl="fused", buckets=SV_BUCKETS,
        cache_leaves=SV_CACHE_LEAVES, cache_admit_after=2,
        cache_eviction="lru")
    cs.warmup()
    t0 = time.perf_counter()
    done, counts = steady_launches(rt, lambda: rt.serving.MicroBatcher(
        cs, max_queue=SV_REQUESTS, scheduler="edf").run(reqs))
    wall = time.perf_counter() - t0
    got = served(done)
    both = sorted(set(got) & set(reference))
    same_requests([got[r] for r in both], [reference[r] for r in both],
                  "serving 3b: cached session vs the EDF run")
    c, m = cs.cache, cs.metrics
    n_disp, segs = m.engine_batches, len(cs._segments)
    want = {"l2topk": c.hits, "fusedscan": n_disp * segs, "l2nn": n_disp}
    launches = {name: counts[name] for name in want}
    if c.hits == 0:
        raise AssertionError("serving 3b: the cache answered no request")
    if dev.type == "cuda" and (launches != want or not all(
            t.is_cuda for slab in c._slabs.values() for t in slab)):
        raise AssertionError(f"serving 3b: launches {launches}, want {want}, "
                             "or a slab off the card")
    hit_ms = [d.compute_ms for d in done if d.source == "cache"]
    stats = dict(requests=len(reqs), hits=c.hits, hit_rate=c.hit_rate,
                 cached_leaves=c.n_cached_leaves, evictions=c.evictions,
                 resident_mib=c.resident_bytes / 2**20,
                 hit_ms_mean=float(np.mean(hit_ms)), dispatches=n_disp,
                 steady_state_recompiles=cs.steady_state_recompiles(),
                 launches=launches, wall_s=wall)
    log(f"serving 3b: hot-leaf cache ({SV_CACHE_LEAVES} leaves, admit after "
        f"2, lru) over the paced trace's first {len(reqs)} requests: "
        f"{c.hits} hits ({c.hit_rate:.3f}), {stats['resident_mib']:.1f} MiB "
        f"of slabs on the card, a hit {stats['hit_ms_mean']:.3f} ms (one K1 "
        f"launch); {len(both)} answers bit-identical to the cache-free run; "
        f"launches {json.dumps(launches)}; steady-state recompiles "
        f"{stats['steady_state_recompiles']} (not gated: the slabs share the "
        f"allocator); {wall:.1f} s")
    return stats


def serving_refresh(rt, sv, idx, dead, k):
    """Step 6: after the delete + commit, the session adopts the new cut,
    and a batch equals ``Index.search`` on it with no deleted id."""
    s = sv["session"]
    if not s.maybe_refresh():
        raise AssertionError("serving 6: maybe_refresh() adopted nothing")
    sub = sv["requests"][:sv["nq"] // SV_DPI]
    got = per_request(s.search(np.concatenate([r.queries for r in sub])), sub)
    same_requests(got, replay_direct(rt, idx, s, sub, k),
                  "serving 6: refreshed session vs Index.search")
    ids = np.concatenate([g[0] for g in got])
    if np.isin(ids, dead).any():
        raise AssertionError("serving 6: a deleted id came back")
    if s.steady_state_recompiles() != 0:
        raise AssertionError("serving 6: rebuilt after the refresh's warmup")
    sv["stats"]["refresh_version"] = s.pinned_version
    log(f"serving 6: maybe_refresh() adopted manifest v{s.pinned_version} "
        f"(warmed before it returned); {len(sub)} requests equal Index.search "
        f"on the post-delete index, no deleted id in any result")


def serving_codes(rt, sv, idx, k):
    """Step 7: a fused scan_codes session (K5, then the exact rerank)
    equals ``Index.search(layout="scan_codes", impl="fused")``."""
    nq = sv["nq"]
    cs = rt.serving.SearchSession(idx, k=k, layout="scan_codes", impl="fused",
                                  buckets=(nq,))
    cs.warmup()
    per = nq // SV_DPI
    sub = sv["requests"][:SV_SUBSET]
    chunks = [sub[i:i + per] for i in range(0, len(sub), per)]
    got, counts = steady_launches(rt, lambda: [
        cs.serve_many([r.queries for r in c]) for c in chunks])
    for c, g in zip(chunks, got):
        same_requests(g, replay_direct(rt, idx, cs, c, k),
                      "serving 7: codes session vs Index.search")
    if cs.steady_state_recompiles() != 0:
        raise AssertionError("serving 7: the codes session rebuilt")
    want = len(chunks) * len(cs._segments)
    if idx.device.type == "cuda" and counts["fusedadc"] != want:
        raise AssertionError(f"serving 7: fusedadc launched "
                             f"{counts['fusedadc']} times, want {want}")
    sv["stats"]["codes"] = dict(dispatches=len(chunks),
                                fusedadc=counts["fusedadc"],
                                ms_per_image=cs.metrics.ms_per_image)
    log(f"serving 7: scan_codes session (fused, rerank "
        f"{cs._runtimes[nq].rerank}) over {len(sub)} requests equals "
        f"Index.search(layout='scan_codes', impl='fused') after the exact "
        f"rerank; fusedadc launched {counts['fusedadc']} times")


def serving_trace_files(rt, tracer, stats):
    """Step 9: the phase's tracer as a Chrome trace and as JSONL under
    ``build/``, each read by the stdlib-only ``scripts/tracereport.py``."""
    out = {}
    for path in (SV_TRACE, SV_TRACE.with_suffix(".jsonl")):
        rt.obs.export_trace(tracer, str(path))
        rep = subprocess.run(
            [sys.executable, str(Path(__file__).resolve().parent / "scripts"
                                 / "tracereport.py"), str(path), "--top", "3"],
            capture_output=True, text=True, timeout=300)
        if rep.returncode != 0 or "slowest requests" not in rep.stdout:
            raise AssertionError(f"tracereport on {path.name}: {rep.stderr}")
        out[path.name] = path.stat().st_size
    stats["trace_files"] = out
    log(f"serving 9: the phase's trace written as {json.dumps(out)} bytes "
        f"under build/ and read by scripts/tracereport.py")


def serving_cli(dev):
    """Step 8: ``python -m repro_torch.launch.serve`` as a subprocess on
    the device; it must exit 0 with 0 steady-state recompiles."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        *SV_CLI, "--device", dev.type],
                       capture_output=True, text=True, env=env,
                       cwd=str(Path(__file__).resolve().parent), timeout=600)
    wall = time.perf_counter() - t0
    lines = p.stdout.strip().splitlines()
    for line in lines:
        if line.startswith(("warmup:", "served", "latency:", "throughput:",
                            "steady-state", "recall")):
            log(f"serving 8 (cli): {line}")
    if p.returncode != 0 or not any(
            "steady-state recompiles after warmup: 0 (OK)" in ln for ln in lines):
        raise AssertionError(f"serving 8: the CLI exited {p.returncode}:\n"
                             f"{p.stdout[-2000:]}\n{p.stderr[-4000:]}")
    log(f"serving 8: python -m repro_torch.launch.serve {' '.join(SV_CLI)} "
        f"--device {dev.type}: exit 0, 0 steady-state recompiles, {wall:.1f} s")
    return wall


def lc_oneshot(rt, idx, run, sizes, ids, keep=False):
    """The one-shot reference over the rows of ``ids`` (ascending), read
    from ``idx`` on the card: ``build_index`` at the index's wire, then
    ``batch_search`` pallas at probes 1 and fused at probes 2, by name as
    the main path names them; with ``keep``, (the index, its fused search
    at probes 1) -- the delete check's reference (fused equals pallas)."""
    dev = run["queries"].device
    corpus = idx.read_rows(torch.as_tensor(ids, device=dev))
    built = rt.build_index(corpus, run["tree"],
                           ids=torch.as_tensor(ids.astype(np.int32), device=dev),
                           wire_dtype=idx.wire_dtype, device=dev)
    del corpus
    torch.cuda.empty_cache()
    def search(impl, probes):
        return rt.batch_search(built, run["tree"], run["queries"], sizes["k"],
                               probes=probes, q_cap=sizes["q_cap"],
                               block_rows=sizes["block_rows"], impl=impl,
                               device=dev)

    if keep:
        return built, search("fused", 1)
    return dict(pallas=search("pallas", 1), fused_p2=search("fused", 2))


def trace_sweep(rt, run, sizes):
    """Trace one dense sweep (``batch_search`` impl="pallas"), log its top
    device operations against the main-path run's wall time and return
    ({l2topk kernel: [device ms, launches]}, device busy s)."""
    index = run["index"]
    ev, busy = device_trace(lambda: rt.batch_search(
        index, run["tree"], run["queries"], sizes["k"], q_cap=sizes["q_cap"],
        block_rows=sizes["block_rows"], impl="pallas", device=index.device))
    log_trace("pallas", ev, busy, run["times"]["pallas"], 5)
    return {e.key: [e.self_device_time_total / 1e3, e.count]
            for e in ev if "l2topk" in e.key}, busy


def trace_searches(rt, run, sizes):
    """Device busy time of each search path (``torch.profiler``), against
    the wall time of the same search in the main-path run."""
    index, tree, queries = run["index"], run["tree"], run["queries"]
    codes = run["codes"]
    # the sweep's K1 launches: one l2topk_kernel a wave and no other
    # l2topk kernel
    k1, busy = trace_sweep(rt, run, sizes)
    n = sum(c for _, c in k1.values())
    n_waves = index.rows // sizes["block_rows"]
    if n != n_waves or any("l2topk_kernel" not in key for key in k1):
        raise AssertionError(f"dense sweep trace: l2topk kernels "
                             f"{sorted(k1)} x{n} for {n_waves} waves")
    run["sweep_trace"] = dict(
        sweep_trace_ms=sum(ms for ms, _ in k1.values()), sweep_trace_launches=n,
        sweep_busy_s=busy, sweep_wall_s=run["times"]["pallas"])

    def dense(impl, probes):
        rt.batch_search(index, tree, queries, sizes["k"], probes=probes,
                        q_cap=sizes["q_cap"], block_rows=sizes["block_rows"],
                        impl=impl, device=index.device)

    def scan_codes(impl, probes):
        r = codes["results"][impl if probes == 1 else "fused_p2"]
        lookup = rt.build_lookup(tree, queries, probes=probes)
        rt.search_with_lookup(index, lookup, r["plan"],
                              n_queries=queries.shape[0], codes=codes["codes"],
                              codebooks=codes["pq"].codebooks)

    for name, search, impl, probes, wall, key, kernel in (
            ("fused", dense, "fused", 1, run["times"]["fused"], "fused_trace",
             "fusedscan"),
            ("fused p2", dense, "fused", 2, run["times"]["fused_p2"], "fused_trace_p2",
             "fusedscan"),
            ("codes pallas", scan_codes, "pallas", 1, codes["times"]["pallas"], None,
             None),
            ("codes fused", scan_codes, "fused", 1, codes["times"]["fused"],
             "fused_codes_trace", "adcscan"),
            ("codes fused p2", scan_codes, "fused", 2, codes["times"]["fused_p2"],
             "fused_codes_trace_p2", "adcscan")):
        ev, busy = device_trace(lambda: search(impl, probes))
        log_trace(name, ev, busy, wall, 5)
        if key:  # the fused kernel's device ms in the trace, busy s, wall s
            ms = sum(e.self_device_time_total for e in ev if kernel in e.key) / 1e3
            tag = "p2_" if probes == 2 else ""
            run.setdefault(key.replace("_p2", ""), {}).update({
                f"trace_{tag}kernel_ms": ms, f"trace_{tag}busy_s": busy,
                f"trace_{tag}wall_s": wall})


def device_trace(fn):
    """(device-side profiler events, device busy s) of one call of ``fn``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    # device-side events only: a CPU op's device time repeats its kernels'
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return ev, sum(e.self_device_time_total for e in ev) / 1e6


def log_trace(name, ev, busy, wall, n_top):
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:n_top]
    log(f"trace {name}: device busy {busy} s of {wall} s wall "
        f"(idle share {1 - busy / wall}); top device time: " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 1e3} ms x{e.count}"
            for e in top))


def trace_build(rt, args, dev, sizes, tree, wall):
    """Device busy time of one extra ``build_index`` on the main path's
    corpus (made again from the seed) and tree, against the wall time of
    the timed build; returns K3's share for the kernels line."""
    mix = rt.synth.make_mixture(256, DIM, seed=args.seed)
    corpus = make_corpus(rt, sizes["index_rows"], args.seed, dev, mix)
    ev, busy = device_trace(lambda: rt.build_index(
        corpus, tree, wire_dtype=torch.bfloat16, device=dev))
    del corpus
    gc.collect()
    torch.cuda.empty_cache()
    log_trace("build_index", ev, busy, wall, 6)
    k3 = [e for e in ev if "l2nn" in e.key]
    return dict(build_trace_ms=sum(e.self_device_time_total for e in k3) / 1e3,
                build_trace_launches=sum(e.count for e in k3),
                build_busy_s=busy, build_wall_s=wall)


def lm_pairs(sq: int, skv: int, window: int) -> int:
    """Unmasked (query, key) pairs of one head of causal attention with the
    query offset skv - sq and an optional window."""
    qa = np.arange(sq, dtype=np.int64) + (skv - sq)
    lo = np.maximum(0, qa - window + 1) if window > 0 else np.zeros_like(qa)
    return int((qa - lo + 1).sum())


def run_lm_path(rt, args, dev):
    """Serve gemma3-4b: prefill 4 x 2048 prompt tokens through flashattn,
    then 32 greedy decode steps. Returns what the checks need."""
    cfg = dataclasses.replace(rt.lm.GEMMA3_4B, attn_impl="chunked")
    t0 = sync_now()
    params = rt.init_params(cfg.param_specs(),
                            torch.Generator(device=dev).manual_seed(args.seed),
                            device=dev, dtype=cfg.compute_dtype)
    t_init = sync_now() - t0
    prompts = torch.as_tensor(
        rt.lm_batch(LM_BATCH, LM_PROMPT, cfg.vocab_size, seed=args.seed)["tokens"],
        device=dev)
    max_seq = LM_PROMPT + LM_DECODE
    weights = [params["embed"], params["final_norm"], *params["layers"].values()]
    gib = sum(t.numel() * t.element_size() for t in weights) / 2**30
    log(f"lm: {cfg.name}, {cfg.param_count()} parameters drawn on the card in "
        f"{t_init:.3f} s ({gib:.3f} GiB in bf16); {LM_BATCH} prompts x {LM_PROMPT} "
        f"tokens, {LM_DECODE} decode steps")
    # warm-up: one short request (cuBLAS handles, first-call set-up)
    _, wc = rt.tfm.prefill(params, cfg, prompts[:1, :64], 65, device=dev)
    rt.tfm.decode_step(params, cfg, prompts[:1, :1], wc, 64, device=dev)
    del wc

    captured, calls = {}, [0]  # the q, k, v the prefill feeds to the checked layers
    real = rt.tfm.flash_attention

    def capture(q, k, v, *, window):
        if calls[0] in LM_CHECK_LAYERS:
            captured[calls[0]] = (q.clone(), k.clone(), v.clone(), window)
        calls[0] += 1
        return real(q, k, v, window=window)

    torch.cuda.reset_peak_memory_stats()
    rt.reset_counts()
    rt.tfm.flash_attention = capture
    try:
        t0 = sync_now()
        logits, cache = rt.tfm.prefill(params, cfg, prompts, max_seq, device=dev)
        t_prefill = sync_now() - t0
    finally:
        rt.tfm.flash_attention = real
    step_logits, generated = [], []
    nxt = logits[:, -1:].argmax(-1)
    t0 = sync_now()
    for t in range(LM_DECODE):
        generated.append(nxt)
        dl, cache = rt.tfm.decode_step(params, cfg, nxt, cache, LM_PROMPT + t, device=dev)
        step_logits.append(dl[:, 0])
        nxt = dl[:, -1:].argmax(-1)
    t_decode = sync_now() - t0
    launches = rt.counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    flops = rt.lm.lm_model_flops(cfg, LM_BATCH, LM_PROMPT, "prefill")
    log(f"lm prefill: {t_prefill:.4f} s for {LM_BATCH * LM_PROMPT} tokens "
        f"({LM_BATCH * LM_PROMPT / t_prefill:.1f} tokens/s, "
        f"{flops / t_prefill / 1e12:.2f} TFLOP/s of {flops / 1e12:.2f} TFLOP model "
        f"FLOPs); decode: {LM_DECODE} steps in {t_decode:.4f} s "
        f"({t_decode / LM_DECODE * 1e3:.3f} ms a step, "
        f"{LM_BATCH * LM_DECODE / t_decode:.1f} tokens/s); peak device memory "
        f"{peak:.3f} GiB; launches {json.dumps(launches)}")
    if launches["flashattn"] != cfg.n_layers:
        raise AssertionError(f"flashattn launched {launches['flashattn']} times in "
                             f"the prefill of {cfg.n_layers} layers")
    if (launches["flashattn.tensor_core"] != cfg.n_layers
            or launches["flashattn.cuda_core"] != 0):
        raise AssertionError(f"the prefill's flashattn launches did not all go to "
                             f"the tensor-core kernel: {json.dumps(launches)}")
    return dict(cfg=cfg, params=params, prompts=prompts, logits=logits, cache=cache,
                step_logits=torch.stack(step_logits, 1),
                generated=torch.cat(generated, 1), captured=captured,
                launches=launches, times=dict(prefill=t_prefill, decode=t_decode))


def check_lm_path(rt, lm):
    """(a) chunked (flashattn) against full (plain attend) prefill logits and
    layer 0's cache; (b) decode steps against forward; both within the bf16
    model's own rounding error, the largest |bf16 - fp32| logit of the full
    prefill with the same weights in fp32."""
    cfg, params, prompts, dev = lm["cfg"], lm["params"], lm["prompts"], lm["prompts"].device
    max_seq = LM_PROMPT + LM_DECODE
    lc = lm["logits"]
    if lc.shape != (LM_BATCH, LM_PROMPT, cfg.vocab_size) or lc.dtype != torch.float32:
        raise AssertionError(f"lm prefill logits {tuple(lc.shape)} {lc.dtype}")
    if not (bool(torch.isfinite(lc).all()) and bool(torch.isfinite(lm["step_logits"]).all())):
        raise AssertionError("lm: non-finite logits")
    n = LM_DECODE + 1  # the prompt's last position and each step's
    # (b) decode after prefill == forward over prompt + generated, same positions
    full_toks = torch.cat([prompts, lm["generated"]], 1)
    fwd, _ = rt.tfm.forward(params, cfg, full_toks, device=dev)
    fwd_tail = fwd[:, LM_PROMPT - 1:].clone()
    del fwd
    served = torch.cat([lc[:, -1:], lm["step_logits"]], 1)  # (B, 33, V)
    e_dec = float((served - fwd_tail).abs().max())
    greedy = float((served.argmax(-1) == fwd_tail.argmax(-1)).float().mean())
    del fwd_tail
    # (a) the same prefill through plain attend
    full_cfg = dataclasses.replace(cfg, attn_impl="full")
    lf, cf = rt.tfm.prefill(params, full_cfg, prompts, max_seq, device=dev)
    for key in ("k", "v"):
        if not torch.equal(cf[key][0, :, :LM_PROMPT], lm["cache"][key][0, :, :LM_PROMPT]):
            raise AssertionError(f"lm: layer 0's {key} cache differs between paths")
    del cf
    e_cf = float((lc - lf).abs().max())
    rms_cf = float((lc - lf).square().mean().sqrt())
    top1 = float((lc[:, -1].argmax(-1) == lf[:, -1].argmax(-1)).float().mean())
    # the yardstick: the same weights and prefill in fp32
    cfg32 = dataclasses.replace(cfg, dtype="float32", attn_impl="full")
    p32 = {"embed": params["embed"].float(), "final_norm": params["final_norm"].float(),
           "layers": {k: v.float() for k, v in params["layers"].items()}}
    l32, c32 = rt.tfm.prefill(p32, cfg32, prompts, LM_PROMPT, device=dev)
    del p32, c32
    gc.collect()
    e_b = float((lf - l32).abs().max())
    rms_b = float((lf - l32).square().mean().sqrt())
    e_b_tail = float((lf[:, -n:] - l32[:, -n:]).abs().max())
    e_c32 = float((lc - l32).abs().max())
    del l32, lf
    torch.cuda.empty_cache()
    out = dict(chunked_vs_full=e_cf, bf16_vs_fp32=e_b, chunked_vs_fp32=e_c32,
               decode_vs_forward=e_dec, bf16_vs_fp32_last33=e_b_tail,
               greedy_agree_decode_forward=greedy, last_top1_agree_chunked_full=top1,
               rms_chunked_vs_full=rms_cf, rms_bf16_vs_fp32=rms_b,
               logit_abs_max=float(lc.abs().max()))
    log(f"lm checks: {json.dumps(out)}")
    if not e_cf <= e_b:
        raise AssertionError(f"lm (a): chunked vs full prefill logits differ by {e_cf}, "
                             f"more than the bf16 model's own error {e_b}")
    if not e_dec <= e_b_tail:
        raise AssertionError(f"lm (b): decode vs forward logits differ by {e_dec}, more "
                             f"than the bf16 model's own error {e_b_tail}")
    return out


def lm_kernel_check(rt, lm, seed):
    """(c) flashattn against its plain version on the prefill's own q, k, v
    at layers 0 and 5, bf16 and fp32 copies, with broken plain variants
    that must fail; times at layer 5's shape. Returns the kernels-line row."""
    fa, ref = rt.flash_attention, rt.flash_attention_ref
    dev = lm["prompts"].device
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    rows, errs = {}, {}
    for layer in LM_CHECK_LAYERS:
        q, k, v, window = lm["captured"][layer]
        if rt.fa_variant(q.dtype, q.shape[-1]) != "tensor_core":
            raise AssertionError(f"flashattn layer {layer}: bf16 at hd {q.shape[-1]} "
                                 f"does not take the tensor-core kernel")
        got, want = fa(q, k, v, window=window), ref(q, k, v, window=window)
        tol = rt.attention_bf16_tol(q, k, v, window=window)
        ratio = float(((got.double() - want.double()).abs() / tol).max())
        errs[layer] = float((got.float() - want.float()).abs().max())
        cc = fa(q, k, v, window=window, kernel="cuda_core")  # the yardstick kernel
        cc_ratio = float(((cc.double() - want.double()).abs() / tol).max())
        del cc
        # broken plain variants: (kernel rows, variant, tolerance rows)
        broken = {
            "heads_shifted": (got, ref(q, k.roll(1, dims=2), v.roll(1, dims=2),
                                       window=window), tol),
            # each row misses its own key and may see one more in the past
            "diagonal_off_by_one": (got[:, 1:], ref(q[:, 1:], k[:, :-1], v[:, :-1],
                                                    window=window), tol[:, 1:]),
        }
        if window > 0:
            broken["window_plus_one"] = (got, ref(q, k, v, window=window + 1), tol)
        broken_ratio = {name: float(((a.double() - b.double()).abs() / t).max())
                        for name, (a, b, t) in broken.items()}
        del got, want, tol, broken
        # fp32 copies off the bf16 grid, batch row 0 (the oracle is float64)
        q32, k32, v32 = (t[:1].float().mul_(1 + (torch.rand(t[:1].shape, generator=g,
                                                             device=dev) - 0.5) * 2**-8)
                         for t in (q, k, v))
        exact, bnd = rt.attention_f64(q32, k32, v32, window=window)
        r32 = rt.attention_error_ratio(fa(q32, k32, v32, window=window), exact, bnd)
        with tf32_matmuls():
            rtf = rt.attention_error_ratio(ref(q32, k32, v32, window=window), exact, bnd)
        del exact, bnd, q32, k32, v32
        rows[layer] = dict(window=window, bf16_tol_ratio=ratio, max_abs_err=errs[layer],
                           cuda_core_bf16_tol_ratio=cc_ratio,
                           broken_variant_ratios=broken_ratio, fp32_bound_ratio=r32,
                           tf32_bound_ratio=rtf)
        log(f"flashattn at layer {layer} (window {window}, q {tuple(q.shape)}, kv "
            f"{tuple(k.shape)}): {json.dumps(rows[layer])}")
        if not ratio <= 1.0:
            raise AssertionError(f"flashattn layer {layer}: {ratio} x the bf16 tolerance")
        if not cc_ratio <= 1.0:
            raise AssertionError(f"flashattn layer {layer}: the CUDA-core kernel at "
                                 f"{cc_ratio} x the bf16 tolerance")
        for name, br in broken_ratio.items():
            if not br > 1.0:
                raise AssertionError(f"flashattn layer {layer}: the broken plain variant "
                                     f"{name} passes the check ({br} x)")
        real_check(f"flashattn layer {layer}", r32, rtf)

    # times at layer 5's shape (global, causal), back to back: the
    # tensor-core kernel the prefill runs, the CUDA-core kernel on the same
    # bf16 inputs, the plain version and sdpa. The sub-millisecond calls run
    # 50 times, so that each timed run lasts tens of milliseconds (over 10
    # calls one run read the tensor-core kernel 20 % slower than two others)
    q, k, v, window = lm["captured"][5]
    reps = [(q, k, v)] * 50
    kern = time_ms(lambda q, k, v: fa(q, k, v, window=window), reps)
    kern_cc = time_ms(lambda q, k, v: fa(q, k, v, window=window, kernel="cuda_core"),
                      reps[:5])
    plain = time_ms(lambda q, k, v: ref(q, k, v, window=window), reps[:5])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    heads_first = [t.transpose(1, 2).contiguous() for t in (q, k, v)]  # (B, H, S, hd)
    lib = time_ms(lambda q, k, v: sdpa(q, k, v, is_causal=True, enable_gqa=True),
                  [heads_first] * 50)
    del heads_first
    q0, k0, v0, w0 = lm["captured"][0]
    kern0 = time_ms(lambda q, k, v: fa(q, k, v, window=w0), [(q0, k0, v0)] * 50)
    B, Sq, Hq, hd = q.shape
    flops = 4.0 * hd * B * Hq * lm_pairs(Sq, k.shape[1], window)
    byt = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()  # q, k, v, out
    bnd = bound(byt, flops, BF16_FLOPS)
    row = dict(name="flashattn", route="cuda", source="src/repro_torch/csrc/flashattn_tc.cu",
               replaces="src/repro/kernels/flashattn/kernel.py:80",
               launches=lm["launches"]["flashattn"], max_abs_err=max(errs.values()),
               ms=kern[0], plain_ms=plain[0], bound_ms=bnd[0], bound_by=bnd[1],
               library_ms=lib[0], wall_ms=kern[1],
               fp32_bound_ratio=max(r["fp32_bound_ratio"] for r in rows.values()),
               tf32_bound_ratio=min(r["tf32_bound_ratio"] for r in rows.values()),
               shape=[B, Sq, Hq, k.shape[2], hd], flops=flops, bytes=byt,
               layer0_ms=kern0[0], tflops=flops / kern[0] / 1e9,
               prefill_launches_by_kernel={
                   "tensor_core": lm["launches"]["flashattn.tensor_core"],
                   "cuda_core": lm["launches"]["flashattn.cuda_core"]},
               cuda_core_source="src/repro_torch/csrc/flashattn.cu",
               cuda_core_ms=kern_cc[0], cuda_core_tflops=flops / kern_cc[0] / 1e9,
               fp32_checked_on="cuda_core", layers={str(i): r for i, r in rows.items()})
    log(f"flashattn (tensor-core kernel): {kern[0]} ms back to back at layer 5's shape "
        f"({kern[1]} ms wall, {flops / kern[0] / 1e9:.2f} TFLOP/s); CUDA-core kernel on "
        f"the same bf16 inputs {kern_cc[0]} ms ({flops / kern_cc[0] / 1e9:.2f} TFLOP/s); "
        f"plain {plain[0]} ms; sdpa {lib[0]} ms; bound {bnd[0]} ms by {bnd[1]} "
        f"({flops / 1e9:.2f} GFLOP, {byt / 2**20:.1f} MiB); layer 0 (window {w0}) "
        f"{kern0[0]} ms")
    return row


def trace_lm(rt, lm):
    """Device time by kernel (``torch.profiler``) of one chunked prefill and
    one decode step, against the wall times of the served run."""
    cfg, params, prompts = lm["cfg"], lm["params"], lm["prompts"]
    dev = prompts.device
    cache = rt.tfm.init_cache(cfg, LM_BATCH, LM_PROMPT + LM_DECODE, device=dev)
    steps = (
        ("prefill", lm["times"]["prefill"], lambda: rt.tfm.prefill(
            params, cfg, prompts, LM_PROMPT + LM_DECODE, device=dev)),
        ("decode step", lm["times"]["decode"] / LM_DECODE, lambda: rt.tfm.decode_step(
            params, cfg, lm["generated"][:, :1], cache, LM_PROMPT, device=dev)),
    )
    for name, wall, fn in steps:
        ev, busy = device_trace(fn)
        top = sorted(ev, key=lambda e: -e.self_device_time_total)[:8]
        log(f"trace lm {name}: device busy {busy} s of {wall} s wall (idle share "
            f"{1 - busy / wall}); {sum(e.count for e in ev)} kernels; top device "
            "time: " + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3} ms "
                                 f"x{e.count}" for e in top))


class Port:
    """The port's entry points and kernel wrappers, imported from ``src``
    (this checkout's by default)."""

    def __init__(self, src=None):
        sys.path.insert(0, str(src or Path(__file__).resolve().parent / "src"))
        import repro_torch
        from repro_torch import obs
        from repro_torch.codes import IndexRowReader, ProductQuantizer, rerank_exact
        from repro_torch.codes import pq as pq_module
        from repro_torch.configs import lm
        from repro_torch.core import route
        from repro_torch.core.engine.executors import (
            _build_adc_lut,
            _live_leaves,
            routed_capacity,
        )
        from repro_torch import serving
        from repro_torch.core.engine.costmodel import (
            PlanShapes,
            plan_signature,
            resolve_model,
            signature_key,
        )
        from repro_torch.core.engine.plan import plan as make_plan
        from repro_torch.core.engine.plan import snap_to_bucket
        from repro_torch.core.engine.tilescan import count_pairs, fold_topk, leaf_slab
        from repro_torch.core.lookup import build_lookup
        from repro_torch.core.search import (
            lookup_q_total,
            pad_lookup,
            search_with_lookup,
        )
        from repro_torch.data import synth
        from repro_torch.data.batches import lm_batch
        from repro_torch.index.manifest import list_versions
        from repro_torch.kernels import _build, fp32_bound
        from repro_torch.kernels.adcscan.ops import adc_topk
        from repro_torch.kernels.adcscan.ref import adc_topk_ref
        from repro_torch.kernels.flashattn.ops import flash_attention, variant
        from repro_torch.kernels.flashattn.ref import flash_attention_ref
        from repro_torch.kernels.fusedscan.ops import fused_adc_topk, fused_topk
        from repro_torch.kernels.fusedscan.ref import map_ids
        from repro_torch.kernels.l2nn.ops import l2_nearest
        from repro_torch.kernels.l2nn.ref import l2_nearest_ref
        from repro_torch.kernels.l2topk import ops as l2topk_ops
        from repro_torch.kernels.l2topk.ops import l2_topk
        from repro_torch.kernels.l2topk.ref import l2_topk_ref
        from repro_torch.models import transformer as tfm
        from repro_torch.models.module import init_params

        self.build_tree = repro_torch.build_tree
        self.build_index = repro_torch.build_index
        self.batch_search = repro_torch.batch_search
        self.tree_assign = repro_torch.tree_assign
        self.Index, self.obs, self.route = repro_torch.Index, obs, route
        self.serving, self.PlanShapes = serving, PlanShapes
        self.plan_signature, self.signature_key = plan_signature, signature_key
        self.resolve_model, self.snap_to_bucket = resolve_model, snap_to_bucket
        self.leaf_slab, self.routed_capacity = leaf_slab, routed_capacity
        self.manifest_versions = list_versions
        self.build_lookup = build_lookup
        self.synth = synth
        self.build = _build
        self.count_pairs = count_pairs
        self.fold_topk, self.map_ids = fold_topk, map_ids
        self.make_plan, self.lookup_q_total = make_plan, lookup_q_total
        self.pad_lookup = pad_lookup
        self.topk_f64 = fp32_bound.topk_f64
        self.topk_error_ratio = fp32_bound.topk_error_ratio
        self.nearest_error_ratio = fp32_bound.nearest_error_ratio
        self.ties_within_bound = fp32_bound.ties_within_bound
        self.encode_chunk = pq_module._ENCODE_CHUNK
        self.l2_topk, self.l2_topk_ref = l2_topk, l2_topk_ref
        self.l2topk_ops = l2topk_ops
        self.fused_topk = fused_topk
        self.l2_nearest, self.l2_nearest_ref = l2_nearest, l2_nearest_ref
        self.ProductQuantizer, self.IndexRowReader = ProductQuantizer, IndexRowReader
        self.rerank_exact, self.search_with_lookup = rerank_exact, search_with_lookup
        self.build_adc_lut, self.live_leaves = _build_adc_lut, _live_leaves
        self.adc_topk, self.adc_topk_ref = adc_topk, adc_topk_ref
        self.fused_adc_topk = fused_adc_topk
        self.lm, self.tfm, self.lm_batch, self.init_params = lm, tfm, lm_batch, init_params
        self.flash_attention, self.flash_attention_ref = flash_attention, flash_attention_ref
        self.fa_variant = variant
        self.attention_f64 = fp32_bound.attention_f64
        self.attention_error_ratio = fp32_bound.attention_error_ratio
        self.attention_bf16_tol = fp32_bound.attention_bf16_tol
        self.wrappers = {"l2topk": l2_topk, "fusedscan": fused_topk,
                         "l2nn": l2_nearest, "adcscan": adc_topk,
                         "fusedadc": fused_adc_topk, "flashattn": flash_attention}

    def reset_counts(self):
        for fn in self.wrappers.values():
            fn.launches = 0
            fn.wide_launches = 0
        fa = self.flash_attention.variant_launches
        for name in fa:
            fa[name] = 0

    def counts(self):
        """Launches by wrapper; ``<name>.wide``: those of them that went
        to the wide kernel (k past the KCAP kernels' lists)."""
        out = {name: fn.launches for name, fn in self.wrappers.items()}
        for name in ("l2topk", "fusedscan", "adcscan", "fusedadc"):
            out[f"{name}.wide"] = getattr(self.wrappers[name], "wide_launches", 0)
        for name, n in self.flash_attention.variant_launches.items():
            out[f"flashattn.{name}"] = n
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    rt = Port()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    rt.build.lib()
    built = rt.build.build_seconds
    log(f"kernel build: {'found built' if built is None else f'{built} s'} "
        f"(nvcc, one process per source); "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    name = None
    for line in rt.build.ptxas_report.splitlines():  # registers, spills
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("Used" in line or "spill" in line):
            log(f"ptxas {name}: {line.split(':', 1)[-1].strip()}")

    sizes = SIZES
    torch.cuda.reset_peak_memory_stats()
    rt.reset_counts()
    run = run_main_path(rt, args, dev, sizes)
    run["launches"] = rt.counts()
    log(f"main-path launches {json.dumps(run['launches'])}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for name in ("l2topk", "fusedscan", "l2nn"):
        if run["launches"][name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    run["recall"] = check_main_path(rt, run, sizes, args.seed)

    torch.cuda.reset_peak_memory_stats()
    rt.reset_counts()
    run_codes_path(rt, run, sizes)
    run["codes_launches"] = rt.counts()
    log(f"codes-path launches {json.dumps(run['codes_launches'])}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for name in ("adcscan", "fusedadc", "l2nn"):
        if run["codes_launches"][name] <= 0:
            raise AssertionError(f"{name} was not launched on the codes path")
    check_codes_path(rt, run, sizes)
    trace_searches(rt, run, sizes)
    kernels = kernel_checks(rt, run, sizes, args.seed)
    p7_phase(rt, run, sizes, args.seed, kernels)
    lifecycle_phase(rt, run, sizes, args.seed, kernels, t_start)
    serving_cli(dev)

    tree, build_wall = run["tree"], run["times"]["build_index"]
    del run  # the search phases' tensors (the dense phase peaks at 41 GiB)
    gc.collect()
    torch.cuda.empty_cache()
    k3 = next(kr for kr in kernels if kr["name"] == "l2nn")
    k3.update(trace_build(rt, args, dev, sizes, tree, build_wall))
    del tree
    log(f"before the LM phase: {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    lm = run_lm_path(rt, args, dev)
    check_lm_path(rt, lm)
    kernels.append(lm_kernel_check(rt, lm, args.seed))
    trace_lm(rt, lm)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
