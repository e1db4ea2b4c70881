"""Drive the PyTorch/CUDA port's main path on NVIDIA GPUs (one suffices).

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
     and the dense sweep's trace must show one l2topk kernel a wave (the
     K1 and K4 sweeps are traced over the index's first 2^22 rows, 1,024
     waves, against that sweep's untraced wall: the profiler's host-side
     recording of all 8,192 waves took some 150 s a sweep).
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
  6. the index job (``python -m repro_torch.launch.index``), after the
     search phases' tensors are dropped: ``--rows 8388605 --block-rows
     4194304`` at the sift100m widths (d 128, fanouts 256 x 256, a 2^20-row
     tree sample), two blocks of 2^22 rows, the second 4,194,301 rows, off
     the 4,096-row wave grid, in this checkout's git-ignored
     ``build/index_job`` (disk probed first, removed at the end). The CLI
     runs with ``--device cuda``, so it builds its index on ``local_mesh()``
     (one shard a visible card; J2 and J3 check that it did). J1: the
     CLI as a subprocess with ``--commit-every 1 --inject-failures``,
     SIGKILLed once the port's manifest reader sees version 1 carrying
     block 0's cursor; ``Index.open`` must show one segment of 2^22 rows and
     ``next_block`` 1. J2: the same arguments and ``--codes``, in this
     process through ``launch.index.main``: it must resume at block 1/2, run
     one append wave after one failed attempt (the injector's (1, 0)),
     index 4,194,301 rows and train codes. J4: the ids are 0..n-1 once each
     and every segment's leaves ascend; J2's segment equals, bit for bit, a
     build of the regenerated block at 1,000-row waves, block 0's segment
     (J1's child's) equals a one-shard build of block 0 on the card, and
     that block
     and the tree moved off the integer grid (where fp32 sums are not
     exact) build alike at 4,096- and 1,000-row waves; every build of the
     job ran l2nn once a 4,096-row wave, ceil(n / 4096) waves (printed
     beside the reference's snapped count). J3: ``--compact
     --verify-queries 256`` with trace and metrics files: resumed at block
     2/2, one segment of 8,388,605 rows, ``q_cap_overflow 0``, the trace read
     back. J5: Copydays on the compacted index: 127 originals of 256
     consecutive store rows (seeded), the 7 variants searched at k = 10 with
     ``Index.search(layout="point_major", impl="fused")`` and scored with
     ``vote_images``; crop10 recall@1 must reach 0.9. J2-J5 read the store
     through a per-process block cache of this script. The kernels line
     gains each kernel's launches in J2, J3 and J5 (the child's are not
     counted). If the script would pass 1,000 s, the job is cut to
     ``--rows 2097149 --block-rows 1048576`` and says so;
  7. shards (both jobs over a ``DeviceMesh``), after the index job: half
     the main path's rows, 2^23 (``scripts/shards_phase.py`` runs all
     2^24), and its 2^15 queries made again from ``--seed``,
     its tree and the codes path's codebooks; a one-shard index of them
     and its searches are the reference. Mesh A, four shards on the one
     card, and mesh B, one shard a card (S = 4, or 2 on a machine of two
     or three cards), where the machine has two cards or more. Before each
     build it prints the largest (source, destination) row count, read off
     the one-shard index, against the routing capacity. Gates: routing
     overflow 0 and ``n_valid`` summing to the rows; each shard's leaves
     ascend and its rows equal, leaf by leaf and in order, the one-shard
     index's rows of its leaf range; the K1 sweep, K2 at probes 1 and 2,
     query-routed K1 tiles (``p_cap`` pinned at 2^18, routing headroom
     4 x S: every shard routes the whole table, ROADMAP R5), the K4 sweep
     and K5, each codes search followed by ``rerank_exact``, bit-identical
     (ids and distances) to the one-shard's, ``q_cap_overflow`` equal,
     ``pairs`` equal (query-routed: S times the one shard's); on every
     device of the mesh K1, K2, K3, K4 and K5 launched. Then a short
     ``Index`` over the last mesh (two appends of a quarter of the corpus,
     2^22 rows, in this
     checkout's git-ignored ``build/shards_index``, removed at the end),
     ``commit``, ``Index.open``: its probes-2 fused search equals a
     one-shard ``Index`` of the same rows (ids differing only inside exact
     ties), and ``ShardedIndex(n_shards=2)`` equals it. Prints each mesh's
     build and search walls beside the one shard's, peak memory a card,
     launches by kernel and card, the build's assignment, route and sort
     walls, and on mesh B each card's busy time and first and last event
     in a traced K1 sweep against the span over every card. The kernels line gains each
     kernel's launches over the meshes. At 2^23 rows the short ``Index``
     takes two appends of 2^21;
  8. LM serving path, after the search phases' tensors are dropped: gemma3-4b
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
     ``scaled_dot_product_attention``'s and its bound;
  9. MoE serving path, after the LM phase's tensors are dropped:
     moonshot-v1-16b-a3b at full width (d 2048, 16 heads of 128, 64
     experts top-6, expert d_ff 1408, vocab 163,840; bf16 weights drawn on
     the card from ``--seed``, a layer at a time), the same traffic as the
     LM phase with ``attn_impl="chunked"``. Timed at the deepest depth
     whose predicted peak stays under 75 GiB (48 layers, 27.72 B
     parameters): prefill tokens/s, decode ms a step, ``moe_drops`` at the
     configuration's capacity factor (1.25), peak memory; every K6 launch
     of the prefill on the tensor-core kernel at hd 128. Checked at 8
     layers (the same draw's first layers), at capacity factor 16, where
     every expert takes every token and no row can drop: (a) the chunked
     prefill against the full-attention one and (b) each decode step
     against ``forward``, both within twice the bf16 model's own rounding
     error (its full-attention prefill against the same weights in fp32;
     each run of a pair carries that error). The
     second run of each pair, and the fp32 one, run the first run's expert
     picks (a pick that flips at a near tie would otherwise send one token,
     and through attention its successors, down another path), and record
     their own: the share of tokens whose own picks differ is printed, and
     every pick that differs must be a near tie (the gap between the k-th
     and (k+1)-th router logit within twice the largest router-logit move
     that the bf16 model's own rounding makes at that layer; its ratio to
     the fp32 bound of the router product alone is printed); (c) the routed
     variant over four shards of the card against the global one: the
     picks bit-identical, the logits within that error, and both
     variants' drops at the configuration's factor (the routed count by
     the reference's rule, beside the rows it really dropped); (d) layer
     0's expert outputs of 256 tokens against float64 given the card's
     picks and gates, within a first-order bound of the bf16 roundings,
     which a variant with a wrong expert breaks; (e) K6 against its plain
     version on layer 0's q, k, v within ``attention_bf16_tol``, and
     timed beside ``scaled_dot_product_attention`` and its bound;
 10. training, after the MoE phase's tensors are dropped: internlm2-1.8b at
     full width and depth (24 layers, 1,699,579,904 parameters, fp32 master
     weights drawn on the card from ``--seed``), bf16 compute,
     ``remat="dots"``, ``attn_impl="chunked"`` (K6's forward and its kernel
     backward in every layer: bf16 at hd 128 takes the tensor-core
     ``csrc/flashattn_bwd_tc.cu``), the ``train_4k``
     step (AdamW, weight decay 0.1, no compression) at seq 4096 with the
     batch cut from 256 to 4 in 2 microbatches, tokens from ``lm_batch``.
     Steps 0-6: step 0 reads, through autograd hooks, every leaf's gradient
     and layer 0's K6 output gradient and (dq, dk, dv), step 1 is traced
     (device time by kernel), steps 2-4 are timed (ms a step, tokens/s,
     peak memory) and counted (K6 backward launches = 24 layers x 2
     microbatches a step, every one on the tensor-core kernel), steps 5-6
     are (d)'s. Checks: (a) step 0's loss
     and gradients at 4 layers of the same draw, chunked against full
     attention, within the bf16 model's own error against fp32 (the loss
     within it, each leaf's L2 error within twice it), and the same
     model in fp32 with chunked attention (K6's CUDA-core forward and
     backward, counted: the CUDA-core backward row's launches) within a
     hundredth of that error against fp32 full attention; (b) the K6 backward
     against ``flash_attention_bwd_ref`` on layer 0's inputs (q, k, v, out
     and lse from a one-layer forward of the same weights; the kernel on
     them must give the step's own dq, dk, dv bit for bit) and at
     gemma3-4b's local-layer shape (hd 256, window 1024, seeded): both
     variants (tensor-core and CUDA-core, forced) and the plain backward
     within ``fp32_bound.attention_grads_f64``'s bf16 tolerance, broken
     plain variants (diagonal, window, GQA map off by one; dk not summed
     over the group) outside it, fp32 copies within the fp32 bound, which
     TF32 must break, two runs of each kernel bit-identical; (c) the grad
     norm and four
     sampled leaves' params, m and v after step 0 against a float64 AdamW
     of the same gradients; (d) the state after step 4 saved through
     ``CheckpointManager`` in the reference's leaf names under the
     git-ignored ``build/train_ckpt`` (disk probed first, removed at the
     end), steps 5-6 run on in memory and again from the checkpoint
     restored into fresh tensors, both under torch's deterministic
     algorithms: losses and params bit-identical; (e) ``python -m
     repro_torch.launch.train --arch internlm2-1.8b --steps 30
     --microbatches 2 --compress bf16`` and ``examples/torch_train_lm.py``
     as subprocesses on the card while (d) restores, each exiting 0 with
     ``OK``. The kernels line gains a row for each backward variant,
     ``flashattn_bwd`` (tensor-core) and ``flashattn_bwd_cuda_core``, both
     timed at the step's layer shape beside the plain version and
     ``scaled_dot_product_attention``'s backward;
 11. the recsys family and GIN, after the train phase's tensors are
     dropped (``scripts/recsys_phase.py`` runs it alone): dlrm-rm2 (26 x 1M
     x 64 tables, 1.66 G parameters), din and dien (a 10M x 18 item table;
     DIEN's GRU and AUGRU over 100 steps) and two-tower-retrieval (8 x 1M x
     64 tables, a 1024-512-256 MLP a tower), random fp32 weights drawn on
     the card from ``--seed``, at serve_p99 (512 rows), serve_bulk
     (262,144), retrieval_cand (1M candidates; DIN and DIEN in calls of
     262,144 rows) and train_batch (65,536 rows; two-tower's cut to 32,768,
     its (B, B) logits; DIEN's GRU states kept every 10 steps and the rest
     recomputed); then gin-tu at full_graph_sm, minibatch_lg (1,024 seeds,
     fanouts 15 x 10, on a Reddit-scale graph of 232,965 nodes and mean
     degree 492), ogb_products (2,449,029 nodes, 60.6M edges, full batch)
     and molecule, at their padded sizes, its message passing on the
     segsum kernel (``csrc/segsum.cu``). Batches from the port's numpy
     generators, or their distributions drawn on the card where numpy's
     Zipf sampler would take seconds. Checks: (a) 256 sampled rows of every
     serve shape's fp32 output within 1e-4 x max(1, |output|) of the same
     function in float64 (TF32's error printed beside it); (b) every train
     step, run twice from fresh states under torch's deterministic
     algorithms, gives the same params, m and v bit for bit; (c) every
     loss, grad norm and output finite; (d) two-tower's 1M item embeddings
     (d = 256) through ``build_tree`` (32 x 32, Lloyd-refined twice),
     ``build_index`` (fp32 wire) and ``batch_search`` of 1,024 users, k 10,
     probes 1 and 3, ``impl="pallas"`` (K1) and ``"fused"`` (K2): overflow
     0, the two bit-identical, each user's ids a float64 brute force over
     the leaves it probed (up to ties fp32 cannot order) with distances
     within fp32's bound of the float64 ones (P1's 1e-6 x ||q||^2 printed
     beside it), recall@10 against the exact dense top-10 printed; (e) K1
     on one wave, K2 on the fused call and K3 on a build wave at d = 256
     within ``fp32_bound``'s bound, which TF32 breaks, and segsum at
     ogb_products' shape within ``fp32_bound.segsum_f64``'s bound,
     bit-identical over two runs, each order's items pass and long rows'
     tree timed apart with CUDA events. Prints each shape's wall and device ms,
     samples/s, TFLOP/s, peak memory and top device ops; the K1, K2 and K3
     rows gain the retrieval path's numbers, and a ``segsum`` row joins the
     kernels line;
 12. the cell registry's dry-run (``python -m repro_torch.launch.dryrun``,
     after the recsys phase): ``--list`` (11 architectures, 44 cells), the
     abstract records of all 44 cells on ``16x16``, ``2x16x16`` and the
     card (how many fit one card whole), then the measured records of
     llama3.2-3b ``prefill_32k`` at batch 1 of 32 (32,768 tokens through
     K6 in every layer: its first run on the card), llama3.2-3b
     ``decode_32k`` at the batch its KV cache allows, gin-tu ``molecule``
     and sift100m ``search_32k`` (its corpus cut from 2^28 to 2^24 rows,
     made on the card from the seed), each measured in a process of its
     own as ``dryrun --all`` measures it (late in this one the profiler
     loses the hand-written kernels' events), each a JSON line with its
     roofline, peak memory, top device ops and launches in the traced
     step; then K6 at 32,768 tokens held against its plain version (a GQA
     group and 4,096 query rows at a time, within the bf16 tolerance,
     with two broken plain variants that must fail) and timed alone
     beside its bound, the plain version and
     ``scaled_dot_product_attention``.
     Past ``DR_LATEST_START_S`` only the abstract records and gin-tu
     ``molecule`` run (printed as a cut);
 13. the port's examples as subprocesses on the card:
     ``examples/torch_quickstart.py`` and ``examples/torch_copydays_eval.py``
     (crop10 recall@1 at least 0.9).

Prints one JSON line of per-kernel numbers, then as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when no CUDA device is present or any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import importlib.util
import io
import json
import math
import os
import shutil
import signal
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
TRACE_SHARE = 8  # the traced K1 and K4 sweeps cover the index's first 1/8
N_REAL_WAVES = 8  # l2topk waves of the real-valued check
# csrc/fusedscan.cu: rows of a group tile, runs split across a cluster past
F_G, F_LONG = 8, 4096
# the P7 phase: a k and a rerank depth past the KCAP kernels' lists (64, 128),
# then one past the wide range's lists of 256 (dense and codes)
P7_K, P7_RERANK = 100, 256
P7_BLOCK_K = 512
# the route each of the P7 phase's calls takes (kernels/l2topk/ops.py route),
# by depth: K1, K2 and K5 on their own kernels with lists of 256 up to 256,
# K4 past 128 and every kernel past 256 on widetopk.cu's block list kernel
P7_ROUTES = {"wide": {"l2topk": "wide_lists", "fusedscan": "wide_lists",
                      "adcscan": "block_list", "fusedadc": "wide_lists"},
             "block": dict.fromkeys(("l2topk", "fusedscan", "adcscan", "fusedadc"),
                                    "block_list")}
P7_SOURCES = {"l2topk": "l2topk.cu", "fusedscan": "fusedscan.cu",
              "adcscan": "adcscan.cu", "fusedadc": "adcscan.cu (adcscan_kernel<true>)"}
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
SV_CAL_DISPATCHES = 1  # recorded dispatches of each calibrating session
SV_TRACE = Path(__file__).resolve().parent / "build" / "serving_trace.json"
SV_CLI = ("--rows", "200000", "--dim", "128", "--images", "2000", "--fanout",
          "32", "32", "--trace", "zipf", "--requests", "500")
# the index-job phase: python -m repro_torch.launch.index at the sift100m
# widths, two blocks of 2^22 descriptors, the second off the 4,096-row wave
# grid (4,194,301 rows); crashed, resumed, compacted and verified in a
# directory of this checkout's git-ignored build/, which the phase removes
JOB_DIR = Path(__file__).resolve().parent / "build" / "index_job"
JOB_ROWS, JOB_BLOCK = 8388605, 2**22
# the cut, if the script would pass JOB_LATEST_END_S: the crash on a 2^20-row
# first block, then one off-grid block of 1,048,573 rows
JOB_CUT_ROWS, JOB_CUT_BLOCK = 2097149, 2**20
JOB_BUDGET_S = 150  # the phase's time budget
JOB_AFTER_S = 340  # the phases after it: shards, LM, MoE, train, recsys, dryrun, examples
JOB_LATEST_END_S = 1000  # the script's end past which the job is cut
JOB_VERIFY = 256  # --verify-queries of the compaction run
JOB_CRASH_WAIT_S = 300  # how long J1 waits for the first commit
CD_ORIGINALS = 127  # the paper's Copydays originals
CD_K = 10
CD_CROP10_MIN = 0.9  # tests/test_system.py's bar for the mildest variant
# the shards phase (both jobs over a mesh; after the index job)
SH_SHARDS = 4  # mesh A: four shards on the one card
SH_CUT_ROWS = 2**23  # its corpus here (scripts/shards_phase.py: 2^24)
SH_LATEST_START_S = 930  # past it the phase runs at SH_CUT_ROWS whatever it was given
SH_BUDGET_S = 120
SH_LC_SHARE = 4  # the short Index's two appends: a quarter of the corpus each
# the query-routed point slab, pinned alike at every shard count: what
# plan() gives the one-shard index of 2^24 rows (its query tiles then
# never overflow), and no more than a shard holds at S = 4
SH_P_CAP = 2**18
# the query-routed routing headroom: every shard routes the whole lookup
# table (ROADMAP R5), so a (source, destination) pair must hold the
# destination's whole share: the default 4.0 at one shard, times S
SH_Q_FACTOR = 4.0 * SH_SHARDS
SH_DIR = Path(__file__).resolve().parent / "build" / "shards_index"
SH_KERNELS = ("l2topk", "fusedscan", "l2nn", "adcscan", "fusedadc")

SIZES = dict(index_rows=INDEX_ROWS, n_queries=N_QUERIES, sample_rows=SAMPLE_ROWS,
             fanouts=FANOUTS, k=K, q_cap=Q_CAP, block_rows=BLOCK_ROWS,
             k1_waves=K1_WAVES, n_sample=N_SAMPLE, lc_appends=LC_APPENDS,
             n_leaves=FANOUTS[0] * FANOUTS[1])
# PQ codes at the JAX package's defaults (Index.enable_codes)
PQ = dict(m=8, bits=8, sample=65_536, iters=16, seed=0)


def _port_module(name: str):
    """``src/repro_torch/launch/<name>.py`` of this checkout, loaded from its
    file alone (it imports torch only), so that ``Port(src=...)`` may still
    import another checkout's package."""
    path = Path(__file__).resolve().parent / "src" / "repro_torch" / "launch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_chip_smoke_{name}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclasses look their module up
    spec.loader.exec_module(module)
    return module


# the one set of H100 peaks and timing helpers (launch/roofline.py) and the
# trace helpers (launch/trace_cost.py)
_roofline, _trace_cost = _port_module("roofline"), _port_module("trace_cost")
HBM_BYTES_PER_S = _roofline.HBM_BW
FP32_FLOPS = _roofline.PEAK_FLOPS_FP32
BF16_FLOPS = _roofline.PEAK_FLOPS_BF16
time_ms, bound = _roofline.time_ms, _roofline.bound
device_trace = _trace_cost.device_trace
# LM serving phase: gemma3-4b, 4 prompts of 2048 tokens, 32 decode steps
LM_BATCH = 4
LM_PROMPT = 2048
LM_DECODE = 32
LM_CHECK_LAYERS = (0, 5)  # one local (window 1024), one global layer
MOE_BUDGET_S = 90
MOE_PEAK_LIMIT_GIB = 75.0  # the timed model's depth is cut to stay under it
MOE_CHECK_LAYERS = 8  # the checks' depth (its fp32 copy is about 18 GB)
MOE_CHECK_CF = 16.0  # the checks' capacity factor: every expert takes every token
MOE_SHARDS = 4  # (c): the routed variant over four shards of the one card
MOE_ORACLE_TOKENS = 256  # (d): layer 0's tokens held against float64
# the train phase: internlm2-1.8b, the train_4k step cut to 4 sequences
TR_BATCH = 4  # train_4k's batch of 256 sequences, cut
TR_SEQ = 4096
TR_MICRO = 2
TR_STEPS = 5  # steps 0..4: 0 carries (b)'s and (c)'s captures, 1 is traced, 2-4 timed
TR_RESUME_STEPS = 2  # (d): saved after step 4; steps 5-6 run on, then again resumed
TR_CHECK_LAYERS = 4  # (a)'s depth
TR_BUDGET_S = 120
TR_LATEST_END_S = 1050  # past it, the timed steps are cut to the last two
TR_DIR = Path(__file__).resolve().parent / "build" / "train_ckpt"
TR_SAMPLED = ("embed", "final_norm", "layers/wq", "layers/w_down")  # (c)
TR_GEMMA_LOCAL = dict(B=1, S=2048, Hq=8, Hkv=4, hd=256, window=1024)  # (b)
# the recsys phase: DLRM-rm2, DIN, DIEN, two-tower (its 1M candidates
# through the index) and GIN-tu, at full width
RS_BUDGET_S = 100
RS_AFTER_S = 30  # the examples after it
RS_LATEST_END_S = 1100  # past it: one timed step a train shape, not two
RS_SAMPLED = 256  # (a)'s output rows held against float64; K2's plain rows
# (a): |fp32 - float64| <= RS_LIMIT_U x 2^-24 x max(1, largest |float64 output|),
# and TF32 must exceed it. A limit a configuration, near the geometric mean
# of its largest fp32 and smallest TF32 reading (4.8 / 2,213, 1.2 / 897,
# 0.041 / 62.6 and 2.1 / 1,438 of that unit over its three serve shapes):
# a worst-case fp32 bound grows with the sum of |terms| through each MLP,
# where TF32's errors cancel, and would pass TF32.
RS_LIMIT_U = {"dlrm-rm2": 128, "din": 32, "dien": 2, "two-tower-retrieval": 64}
RS_TRACES = False  # device_ms and top ops: the phase run alone sets it (see recsys_phase)
RS_TT_TRAIN_B = 32768  # two-tower's train_batch, cut from 65,536: its (B, B) logits
RS_CHUNK = 262144  # rows a DIN or DIEN forward call (retrieval_cand in 4 calls)
RS_USERS = 1024  # (d): users searched through the index, a serving batch
RS_FANOUTS = (32, 32)  # (d): about 980 candidates a leaf
RS_K = 10
RS_PROBES = (1, 3)
RS_Q_CAP = 4096  # (d): the lookup slab of a wave (benchmarks/ann_retrieval.py's)
RS_F64_ROWS = 2**17  # index rows a chunk of (d)'s float64 brute force
RS_MAX_SWAPS = 16  # (d): ids out of the float64 order, each within fp32's bounds (0-4 read)
# the dryrun phase: the cell registry, its abstract records and four cells
# measured (arch, shape, batch: None for the card cut), one step traced
DR_CELLS = (("llama3.2-3b", "prefill_32k", 1), ("llama3.2-3b", "decode_32k", None),
            ("gin-tu", "molecule", None), ("sift100m", "search_32k", None))
DR_CUT_CELLS = (("gin-tu", "molecule", None),)  # past DR_LATEST_START_S
DR_STEPS = 2  # timed steps a cell
DR_BUDGET_S = 90
DR_LATEST_START_S = 1050
# each measured cell's kernels, and the launches one traced step must show
DR_KERNELS = {"prefill_32k": {"flashattn": 28}, "molecule": {"segsum": None},
              "search_32k": {"fusedscan": 1}}


T0 = time.perf_counter()  # the script's start, for the lines' time stamps


def log(msg: str) -> None:
    """One line of output, after the seconds since the script started
    (a JSON object stays a line of its own)."""
    print(msg if msg.startswith("{") else
          f"[{time.perf_counter() - T0:7.1f} s] {msg}", flush=True)


def sync_now() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


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


def make_queries(corpus, n: int, seed: int):
    """Copy-detection queries: ``n`` indexed descriptors under a small
    distortion (each coordinate moved by -4..4, kept in [0, 255]: still
    integers), drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed + 1)
    src = torch.randint(0, corpus.shape[0], (n,), generator=g)
    noise = torch.randint(-4, 5, (n, DIM), generator=g)
    dev = corpus.device
    return (corpus[src.to(dev)] + noise.to(dev)).clamp(0, 255).contiguous()


def run_main_path(rt, args, dev, sizes):
    """Drive build_tree -> build_index -> batch_search; return what the
    checks and the kernel phase need."""
    mix = rt.synth.make_mixture(256, DIM, seed=args.seed)
    t0 = sync_now()
    corpus = make_corpus(rt, sizes["index_rows"], args.seed, dev, mix)
    queries = make_queries(corpus, sizes["n_queries"], args.seed)
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


def p7_source(key, name):
    """The source of the kernel that P7's ``key`` calls of ``name`` run."""
    if P7_ROUTES[key][name] == "wide_lists":
        return f"src/repro_torch/csrc/{P7_SOURCES[name]} (KCAP 256)"
    return "src/repro_torch/csrc/widetopk.cu (block list)"


def p7_phase(rt, run, sizes, seed, kernels):
    """Every k the plan accepts, on the card (ROADMAP P7): ``batch_search``
    at k = P7_K and a codes search at rerank P7_RERANK, past the KCAP
    kernels' lists (64, 128), then both at P7_BLOCK_K, past the wide
    range's lists of 256, each call on the route ``P7_ROUTES`` gives it
    (its launches counted by route). Checks the sweep and the fused scan
    bit-identical, their launches, the k = 20 results as a prefix, in-leaf
    top-1 exactness, and the kernels against their plain versions (real
    waves, sampled lookup rows of the fused calls); puts their times, and
    K1's and K4's library yardsticks (addmm + where + topk, gather + sum +
    where + topk), on the K1, K2, K4 and K5 rows as ``wide_*`` (k = P7_K,
    rerank P7_RERANK) and ``block_*`` (P7_BLOCK_K) fields."""
    rows = {row["name"]: row for row in kernels}
    for key, k, r in (("wide", P7_K, P7_RERANK), ("block", P7_BLOCK_K, P7_BLOCK_K)):
        p7_dense(rt, run, sizes, rows, key, k, seed)
        p7_codes(rt, run, sizes, rows, key, r, seed)


def p7_launches(rt, key, names, n_waves):
    """The launches of the search just run, checked against its waves and
    ``P7_ROUTES``: every launch of each kernel on the route of ``key``."""
    launches = rt.counts()
    want = {}
    for name, n in zip(names, (n_waves, 1)):
        want[name] = want[f"{name}.{P7_ROUTES[key][name]}"] = n
    if any(launches[name] != v for name, v in want.items()):
        raise AssertionError(f"p7 {key}: launches {json.dumps(launches)}, expected "
                             f"{json.dumps(want)}")
    return launches


def p7_dense(rt, run, sizes, rows, key, k, seed):
    """P7's dense calls at ``k``: ``batch_search`` on both paths, then K1 on
    the real waves and K2 on the fused call against their plain versions;
    the ``<key>_*`` fields of the l2topk and fusedscan rows."""
    index, tree, queries = run["index"], run["tree"], run["queries"]
    dev, B, qc, d = index.vecs.device, sizes["block_rows"], sizes["q_cap"], DIM
    n, n_waves = queries.shape[0], index.rows // B
    res, wall = {}, {}
    rt.reset_counts()
    for impl in ("pallas", "fused"):
        t0 = sync_now()
        res[impl] = rt.batch_search(index, tree, queries, k, q_cap=qc, block_rows=B,
                                    impl=impl, device=dev)
        wall[impl] = sync_now() - t0
    launches = p7_launches(rt, key, ("l2topk", "fusedscan"), n_waves)
    a, b = res["pallas"], res["fused"]
    for name, r in res.items():
        if int(r.q_cap_overflow) != 0 or r.ids.shape != (n, k):
            raise AssertionError(f"p7 {name}: overflow {int(r.q_cap_overflow)}, "
                                 f"shape {tuple(r.ids.shape)}")
    if not (torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
            and torch.equal(a.pairs, b.pairs)):
        raise AssertionError(f"p7: the sweep and the fused scan differ at k = {k}")
    k20 = run["results"]["pallas"]
    if not (torch.equal(a.ids[:, :sizes["k"]], k20.ids)
            and torch.equal(a.dists[:, :sizes["k"]], k20.dists)):
        raise AssertionError(f"p7: the k = {sizes['k']} results are not the first "
                             f"columns of the k = {k} results")
    pick, _, _, qleaf = run["nn"]
    exact = in_leaf_top1(index, queries[pick], qleaf, a.ids[pick, 0])
    del res, a, b

    # the kernels at the shapes the two paths gave them
    lk = rt.build_lookup(tree, queries, probes=1)
    waves, _ = dense_waves(run, sizes, lk)
    err = max(bitwise(rt.l2_topk(*w, k=k), rt.l2_topk_ref(*w, k), f"l2topk {key}")
              for w in waves)
    kern = time_ms(lambda *w: rt.l2_topk(*w, k=k), waves)
    plain = time_ms(lambda *w: rt.l2_topk_ref(*w, k), waves)

    def lib_topk(p, plf, q, qlf):  # the library yardstick, never called by the port
        d2 = torch.where(qlf[:, None] == plf[None, :],
                         torch.addmm((p * p).sum(1)[None, :], q, p.T, alpha=-2.0),
                         torch.inf)
        return torch.topk(d2, k, dim=1, largest=False)

    lib = time_ms(lib_topk, waves)
    need = sum(int(torch.isin(w[1], w[3]).sum()) for w in waves)
    matched = sum(int(torch.isin(w[3], w[1]).sum()) for w in waves)
    pairs = sum(int(rt.count_pairs(w[1], w[3])) for w in waves)
    nw = len(waves)
    bnd = bound(((need + matched) * d * 4 + nw * ((B + qc) * 4 + qc * k * 8)) / nw,
                (pairs + need) * 2 * d / nw)
    rows["l2topk"].update({
        f"{key}_k": k, f"{key}_route": P7_ROUTES[key]["l2topk"],
        f"{key}_source": p7_source(key, "l2topk"), f"{key}_ms": kern[0],
        f"{key}_plain_ms": plain[0], f"{key}_library_ms": lib[0],
        f"{key}_bound_ms": bnd[0], f"{key}_bound_by": bnd[1],
        f"{key}_launches": launches[f"l2topk.{P7_ROUTES[key]['l2topk']}"],
        f"{key}_max_abs_err": err, f"{key}_search_wall_s": wall["pallas"]})
    flk, full = fused_inputs(rt, run, sizes, lk)
    kd, ki = rt.fused_topk(*full, k=k)
    fpick = sample_rows(flk, sizes["n_sample"], seed + 5)
    sq, sl = flk.vecs[fpick], flk.leaves[fpick]

    def plain_sample(q, qlf):
        return rt.map_ids(*chunked_plain(rt, index.vecs, index.leaves, q, qlf, k),
                          index.ids)

    err = bitwise((kd[fpick], ki[fpick]), plain_sample(sq, sl), f"fusedscan {key}")
    del kd, ki
    kern = fused_time(rt, full, k)
    plain = time_ms(plain_sample, [(sq, sl)], warmup=1)
    need, pairs, Q = fused_need(index, flk)
    bnd = fused_bound(need, pairs, Q, d, k)
    rows["fusedscan"].update({
        f"{key}_k": k, f"{key}_route": P7_ROUTES[key]["fusedscan"],
        f"{key}_source": p7_source(key, "fusedscan"), f"{key}_ms": kern[0],
        f"{key}_plain_ms": plain[0], f"{key}_plain_rows": fpick.numel(),
        f"{key}_library_ms": None, f"{key}_bound_ms": bnd[0],
        f"{key}_bound_by": bnd[1],
        f"{key}_launches": launches[f"fusedscan.{P7_ROUTES[key]['fusedscan']}"],
        f"{key}_max_abs_err": err, f"{key}_search_wall_s": wall["fused"]})
    log(f"p7 dense at k = {k}: batch_search pallas {wall['pallas']} s, fused "
        f"{wall['fused']} s, bit-identical; the k = {sizes['k']} results their "
        f"prefix; in-leaf top-1 exact {exact}/{pick.numel()}; launches "
        f"{json.dumps(launches)}; l2topk {rows['l2topk'][f'{key}_ms']} ms a wave "
        f"(library {rows['l2topk'][f'{key}_library_ms']} ms), fusedscan {kern[0]} ms")


def p7_codes(rt, run, sizes, rows, key, r, seed):
    """P7's codes calls at rerank ``r``: a codes search on both paths, then
    K4 on the real waves and K5 on the fused call against their plain
    versions; the ``<key>_*`` fields of the adcscan and fusedadc rows."""
    index, tree, queries = run["index"], run["tree"], run["queries"]
    dev, B, qc = index.vecs.device, sizes["block_rows"], sizes["q_cap"]
    n, n_waves = queries.shape[0], index.rows // B
    c = run["codes"]
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
    launches = p7_launches(rt, key, ("adcscan", "fusedadc"), n_waves)
    a, b = cand["pallas"], cand["fused"]
    if int(a.q_cap_overflow) != 0 or a.ids.shape != (n, r):
        raise AssertionError(f"p7 codes: overflow {int(a.q_cap_overflow)}, shape "
                             f"{tuple(a.ids.shape)}")
    if not (torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
            and torch.equal(a.pairs, b.pairs)):
        raise AssertionError(f"p7: adcscan and fusedadc paths differ at rerank {r}")
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
                    rt.adc_topk_ref(*sw, r), f"adcscan {key}")
              for (cd, plf, ids, start), sw in zip(ci["waves"], ci["slabs"]))
    kern = k4_time(rt, ci, r)
    plain = time_ms(lambda *w: rt.adc_topk_ref(*w, r), ci["slabs"])
    offs = torch.arange(m, device=dev) * C

    def lib_adc(cd, plf, lt, ql):  # the library yardstick, never called by the port
        d2 = lt.reshape(lt.shape[0], m * C)[:, (cd.long() + offs).view(-1)]
        d2 = torch.where(ql[:, None] == plf[None, :],
                         d2.view(lt.shape[0], -1, m).sum(-1), torch.inf)
        return torch.topk(d2, r, dim=1, largest=False)

    lib = time_ms(lib_adc, ci["slabs"])
    bnd = k4_bound(ci, B, qc, m, C, r)
    rows["adcscan"].update({
        f"{key}_k": r, f"{key}_route": P7_ROUTES[key]["adcscan"],
        f"{key}_source": p7_source(key, "adcscan"), f"{key}_ms": kern[0],
        f"{key}_plain_ms": plain[0], f"{key}_library_ms": lib[0],
        f"{key}_bound_ms": bnd[0], f"{key}_bound_by": bnd[1],
        f"{key}_launches": launches[f"adcscan.{P7_ROUTES[key]['adcscan']}"],
        f"{key}_max_abs_err": err, f"{key}_search_wall_s": wall["pallas"]})
    kd, ki = rt.fused_adc_topk(*ci["full"], k=r)
    fpick = sample_rows(ci["flk"], sizes["n_sample"], seed + 6)
    sq, sl = lut[fpick], qlf[fpick]

    def plain_adc(lt, ql):
        return adc_plain_sample(rt, run, ci["live"], lt, ql, r)

    err = bitwise((kd[fpick], ki[fpick]), plain_adc(sq, sl), f"fusedadc {key}")
    del kd, ki
    kern = k5_time(rt, ci, r)
    plain = time_ms(plain_adc, [(sq, sl)], warmup=1)
    bnd, _ = k5_bound(ci, index, m, C, r)
    rows["fusedadc"].update({
        f"{key}_k": r, f"{key}_route": P7_ROUTES[key]["fusedadc"],
        f"{key}_source": p7_source(key, "fusedadc"), f"{key}_ms": kern[0],
        f"{key}_plain_ms": plain[0], f"{key}_plain_rows": fpick.numel(),
        f"{key}_library_ms": None, f"{key}_bound_ms": bnd[0],
        f"{key}_bound_by": bnd[1],
        f"{key}_launches": launches[f"fusedadc.{P7_ROUTES[key]['fusedadc']}"],
        f"{key}_max_abs_err": err, f"{key}_search_wall_s": wall["fused"]})
    log(f"p7 codes at rerank {r}: pallas {wall['pallas']} s, fused {wall['fused']} s, "
        f"bit-identical; the rerank {w128} candidates their prefix; launches "
        f"{json.dumps(launches)}; adcscan {rows['adcscan'][f'{key}_ms']} ms a wave "
        f"(library {rows['adcscan'][f'{key}_library_ms']} ms), fusedadc {kern[0]} ms")


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
    (routed,) = rt.route.route_by_leaf(
        [lk.vecs], [lk.qids], [lk.leaves], n_shards=1,
        leaves_per_shard=seg.n_leaves, capacity=cap, wire_dtype=p.wire_dtype,
        mesh=rt.DeviceMesh((lk.vecs.device,)))
    qv, _, ql, _, n_valid = rt.route.cluster_sort(
        routed, leaf_base=0, leaves_per_shard=seg.n_leaves, dtype=lk.vecs.dtype)
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


def leaf_prefix(index, rows: int):
    """The leaf-sorted index's first ``rows`` rows as an index of their
    own (the leaves past them hold no rows): a sweep of it runs the main
    path's plan over ``rows / block_rows`` of its waves."""
    ids = index.ids[:rows]
    return dataclasses.replace(
        index, vecs=index.vecs[:rows], ids=ids, leaves=index.leaves[:rows],
        offsets=index.offsets.clamp(max=rows),
        n_valid=(ids >= 0).sum().to(index.n_valid.dtype).reshape(index.n_valid.shape))


def traced_wall(fn):
    """(device events, busy s, untraced wall s) of ``fn``: timed once, then
    traced."""
    t0 = sync_now()
    fn()
    wall = sync_now() - t0
    ev, busy = device_trace(fn)
    return ev, busy, wall


def trace_sweep(rt, run, sizes):
    """Trace one dense sweep (``batch_search`` impl="pallas") over the
    index's first 1 / TRACE_SHARE (the profiler's host-side recording of
    the whole 8,192-wave sweep took 150 s), log its top device operations
    against the same sweep's untraced wall time and return ({l2topk
    kernel: [device ms, launches]}, device busy s, wall s, waves)."""
    sub = leaf_prefix(run["index"], run["index"].rows // TRACE_SHARE)
    ev, busy, wall = traced_wall(lambda: rt.batch_search(
        sub, run["tree"], run["queries"], sizes["k"], q_cap=sizes["q_cap"],
        block_rows=sizes["block_rows"], impl="pallas", device=sub.device))
    log_trace(f"pallas (the first {sub.rows} index rows)", ev, busy, wall, 5)
    return ({e.key: [e.self_device_time_total / 1e3, e.count]
             for e in ev if "l2topk" in e.key}, busy, wall,
            sub.rows // sizes["block_rows"])


def trace_searches(rt, run, sizes):
    """Device busy time of each search path (``torch.profiler``), against
    the wall time of the same search in the main-path run."""
    index, tree, queries = run["index"], run["tree"], run["queries"]
    codes = run["codes"]
    # the sweep's K1 launches: one l2topk_kernel a wave and no other
    # l2topk kernel
    k1, busy, wall, n_waves = trace_sweep(rt, run, sizes)
    n = sum(c for _, c in k1.values())
    if n != n_waves or any("l2topk_kernel" not in key for key in k1):
        raise AssertionError(f"dense sweep trace: l2topk kernels "
                             f"{sorted(k1)} x{n} for {n_waves} waves")
    run["sweep_trace"] = dict(
        sweep_trace_ms=sum(ms for ms, _ in k1.values()), sweep_trace_launches=n,
        sweep_busy_s=busy, sweep_wall_s=wall, sweep_trace_waves=n_waves,
        sweep_trace_share=1 / TRACE_SHARE)

    def dense(impl, probes):
        rt.batch_search(index, tree, queries, sizes["k"], probes=probes,
                        q_cap=sizes["q_cap"], block_rows=sizes["block_rows"],
                        impl=impl, device=index.device)

    def scan_codes(impl, probes, rows=index.rows):
        r = codes["results"][impl if probes == 1 else "fused_p2"]
        lookup = rt.build_lookup(tree, queries, probes=probes)
        rt.search_with_lookup(leaf_prefix(index, rows), lookup, r["plan"],
                              n_queries=queries.shape[0],
                              codes=codes["codes"][:rows],
                              codebooks=codes["pq"].codebooks)

    # the codes sweep over the index's first 1 / TRACE_SHARE, as the dense one
    sub_rows = index.rows // TRACE_SHARE
    ev, busy, wall = traced_wall(lambda: scan_codes("pallas", 1, sub_rows))
    log_trace(f"codes pallas (the first {sub_rows} index rows)", ev, busy, wall, 5)
    for name, search, impl, probes, wall, key, kernel in (
            ("fused", dense, "fused", 1, run["times"]["fused"], "fused_trace",
             "fusedscan"),
            ("fused p2", dense, "fused", 2, run["times"]["fused_p2"], "fused_trace_p2",
             "fusedscan"),
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


def log_trace(name, ev, busy, wall, n_top):
    log(_trace_cost.top_ops_line(name, ev, busy, wall, n_top))


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


# ---------------------------------------------------------------------------
# the index-job phase (python -m repro_torch.launch.index)
# ---------------------------------------------------------------------------


def job_argv(rows, block, seed, dev):
    return ["--rows", str(rows), "--dim", str(DIM), "--block-rows", str(block),
            "--fanout", *map(str, FANOUTS), "--tree-sample", str(SAMPLE_ROWS),
            "--seed", str(seed), "--index-dir", str(JOB_DIR), "--device", dev.type]


def job_crash(rt, argv):
    """J1: the CLI as a subprocess; once the manifest of version 1 carrying
    block 0's cursor is published (read with the port's manifest reader),
    SIGKILL. Returns (wall s, the child's last lines)."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    out_path = JOB_DIR / "crash.log"  # removed with the directory
    t0 = time.perf_counter()
    with open(out_path, "w") as out:
        p = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.index",
                              *argv], stdout=out, stderr=subprocess.STDOUT,
                             env=env, cwd=str(Path(__file__).resolve().parent))
        try:
            while True:
                m = rt.manifest_latest(str(JOB_DIR))
                if (m is not None and m.version >= 1
                        and (m.meta.get("ingest") or {}).get("next_block") == 1):
                    break
                if p.poll() is not None:
                    raise AssertionError(
                        f"J1: the job exited {p.returncode} before its first "
                        f"commit:\n{out_path.read_text()[-4000:]}")
                if time.perf_counter() - t0 > JOB_CRASH_WAIT_S:
                    raise AssertionError(f"J1: no commit in {JOB_CRASH_WAIT_S} s")
                time.sleep(0.05)
            p.send_signal(signal.SIGKILL)
            p.wait(timeout=60)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    wall = time.perf_counter() - t0
    if p.returncode != -signal.SIGKILL:
        raise AssertionError(f"J1: the job ended with {p.returncode}, not SIGKILL")
    return wall, out_path.read_text().strip().splitlines()


@contextlib.contextmanager
def cached_blocks(cls, store, prefetch):
    """``cls.read_block`` through a per-process cache: each block of a
    store is generated once however often the job, the verification and
    the checks read it, and the blocks ``prefetch`` of ``store`` are
    generated in a thread from the start (while J1's child runs). A
    wrapper of this script's, not of the package."""
    real = cls.read_block
    cache = {}

    def key(st, b):
        return (st.seed, st.n_rows, st.dim, st.block_rows, b)

    def read_block(self, b):
        k = key(self, b)
        if k not in cache:
            cache[k] = pool.submit(real, self, b)
        return cache[k].result()

    with ThreadPoolExecutor(max_workers=1) as pool:
        for b in prefetch:
            cache[key(store, b)] = pool.submit(real, store, b)
        cls.read_block = read_block
        try:
            yield
        finally:
            cls.read_block = real


def job_run(rt, argv, name, launches, builds):
    """One in-process ``launch.index.main(argv)``: its printed lines, its
    launches added to ``launches``, each ``build_index`` it ran (rows,
    l2nn launches) appended to ``builds``. Raises unless it returns 0."""
    real = rt.lifecycle.build_index

    def counted(vecs, tree, **kw):
        before = rt.wrappers["l2nn"].launches
        out = real(vecs, tree, **kw)
        builds.append((int(vecs.shape[0]), rt.wrappers["l2nn"].launches - before))
        return out

    real_mesh = rt.meshutil.local_mesh

    def local_mesh(device="cuda"):
        mesh = real_mesh(device)
        meshes.append(mesh)
        return mesh

    buf, meshes = io.StringIO(), []
    rt.reset_counts()
    rt.lifecycle.build_index = counted
    rt.meshutil.local_mesh = local_mesh
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = rt.index_cli.main(argv)
    finally:
        rt.lifecycle.build_index = real
        rt.meshutil.local_mesh = real_mesh
    wall = time.perf_counter() - t0
    for key, n in rt.counts().items():
        launches[key] = launches.get(key, 0) + n
    rt.reset_counts()
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(f"index job {name}: {line}")
    if rc != 0:
        raise AssertionError(f"index job {name}: exit {rc}")
    asked = argv[argv.index("--device") + 1]
    if len(meshes) != 1 or meshes[0] != real_mesh(asked):
        raise AssertionError(f"index job {name}: the CLI built {meshes}, not "
                             "local_mesh()")
    log(f"index job {name}: the CLI ran on local_mesh(): "
        f"{meshes[0].n_shards} shard(s) on {[str(d) for d in meshes[0].devices]}")
    return lines, wall


def expect_lines(lines, name, *wanted):
    for w in wanted:
        if not any(w in line for line in lines):
            raise AssertionError(f"index job {name}: no line with {w!r}")


def ids_and_leaves(idx, n):
    """J4: the segments' ids are 0..n-1, each exactly once, and each
    segment's leaves ascend (padding last)."""
    ids = []
    for seg in idx.segments:
        lv = seg.index.leaves
        if not bool((lv[1:] >= lv[:-1]).all()):
            raise AssertionError(f"{seg.name}: leaves do not ascend")
        sid = seg.index.ids
        ids.append(sid[sid >= 0].long())
    ids = torch.sort(torch.cat(ids)).values
    if not torch.equal(ids, torch.arange(n, device=ids.device)):
        raise AssertionError("the index's ids are not 0..n-1, each once")


def job_copydays(rt, idx, rows, seed):
    """J5: the Copydays protocol on the compacted index: 127 originals of
    SV_DPI consecutive store rows, 7 variants searched at k = 10 (fused,
    point-major) and scored by image votes."""
    cd_mod = rt.copydays
    rng = np.random.default_rng(seed + 19)
    originals = np.sort(rng.choice(rows // SV_DPI, CD_ORIGINALS, replace=False))
    orig_rows = (originals[:, None] * SV_DPI + np.arange(SV_DPI)).reshape(-1)
    orig = idx.read_rows(torch.as_tensor(orig_rows, device=idx.device)).cpu().numpy()
    cd = cd_mod.make_copydays(orig, np.repeat(originals, SV_DPI), seed=seed)
    t0 = sync_now()
    res = idx.search(cd.query_vecs, k=CD_K, layout="point_major", impl="fused")
    wall = sync_now() - t0
    if int(res.q_cap_overflow) != 0:
        raise AssertionError("J5: q_cap overflow")
    per, avg = cd_mod.vote_images(res.ids.cpu().numpy(), np.arange(rows) // SV_DPI,
                                  cd.query_img, cd.query_variant,
                                  len(cd_mod.VARIANTS))
    recall = {name: float(r) for (name, _, _), r in zip(cd_mod.VARIANTS, per)}
    log(f"index job J5: Copydays on the compacted index: {CD_ORIGINALS} "
        f"originals of {SV_DPI} rows, {cd.query_vecs.shape[0]} query rows, "
        f"k {CD_K}, fused point-major search {wall:.3f} s; recall@1 "
        f"{json.dumps(recall)}, average {avg}")
    if recall["crop10"] < CD_CROP10_MIN:
        raise AssertionError(f"J5: crop10 recall@1 {recall['crop10']} < "
                             f"{CD_CROP10_MIN}")
    return dict(recall=recall, average=avg, search_s=wall,
                query_rows=int(cd.query_vecs.shape[0]))


def index_job_phase(rt, dev, seed, kernels, t_start):
    """The paper's index-creation job on the card through its CLI: J1 the
    crash, J2 the resume (retried failure, codes), J4's checks, J3 the
    compaction and verification, J5 Copydays; adds each kernel's launches
    of the job's own runs (J2, J3, J5) to ``kernels``."""
    t_phase = time.perf_counter()
    elapsed = t_phase - t_start
    rows, block, cut = JOB_ROWS, JOB_BLOCK, None
    if elapsed + JOB_BUDGET_S + JOB_AFTER_S > JOB_LATEST_END_S:
        rows, block = JOB_CUT_ROWS, JOB_CUT_BLOCK
        cut = (f"cut to --rows {rows} --block-rows {block}: the phase starts "
               f"at {elapsed:.0f} s, and {JOB_LATEST_END_S} s would pass")
    shutil.rmtree(JOB_DIR, ignore_errors=True)
    JOB_DIR.mkdir(parents=True)
    tail = rows - block
    times, launches, builds = {}, {}, []
    stack = contextlib.ExitStack()
    try:
        rates = disk_probe(JOB_DIR, LC_PROBE_BYTES)
        free = shutil.disk_usage(JOB_DIR).free
        # two block segments and the compacted one, each twice its rows
        need = LC_FREE_FACTOR * 4 * rows * (DIM * 4 + 8)
        log(f"index job: starts at {elapsed:.0f} s; --rows {rows} --block-rows "
            f"{block} (blocks of {block} and {tail} rows; "
            f"{cut or 'no cut'}); disk probe {json.dumps(rates)} B/s, "
            f"{free / 2**30:.1f} GiB free, {need / 2**30:.1f} GiB needed")
        if free < need:
            raise AssertionError(f"index job: {free / 2**30:.1f} GiB free")
        argv = job_argv(rows, block, seed, dev)
        store = rt.VirtualStore(rows, DIM, block_rows=block, seed=seed)
        stack.enter_context(cached_blocks(rt.VirtualStore, store, (1, 0)))
        log("index job: this process reads the store through chip_smoke.py's "
            "per-process block cache, blocks 1 and 0 generated in a thread "
            "while J1's child runs (each block generated once)")

        # --- J1: crash after the first commit ---
        times["j1_crash"], child = job_crash(
            rt, argv + ["--commit-every", "1", "--inject-failures"])
        for line in child:
            log(f"index job J1 (child): {line}")
        idx = rt.Index.open(str(JOB_DIR), device=dev)
        cursor = idx.meta.get("ingest") or {}
        if (idx.rows, idx.n_segments, cursor.get("next_block")) != (block, 1, 1):
            raise AssertionError(f"J1: {idx.rows} rows, {idx.n_segments} "
                                 f"segments, cursor {cursor}")
        del idx
        log(f"index job J1: SIGKILLed after v1 was published in "
            f"{times['j1_crash']:.1f} s; Index.open: {block} rows, 1 segment, "
            f"next_block 1")

        # --- J2: the resume, a retried injected failure, codes ---
        lines, times["j2_resume"] = job_run(
            rt, argv + ["--commit-every", "1", "--inject-failures", "--codes"],
            "J2", launches, builds)
        expect_lines(lines, "J2", "ingest: resuming this store at block 1/2",
                     "index job: 1/1 append waves",
                     "1 failed attempts (retried)",
                     f"indexed {tail} descriptors == remaining corpus size OK",
                     "codes: trained")

        # --- J4 (first half): the resumed segment against a build of the
        # same block at another wave size; ids and leaves ---
        idx = rt.Index.open(str(JOB_DIR), device=dev)
        ids_and_leaves(idx, rows)
        seg = idx.segments[-1].index
        blk = store.read_block(1)
        t0 = sync_now()
        before = rt.wrappers["l2nn"].launches
        other = rt.build_index(
            torch.as_tensor(blk.vecs, device=dev), idx.tree,
            ids=torch.as_tensor(blk.ids.astype(np.int32), device=dev),
            wave_rows=1000, wire_dtype=idx.wire_dtype, device=dev)
        other_waves = rt.wrappers["l2nn"].launches - before
        times["j4_rebuild"] = sync_now() - t0
        for f in ("vecs", "ids", "leaves", "offsets", "n_valid", "overflow"):
            if not torch.equal(getattr(other, f), getattr(seg, f)):
                raise AssertionError(f"J4: {f} of the 1000-row-wave build "
                                     "differ from the job's segment")
        if dev.type == "cuda" and other_waves != -(-tail // 1000):
            raise AssertionError(f"J4: {other_waves} waves at 1000 rows")
        del seg, other
        # block 0's segment, built by J1's child on local_mesh(), against a
        # one-shard build of the block on the card (the --device path)
        blk0 = store.read_block(0)
        first = rt.build_index(
            torch.as_tensor(blk0.vecs, device=dev), idx.tree,
            ids=torch.as_tensor(blk0.ids.astype(np.int32), device=dev),
            wire_dtype=idx.wire_dtype, device=dev)
        for f in ("vecs", "ids", "leaves", "offsets", "n_valid", "overflow"):
            if not torch.equal(getattr(first, f), getattr(idx.segments[0].index, f)):
                raise AssertionError(f"J4: {f} of block 0's segment differ from a "
                                     "one-shard build of the block")
        del first, blk0
        # integer rows and centroids make every fp32 sum exact, which hides
        # a batch-size-dependent summation order: the same block and tree
        # moved off the integer grid must build alike at both wave sizes
        g = torch.Generator(device=dev).manual_seed(seed + 23)

        def off_grid(t):
            return t + torch.rand(t.shape, generator=g, device=dev) - 0.5

        real_tree = rt.VocabTree(levels=tuple(off_grid(lv) for lv in idx.tree.levels))
        xr = off_grid(torch.as_tensor(blk.vecs, device=dev))
        ids = torch.as_tensor(blk.ids.astype(np.int32), device=dev)
        built = [rt.build_index(xr, real_tree, ids=ids, wave_rows=w,
                                wire_dtype=torch.float32, device=dev)
                 for w in (4096, 1000)]
        for f in ("vecs", "ids", "leaves", "offsets", "n_valid", "overflow"):
            if not torch.equal(getattr(built[0], f), getattr(built[1], f)):
                raise AssertionError(f"J4: real-valued {f} differ between "
                                     "4096- and 1000-row waves")
        del idx, blk, real_tree, xr, ids, built
        gc.collect()
        torch.cuda.empty_cache()

        # --- J3: compaction and verification ---
        trace = JOB_DIR.parent / "index_job_trace.json"
        metrics = JOB_DIR.parent / "index_job_metrics.json"
        lines, times["j3_compact_verify"] = job_run(
            rt, argv + ["--compact", "--verify-queries", str(JOB_VERIFY),
                        "--trace-out", str(trace), "--metrics-out",
                        str(metrics)], "J3", launches, builds)
        expect_lines(lines, "J3", "ingest: resuming this store at block 2/2",
                     "compacted -> ", "q_cap_overflow 0", f"trace -> {trace}",
                     f"metrics registry -> {metrics}")
        verify = next(ln for ln in lines if ln.startswith("verify:"))
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        spans = sorted({e["name"] for e in events if e.get("ph") == "X"})
        if "index.compact" not in spans:
            raise AssertionError(f"J3: the trace holds {spans}")
        with open(metrics) as f:
            if "index.compacts" not in json.dumps(json.load(f)):
                raise AssertionError("J3: no index.compacts in the metrics")
        trace.unlink()
        metrics.unlink()
        idx = rt.Index.open(str(JOB_DIR), device=dev)
        if idx.n_segments != 1 or idx.rows != rows:
            raise AssertionError(f"J3: {idx.n_segments} segments, "
                                 f"{idx.rows} rows")
        ids_and_leaves(idx, rows)
        log(f"index job J3: one segment of {rows} rows; {verify}; the trace "
            f"read back ({len(events)} events: {', '.join(spans)})")

        # --- J4 (second half): the builds' waves ---
        for n, waves in builds:
            if dev.type == "cuda" and waves != -(-n // 4096):
                raise AssertionError(f"J4: a build of {n} rows ran {waves} "
                                     "l2nn launches")
        ref_waves = {n: n // rt.largest_divisor_leq(n, 4096)
                     for n, _ in builds}
        log(f"index job J4: the resumed segment equals a build of the "
            f"regenerated block at 1000-row waves ({other_waves} waves) bit "
            f"for bit, block 0's segment (J1's child, on local_mesh()) a "
            f"one-shard build of block 0 on the card, and that block's "
            f"builds at 4096- and 1000-row "
            f"waves moved off the integer grid (rows and tree); ids "
            f"0..{rows - 1} each once, leaves ascending; "
            f"builds (rows, waves): {builds}; the reference's snapped waves "
            f"(largest_divisor_leq, not run): {ref_waves}; l2nn launched "
            f"once a build wave")

        # --- J5: Copydays ---
        rt.reset_counts()
        t0 = time.perf_counter()
        cd = job_copydays(rt, idx, rows, seed)
        times["j5_copydays"] = time.perf_counter() - t0
        for key, n in rt.counts().items():
            launches[key] = launches.get(key, 0) + n
        rt.reset_counts()
        del idx
    finally:
        stack.close()
        shutil.rmtree(JOB_DIR, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    times["phase"] = time.perf_counter() - t_phase
    rows_of = {r["name"]: r for r in kernels}
    for name in LC_KERNELS:
        if launches.get(name):
            rows_of[name]["index_job_launches"] = launches[name]
    if dev.type == "cuda" and launches.get("l2nn", 0) <= 0:
        raise AssertionError("index job: l2nn never launched")
    stats = dict(rows=rows, block=block, cut=cut, start_s=elapsed,
                 launches={k: v for k, v in launches.items() if v},
                 builds=builds, copydays=cd, times=times,
                 budget_s=JOB_BUDGET_S)
    log(f"index job: {json.dumps(stats)}")
    log(f"index job: phase {times['phase']:.1f} s against a budget of "
        f"{JOB_BUDGET_S} s")
    return stats


# ---------------------------------------------------------------------------
# the shards phase (both jobs over a mesh of devices)
# ---------------------------------------------------------------------------


def sh_route_forecast(rt, index, n_shards, rows):
    """The largest (source, destination) row count an S-shard build of the
    corpus will route, read off the one-shard index (row ids are corpus
    rows, so a row's source is its block), against the send capacity."""
    ok = index.ids >= 0
    src = torch.div(index.ids[ok].long(), rows // n_shards, rounding_mode="floor")
    dst = torch.div(index.leaves[ok].long(), index.n_leaves // n_shards,
                    rounding_mode="floor")
    counts = torch.bincount(src * n_shards + dst, minlength=n_shards ** 2)
    cap = rt.routing_capacity(rows // n_shards, n_shards, 2.0)
    return int(counts.max()), cap


def sh_same_rows(one, mesh_index):
    """Raise unless each shard's leaves ascend (P3) and its valid rows are,
    leaf by leaf and in order, the one-shard index's rows of its leaf
    range. Returns the rows compared."""
    off = one.offsets[0].long()
    lps = mesh_index.leaves_per_shard
    n = 0
    for s, part in enumerate(mesh_index.parts):
        if not bool((part.leaves[1:] >= part.leaves[:-1]).all()):
            raise AssertionError(f"shards: shard {s}'s leaves do not ascend")
        lo, hi = int(off[s * lps]), int(off[(s + 1) * lps])
        m = int(part.offsets[0, lps])
        if m != hi - lo or m != int(part.n_valid[0]):
            raise AssertionError(f"shards: shard {s} holds {m} rows, the "
                                 f"one-shard index {hi - lo} for its leaves")
        for f in ("vecs", "ids", "leaves"):
            if not torch.equal(getattr(part, f)[:m].to(one.device),
                               getattr(one, f)[lo:hi]):
                raise AssertionError(f"shards: shard {s}'s {f} differ")
        n += m
    return n


def sh_searches(rt, index, tree, queries, pq, codes, sizes, dev):
    """The phase's five searches of ``index``: (name, result, wall s)."""
    k, out = sizes["k"], []
    rows_kw = dict(q_cap=sizes["q_cap"], block_rows=sizes["block_rows"])
    for name, impl, probes in (("sweep_k1", "pallas", 1),
                               ("fused_k2", "fused", 1),
                               ("fused_k2_p2", "fused", 2)):
        t0 = sync_now()
        res = rt.batch_search(index, tree, queries, k, probes=probes,
                              impl=impl, device=dev, **rows_kw)
        out.append((name, res, sync_now() - t0))
    n = queries.shape[0]
    t0 = sync_now()
    plan = rt.make_plan(rows=index.rows, n_leaves=index.n_leaves, n_queries=n,
                        n_shards=index.n_shards, k=k, layout="query_routed",
                        impl="pallas", p_cap=SH_P_CAP,
                        query_capacity_factor=SH_Q_FACTOR)
    res = rt.search_with_lookup(index, rt.build_lookup(tree, queries, probes=1),
                                plan, n_queries=n)
    out.append(("routed_k1", res, sync_now() - t0))
    reader = rt.IndexRowReader(index)
    for name, impl in (("codes_k4", "pallas"), ("codes_k5", "fused")):
        t0 = sync_now()
        lookup = rt.build_lookup(tree, queries, probes=1)
        plan = rt.make_plan(
            rows=index.rows, n_leaves=index.n_leaves, n_queries=n,
            n_shards=index.n_shards, k=k, probes=1, layout="scan_codes",
            impl=impl, code_m=pq.m, code_bits=pq.bits, **rows_kw)
        cand = rt.search_with_lookup(index, lookup, plan, n_queries=n,
                                     codes=codes, codebooks=pq.codebooks)
        ids, dists = rt.rerank_exact(reader, queries, cand.ids, k)
        res = rt.SearchResult(ids=ids, dists=dists, pairs=cand.pairs,
                              q_cap_overflow=cand.q_cap_overflow)
        out.append((name, res, sync_now() - t0))
    return out


def sh_busy_by_device(fn):
    """{device index: (busy s, first s, last s)} of one traced call of
    ``fn``, and the span s over every card: busy is the card's kernels'
    and copies' own time; first and last are its first event's start and
    its last event's end, counted from the earliest event on any card (the
    profiler's start-up is in none). A card whose first event comes only
    as the one before it goes quiet ran in turn with it; the shard tables'
    copies to the first card end every card's span."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
    busy, first, last = {}, {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            d = e.device_index
            busy[d] = busy.get(d, 0.0) + e.self_device_time_total / 1e6
            first[d] = min(first.get(d, e.time_range.start), e.time_range.start)
            last[d] = max(last.get(d, e.time_range.end), e.time_range.end)
    t0 = min(first.values())
    cards = {d: (busy[d], (first[d] - t0) / 1e6, (last[d] - t0) / 1e6)
             for d in sorted(busy)}
    return cards, (max(last.values()) - t0) / 1e6


def sh_timed_build(rt, corpus, tree, mesh):
    """``build_index`` over ``mesh`` with the shuffle (``route_by_leaf``)
    and the cluster sorts timed alone, every device of the mesh
    synchronised around each: (index, wall s, {assign, route, sort} s)."""
    real_route, real_sort = rt.route.route_by_leaf, rt.route.cluster_sort
    spent = dict(route=0.0, sort=0.0)

    def synced():
        for d in mesh.distinct:
            torch.cuda.synchronize(d)
        return time.perf_counter()

    def timed(key, fn):
        def call(*a, **kw):
            t0 = synced()
            out = fn(*a, **kw)
            spent[key] += synced() - t0
            return out
        return call

    rt.route.route_by_leaf = timed("route", real_route)
    rt.route.cluster_sort = timed("sort", real_sort)
    try:
        t0 = synced()
        index = rt.build_index(corpus, tree, wire_dtype=torch.bfloat16, mesh=mesh)
        total = synced() - t0
    finally:
        rt.route.route_by_leaf, rt.route.cluster_sort = real_route, real_sort
    return index, total, dict(assign=total - spent["route"] - spent["sort"],
                              **spent)


def sh_mesh_run(rt, label, mesh, corpus, tree, queries, pq, one, sizes, dev):
    """Build and search ``corpus`` over ``mesh``; hold every gate of the
    phase against the one-shard ``one`` (a dict of its index and search
    results); return this mesh's numbers."""
    S = mesh.n_shards
    rows = corpus.shape[0]
    worst, cap = sh_route_forecast(rt, one["index"], S, rows)
    log(f"shards {label}: {S} shards on {[str(d) for d in mesh.devices]}; the "
        f"largest (source, destination) row count {worst} against the "
        f"capacity {cap}")
    for d in mesh.distinct:
        torch.cuda.reset_peak_memory_stats(d)
    rt.reset_counts()
    index, t_build, split = sh_timed_build(rt, corpus, tree, mesh)
    if int(index.overflow) != 0:
        raise AssertionError(f"shards {label}: routing overflow "
                             f"{int(index.overflow)}")
    n_valid = [int(v) for v in index.n_valid.tolist()]
    if sum(n_valid) != rows:
        raise AssertionError(f"shards {label}: n_valid {n_valid} sums to "
                             f"{sum(n_valid)}, not {rows}")
    t0 = sync_now()
    compared = sh_same_rows(one["index"], index)
    t_check = sync_now() - t0
    t0 = sync_now()
    codes = tuple(pq.encode(p.vecs) for p in index.parts)
    t_encode = sync_now() - t0
    walls, pairs = {}, {}
    for name, res, wall in sh_searches(rt, index, tree, queries, pq, codes,
                                       sizes, dev):
        ref = one["results"][name]
        if not (torch.equal(res.ids, ref.ids) and torch.equal(res.dists, ref.dists)):
            raise AssertionError(f"shards {label} {name}: not bit-identical to "
                                 "one shard")
        if int(res.q_cap_overflow) != int(ref.q_cap_overflow):
            raise AssertionError(f"shards {label} {name}: q_cap_overflow "
                                 f"{int(res.q_cap_overflow)} against "
                                 f"{int(ref.q_cap_overflow)}")
        factor = S if name == "routed_k1" else 1  # R5
        if float(res.pairs) != float(ref.pairs) * factor:
            raise AssertionError(f"shards {label} {name}: pairs "
                                 f"{float(res.pairs)} against "
                                 f"{float(ref.pairs)} x {factor}")
        walls[name], pairs[name] = wall, float(res.pairs)
    launches = {name: rt.wrappers[name].launches for name in SH_KERNELS}
    by_device = {name: {f"cuda:{d}": n for d, n in
                        sorted(rt.wrappers[name].by_device.items())}
                 for name in SH_KERNELS}
    for name in SH_KERNELS:
        for d in mesh.distinct:
            if rt.wrappers[name].by_device[d.index] <= 0:
                raise AssertionError(f"shards {label}: {name} never launched "
                                     f"on {d}")
    rt.reset_counts()
    peak = {str(d): torch.cuda.max_memory_allocated(d) / 2**30
            for d in mesh.distinct}
    stats = dict(shards=S, devices=[str(d) for d in mesh.devices],
                 route_worst=worst, capacity=cap, n_valid=n_valid,
                 rows_compared=compared, rows_check_s=t_check,
                 build_s=t_build, build_split_s=split, encode_s=t_encode,
                 search_s=walls, pairs=pairs, launches=launches,
                 launches_by_device=by_device, peak_gib=peak)
    if len(mesh.distinct) > 1:
        # the K1 sweep traced: each card's busy time and first and last
        # event against the joint span say whether one host thread kept
        # the cards busy at once
        cards, joint = sh_busy_by_device(lambda: rt.batch_search(
            index, tree, queries, sizes["k"], impl="pallas", device=dev,
            q_cap=sizes["q_cap"], block_rows=sizes["block_rows"]))
        stats["sweep_trace"] = dict(
            joint_span_s=joint, wall_untraced_s=walls["sweep_k1"],
            **{f"{key}_s": {f"cuda:{d}": c[j] for d, c in cards.items()}
               for j, key in enumerate(("busy", "first", "last"))})
    del index, codes
    gc.collect()
    torch.cuda.empty_cache()
    log(f"shards {label}: {json.dumps(stats)}")
    log(f"shards {label}: overflow 0; rows equal to one shard's leaf by leaf; "
        f"K1 sweep, K2 (probes 1 and 2), K1 query tiles, K4 and K5 with "
        f"rerank bit-identical to one shard; pairs equal (query-routed "
        f"{S} x, R5); q_cap_overflow equal")
    return stats


def sh_index_check(rt, mesh, corpus, tree, queries, sizes, dev):
    """A short ``Index`` over ``mesh``: two appends, commit, open; its
    probes-2 search against a one-shard ``Index`` of the same rows, and a
    two-shard ``ShardedIndex`` against its own search."""
    k = sizes["k"]
    shutil.rmtree(SH_DIR, ignore_errors=True)
    SH_DIR.mkdir(parents=True)
    times = {}
    try:
        t0 = sync_now()
        idx = rt.Index.create(tree, str(SH_DIR), mesh=mesh,
                              wire_dtype=torch.bfloat16)
        one = rt.Index.create(tree, None, device=dev, wire_dtype=torch.bfloat16)
        n = corpus.shape[0] // SH_LC_SHARE
        for a in range(2):
            rows = corpus[a * n:(a + 1) * n]
            idx.append(rows)
            one.append(rows)
        idx.commit()
        times["grow_s"] = sync_now() - t0
        del idx
        t0 = sync_now()
        idx = rt.Index.open(str(SH_DIR), mesh=mesh)
        times["open_s"] = sync_now() - t0
        kw = dict(k=k, probes=2, layout="point_major", impl="fused")
        t0 = sync_now()
        got = idx.search(queries, **kw)
        times["search_s"] = sync_now() - t0
        want = one.search(queries, **kw)
        differ = tie_only_differences(got, want, k)
        sub = rt.shard_submeshes(mesh, 2)
        sh = rt.ShardedIndex(idx, n_shards=2)
        t0 = sync_now()
        sres = sh.search(queries, **kw)
        times["sharded_s"] = sync_now() - t0
        same_result(sres, got, "shards: ShardedIndex(n_shards=2)")
        stats = dict(segments=[s.n_shards for s in idx.segments],
                     rows=2 * n, ids_differing_in_ties=differ,
                     disk_gib=dir_bytes(SH_DIR) / 2**30,
                     submeshes=[[str(d) for d in m.devices] for m in sub],
                     times=times)
        log(f"shards Index: {json.dumps(stats)}")
        log(f"shards Index: two appends of {n} rows over "
            f"{mesh.n_shards} shards, commit, open: probes-2 search equal to a "
            f"one-shard Index of the same rows ({differ} ids differ inside "
            "exact ties); ShardedIndex(n_shards=2) equal to the unsharded search")
        return stats
    finally:
        shutil.rmtree(SH_DIR, ignore_errors=True)


def shards_phase(rt, args, dev, tree, pq, kernels, t_start, rows=INDEX_ROWS):
    """Both jobs over S shards (``build_index``/``batch_search`` with
    ``mesh=``), held bit for bit against a one-shard index built in the
    phase from the same corpus: mesh A, four shards on the one card, and
    mesh B, one shard a card, where the machine has two cards or more;
    then a short ``Index`` over the mesh and a ``ShardedIndex`` on it.
    Adds each kernel's launches of the mesh runs to ``kernels``."""
    t_phase = time.perf_counter()
    elapsed = t_phase - t_start
    cut = None if rows == INDEX_ROWS else f"{rows} of the main path's {INDEX_ROWS} rows"
    if elapsed > SH_LATEST_START_S:
        rows = SH_CUT_ROWS
        cut = (f"cut to {rows} rows: the phase starts at {elapsed:.0f} s, "
               f"past {SH_LATEST_START_S} s")
    mix = rt.synth.make_mixture(256, DIM, seed=args.seed)
    corpus = make_corpus(rt, rows, args.seed, dev, mix)
    queries = make_queries(corpus, N_QUERIES, args.seed)
    log(f"shards: starts at {elapsed:.0f} s; {rows} rows ({cut or 'no cut'}), "
        f"{N_QUERIES} queries, fanouts {FANOUTS}, k {K}")
    sizes = dict(SIZES, index_rows=rows)
    # the one-shard index and its searches: the phase's reference
    index, t_one, split = sh_timed_build(rt, corpus, tree, rt.DeviceMesh((dev,)))
    codes = pq.encode(index.vecs)
    one = dict(index=index, results={}, walls={})
    for name, res, wall in sh_searches(rt, index, tree, queries, pq, codes,
                                       sizes, dev):
        one["results"][name], one["walls"][name] = res, wall
    del codes
    log(f"shards one shard: build {t_one} s (split: {json.dumps(split)}); "
        f"searches {json.dumps(one['walls'])}")
    meshes = [("mesh A", rt.DeviceMesh((dev,) * SH_SHARDS))]
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        s_b = 4 if n_cards >= 4 else 2
        meshes.append(("mesh B", rt.DeviceMesh(tuple(
            torch.device("cuda", d) for d in range(s_b)))))
    else:
        log("shards mesh B: not run (one card)")
    stats, launches = {}, dict.fromkeys(SH_KERNELS, 0)
    for label, mesh in meshes:
        st = sh_mesh_run(rt, label, mesh, corpus, tree, queries, pq, one,
                         sizes, dev)
        stats[label] = st
        for name in SH_KERNELS:
            launches[name] += st["launches"][name]
        gc.collect()
        torch.cuda.empty_cache()
    del one, index
    gc.collect()
    torch.cuda.empty_cache()
    label, mesh = meshes[-1]
    rt.reset_counts()
    stats["index"] = sh_index_check(rt, mesh, corpus, tree, queries, sizes, dev)
    rt.reset_counts()
    del corpus, queries
    gc.collect()
    torch.cuda.empty_cache()
    rows_of = {r["name"]: r for r in kernels}
    for name in SH_KERNELS:
        rows_of[name]["shards_launches"] = launches[name]
    phase_s = time.perf_counter() - t_phase
    log(f"shards: phase {phase_s:.1f} s against a budget of {SH_BUDGET_S} s; "
        f"launches {json.dumps(launches)}")
    return stats


# ---------------------------------------------------------------------------
# the LM phase
# ---------------------------------------------------------------------------


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
    # tensor-core kernel the prefill runs (writing its lse too), the
    # CUDA-core kernel on the same bf16 inputs, the plain version and sdpa.
    # The sub-millisecond calls run 50 times, so that each timed run lasts
    # tens of milliseconds (over 10 calls one run read the tensor-core
    # kernel 20 % slower than two others)
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


# ---------------------------------------------------------------------------
# the MoE phase (moonshot-v1-16b-a3b: global and routed dispatch)
# ---------------------------------------------------------------------------


def moe_peak_gib(rt, cfg, n_layers: int, batch: int, prompt: int, max_seq: int
                 ) -> float:
    """The timed run's device memory, predicted: the bf16 weights, the
    prefill's fp32 logits and the fp32 embedding its lm head reads, the KV
    cache, and one layer's dispatch buffers (with 2 GiB of slack)."""
    D, V, E, Fe = cfg.d_model, cfg.vocab_size, cfg.moe.n_experts, cfg.moe.d_ff
    per_layer = (cfg.param_count() - V * D - D) // cfg.n_layers
    T = batch * prompt
    cap = rt.tfm.moe_capacity_for(cfg, T)
    byt = (2 * (V * D + D + n_layers * per_layer) + 4 * T * V + 4 * V * D
           + 2 * 2 * n_layers * batch * max_seq * cfg.kv_dim
           + 2 * E * cap * (D + 3 * Fe) + 2 * T * cfg.moe.top_k * D * 3)
    return byt / 2**30 + 2.0


@contextlib.contextmanager
def moe_recorder(rt, calls, force=None):
    """Every router call of the model (``transformer._route``) appends to
    ``calls`` its own picks as sorted sets ``(T, k)`` and in order, its
    gates, its fp32 router logits, the gap between each token's k-th and
    (k+1)-th logit, and the fp32 bound of the router product at those two
    experts (Higham's gamma_D times sum_d |x_d w_de|). With ``force`` (one
    ``(T, k)`` tensor of experts a call, in call order) the layer runs those
    experts, gated by the softmax of this run's logits at them: two runs
    then route every token alike, and their hidden states differ by
    rounding alone, while each run's own picks are still recorded."""
    real = rt.tfm._route

    def route(x2d, router, k):
        flat_e, gates = real(x2d, router, k)
        logits = rt.tfm.router_logits(x2d, router)
        vals, order = torch.sort(logits, dim=-1, descending=True, stable=True)
        mag = x2d.double().abs() @ router.double().abs()  # (T, E)
        edge = order[:, k - 1:k + 1]
        bnd = rt.fp32_gamma(x2d.shape[1]) * mag.gather(1, edge).max(1).values
        picks = flat_e.view(-1, k)
        calls.append(dict(picks=torch.sort(picks, 1).values, order=picks,
                          gates=gates, gap=(vals[:, k - 1] - vals[:, k]).double(),
                          bound=bnd, logits=logits))
        if force is not None:
            given = force[len(calls) - 1].to(torch.int64)
            gates = torch.softmax(logits.gather(1, given), dim=-1)
            flat_e = given.reshape(-1).to(torch.int32)
        return flat_e, gates

    rt.tfm._route = route
    try:
        yield calls
    finally:
        rt.tfm._route = real


def moe_layers(calls, n_layers, shards=1):
    """The recorded calls as one record a layer (a routed run's S shard
    calls a layer joined, shard by shard, as the global run's rows)."""
    if len(calls) != n_layers * shards:
        raise AssertionError(f"moe: {len(calls)} router calls for {n_layers} "
                             f"layers x {shards} shards")
    out = []
    for i in range(n_layers):
        part = calls[i * shards:(i + 1) * shards]
        out.append({key: torch.cat([c[key] for c in part]) for key in part[0]})
    return out


def moe_agreement(ref, run, what, tau):
    """``run`` routed every token as ``ref`` did (forced picks): the share
    of tokens whose own picks in ``run`` differ from ``ref``'s in some
    layer. Every such pick must be a near tie: the gap between the k-th and
    (k+1)-th router logit, in ``ref`` or in ``run``, within ``2 *
    tau[layer]``, the largest move of a router logit that the bf16 model's
    own rounding makes at that layer (each of the two logits may move that
    far). Returns (share, the largest gap of a differing pick over 2 tau,
    and over the fp32 bound of the router product alone)."""
    differ = torch.zeros(ref[0]["picks"].shape[0], dtype=torch.bool,
                         device=ref[0]["picks"].device)
    worst = worst_fp32 = 0.0
    for la, lb, t in zip(ref, run, tau):
        other = (la["picks"] != lb["picks"]).any(1)
        differ |= other
        if bool(other.any()):
            gap = torch.minimum(la["gap"], lb["gap"])[other]
            bnd = torch.maximum(la["bound"], lb["bound"])[other]
            worst = max(worst, float(gap.max()) / (2 * t))
            worst_fp32 = max(worst_fp32, float((gap / bnd).max()))
    if worst > 1.0:
        raise AssertionError(f"moe {what}: a pick differs with a gap of {worst} x "
                             f"twice the bf16 model's own router-logit error: not "
                             f"a near tie")
    return float(differ.float().mean()), worst, worst_fp32


def routed_rows_dropped(rt, layers, cfg, n_tokens, n_shards):
    """The rows a routed run really dropped, from its recorded picks: on
    the send side (past ``cap`` rows to one destination, in row order) and
    on the owner (past ``cap2`` rows of one of its experts). The routed
    variant's own count, the reference's rule, subtracts the owner's empty
    slots from its owner-side overflow and floors the result at 0, so an
    owner's drops mostly read as 0 there (ROADMAP R6)."""
    cap, cap2 = rt.tfm.routed_capacities(cfg, n_tokens, n_shards)
    E = cfg.moe.n_experts
    e_loc = E // n_shards
    send = owner = 0
    for rec in layers:
        e = rec["order"].reshape(n_shards, -1).long()
        onehot = torch.nn.functional.one_hot(e // e_loc, n_shards)
        rank = (onehot.cumsum(1) - 1).gather(2, (e // e_loc)[..., None])[..., 0]
        fits = rank < cap
        send += int((~fits).sum())
        if e_loc > 1:
            cnt = torch.bincount(e[fits], minlength=E)
            owner += int((cnt - cap2).clamp_min(0).sum())
    return dict(send=send, owner=owner, cap=cap, cap2=cap2)


def moe_prefill(rt, params, cfg, prompts, max_seq, dev, *, cf=None, mesh=None,
                force=None):
    """One prefill with its router calls recorded (and, with ``force``, the
    given picks run); returns (logits, cache, per-layer records, drops)."""
    aux, calls = {}, []
    with moe_recorder(rt, calls, force):
        logits, cache = rt.tfm.prefill(params, cfg, prompts, max_seq, device=dev,
                                       capacity_factor=cf, mesh=mesh, aux=aux)
    shards = mesh.n_shards if mesh is not None and cfg.moe_impl == "routed" else 1
    return logits, cache, moe_layers(calls, cfg.n_layers, shards), int(aux["moe_drops"])


def moe_oracle(rt, x, layer, rec, out, cfg, n_tokens):
    """(d): layer 0's MoE output of ``n_tokens`` tokens against float64,
    given the card's own picks and gates: y = sum_j g_j W_down[e_j]
    (silu(x W_gate[e_j]) * (x W_up[e_j])), with a first-order bound of the
    bf16 roundings (each product's output, silu, the product of the two,
    the final sum; the gates in bf16 on both sides) and the fp32 sums'
    gamma terms. Returns the largest error
    over its bound, and the same for a broken variant (each token's
    last pick replaced by its (k+1)-th expert), which must exceed 1."""
    ub, k = 2.0**-8, cfg.moe.top_k
    D, Fe = cfg.d_model, cfg.moe.d_ff
    gD, gF = rt.fp32_gamma(D), rt.fp32_gamma(Fe)
    xs = x[:n_tokens].double()
    order = rec["order"][:n_tokens].long()
    gates = rec["gates"][:n_tokens].to(torch.bfloat16).double()

    def evaluate(experts):
        y = torch.zeros((n_tokens, D), dtype=torch.float64, device=x.device)
        err, mag = torch.zeros_like(y), torch.zeros_like(y)
        for e in torch.unique(experts).tolist():
            t, j = torch.nonzero(experts == e, as_tuple=True)
            wg = layer["w_gate"][e].double()
            wu = layer["w_up"][e].double()
            wd = layer["w_down"][e].double()
            xe = xs[t]
            a, b = xe @ wg, xe @ wu
            ea = gD * (xe.abs() @ wg.abs()) + ub * a.abs()
            eb = gD * (xe.abs() @ wu.abs()) + ub * b.abs()
            sa = a * torch.sigmoid(a)
            es = 1.1 * ea + ub * sa.abs()
            h = sa * b
            eh = sa.abs() * eb + b.abs() * es + ub * h.abs()
            ye = h @ wd
            ey = eh @ wd.abs() + gF * (h.abs() @ wd.abs()) + ub * ye.abs()
            g = gates[t, j][:, None]
            y.index_add_(0, t, g * ye)
            err.index_add_(0, t, g * ey)
            mag.index_add_(0, t, g * ye.abs())
        # the gate sum: fp32 over k terms, then one rounding to bf16
        return y, err + rt.fp32_gamma(k) * mag + ub * y.abs()

    y, err = evaluate(order)
    got = out[:n_tokens].double()
    ratio = float(((got - y).abs() / err).max())
    broken = order.clone()
    broken[:, -1] = rec["next"][:n_tokens]
    yb, _ = evaluate(broken)
    broken_ratio = float(((got - yb).abs() / err).max())
    return ratio, broken_ratio


def moe_phase(rt, args, dev, kernels, t_start):
    """moonshot-v1-16b-a3b at full width on the card: timed at the deepest
    depth that fits (48 layers) through prefill and greedy decode (one
    more of each traced), then checked at 8 layers: (a) chunked against
    full-attention prefill, (b) each decode step against ``forward``, (c) global against routed
    dispatch over four shards of the card, (d) layer 0's expert outputs
    against float64, (e) K6 at hd 128 on the tensor-core kernel, held and
    timed on layer 0's q, k, v. Adds K6's MoE launches and times to its
    kernels-line row."""
    t_phase = time.perf_counter()
    full = dataclasses.replace(rt.lm.MOONSHOT_V1_16B, attn_impl="chunked")
    max_seq = LM_PROMPT + LM_DECODE
    depth = full.n_layers
    while (moe_peak_gib(rt, full, depth, LM_BATCH, LM_PROMPT, max_seq)
           > MOE_PEAK_LIMIT_GIB):
        depth -= 1
    cfg = dataclasses.replace(full, n_layers=depth)
    cut = None if depth == full.n_layers else f"{depth} of {full.n_layers} layers"
    predicted = moe_peak_gib(rt, full, depth, LM_BATCH, LM_PROMPT, max_seq)
    prompts = torch.as_tensor(
        rt.lm_batch(LM_BATCH, LM_PROMPT, cfg.vocab_size, seed=args.seed)["tokens"],
        device=dev)
    t0 = sync_now()
    params = rt.lm.layered_params(cfg, args.seed, dev, depth)
    t_init = sync_now() - t0
    log(f"moe: starts at {t_phase - t_start:.0f} s; {full.name} at {depth} layers "
        f"({cut or 'full depth, no cut'}), {cfg.param_count()} parameters "
        f"({cfg.active_param_count()} active a token), drawn on the card in "
        f"{t_init:.3f} s; {LM_BATCH} prompts x {LM_PROMPT} tokens, {LM_DECODE} "
        f"decode steps; peak predicted {predicted:.1f} GiB")
    _, wc = rt.tfm.prefill(params, cfg, prompts[:1, :64], 65, device=dev)
    rt.tfm.decode_step(params, cfg, prompts[:1, :1], wc, 64, device=dev)
    del wc

    # --- timed: the served run at the configuration's capacity factor ---
    torch.cuda.reset_peak_memory_stats()
    rt.reset_counts()
    aux = {}
    t0 = sync_now()
    logits, cache = rt.tfm.prefill(params, cfg, prompts, max_seq, device=dev, aux=aux)
    t_prefill = sync_now() - t0
    nxt = logits[:, -1:].argmax(-1)
    finite = bool(torch.isfinite(logits).all())
    shape = tuple(logits.shape)
    del logits
    t0 = sync_now()
    for t in range(LM_DECODE):
        dl, cache = rt.tfm.decode_step(params, cfg, nxt, cache, LM_PROMPT + t,
                                       device=dev)
        nxt = dl[:, -1:].argmax(-1)
    t_decode = sync_now() - t0
    finite &= bool(torch.isfinite(dl).all())
    launches = rt.counts()
    rt.reset_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    drops = int(aux["moe_drops"])
    flops = rt.lm.lm_model_flops(cfg, LM_BATCH, LM_PROMPT, "prefill")
    timed = dict(layers=depth, cut=cut, prefill_s=t_prefill,
                 prefill_tokens_s=LM_BATCH * LM_PROMPT / t_prefill,
                 prefill_tflops=flops / t_prefill / 1e12,
                 decode_ms_step=t_decode / LM_DECODE * 1e3, moe_drops=drops,
                 capacity=rt.tfm.moe_capacity_for(cfg, LM_BATCH * LM_PROMPT),
                 peak_gib=peak, peak_predicted_gib=predicted,
                 launches={k: v for k, v in launches.items() if v})
    log(f"moe timed: {json.dumps(timed)}")
    if shape != (LM_BATCH, LM_PROMPT, cfg.vocab_size) or not finite:
        raise AssertionError(f"moe: prefill logits {shape}, finite {finite}")
    if (launches["flashattn"] != depth or launches["flashattn.tensor_core"] != depth
            or launches["flashattn.cuda_core"] != 0):
        raise AssertionError(f"moe (e): the prefill's K6 launches did not all go to "
                             f"the tensor-core kernel: {json.dumps(launches)}")
    # where a prefill's and a decode step's device time goes (one more each)
    for name, wall, fn in (
            ("prefill", t_prefill, lambda: rt.tfm.prefill(params, cfg, prompts,
                                                          max_seq, device=dev)),
            ("decode step", t_decode / LM_DECODE, lambda: rt.tfm.decode_step(
                params, cfg, nxt, cache, LM_PROMPT, device=dev))):
        ev, busy = device_trace(fn)
        top = sorted(ev, key=lambda e: -e.self_device_time_total)[:8]
        log(f"trace moe {name}: device busy {busy} s of {wall} s wall (idle share "
            f"{1 - busy / wall}); {sum(e.count for e in ev)} kernels; top device "
            "time: " + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3} ms "
                                 f"x{e.count}" for e in top))
    del params, cache, dl, nxt
    gc.collect()
    torch.cuda.empty_cache()

    # --- checked at 8 layers (the same draw's first layers), at a
    # capacity factor where nothing drops ---
    torch.cuda.reset_peak_memory_stats()
    c8 = dataclasses.replace(cfg, n_layers=MOE_CHECK_LAYERS)
    p8 = rt.lm.layered_params(c8, args.seed, dev, MOE_CHECK_LAYERS)
    cf, n = MOE_CHECK_CF, LM_DECODE + 1
    captured = {}
    real_fa, real_ffn = rt.tfm.flash_attention, rt.tfm._moe_ffn

    def capture_fa(q, k, v, *, window):
        captured.setdefault("qkv", (q.clone(), k.clone(), v.clone(), window))
        return real_fa(q, k, v, window=window)

    def capture_ffn(x2d, layer, c, capacity):
        out = real_ffn(x2d, layer, c, capacity)
        captured.setdefault("ffn", (x2d.clone(), out[0].clone()))
        return out

    rt.tfm.flash_attention, rt.tfm._moe_ffn = capture_fa, capture_ffn
    try:
        lc, cache, rc, d_c = moe_prefill(rt, p8, c8, prompts, max_seq, dev, cf=cf)
    finally:
        rt.tfm.flash_attention, rt.tfm._moe_ffn = real_fa, real_ffn
    # (b) decode from this cache, then forward over prompt + generated
    steps, gen, rd = [], [], []
    nxt = lc[:, -1:].argmax(-1)
    for t in range(LM_DECODE):
        gen.append(nxt)
        calls = []
        with moe_recorder(rt, calls):
            dl, cache = rt.tfm.decode_step(p8, c8, nxt, cache, LM_PROMPT + t, device=dev)
        rd.append(moe_layers(calls, MOE_CHECK_LAYERS))
        steps.append(dl[:, 0])
        nxt = dl[:, -1:].argmax(-1)
    del cache
    served = torch.cat([lc[:, -1:], torch.stack(steps, 1)], 1)  # (B, 33, V)
    S_all = LM_PROMPT + LM_DECODE
    # the served run's records, token for token as forward's: the prompt
    # from the prefill, each generated position from its decode step
    served_rec = []
    for i in range(MOE_CHECK_LAYERS):
        rec = {}
        for key in rc[i]:
            pre = rc[i][key].view(LM_BATCH, LM_PROMPT, *rc[i][key].shape[1:])
            dec = torch.stack([r[i][key] for r in rd], 1)
            rec[key] = torch.cat([pre, dec], 1).reshape(LM_BATCH * S_all,
                                                        *rc[i][key].shape[1:])
        served_rec.append(rec)
    calls, faux = [], {}
    with moe_recorder(rt, calls, [r["order"] for r in served_rec]):
        fwd, faux = rt.tfm.forward(p8, c8, torch.cat([prompts] + gen, 1), device=dev,
                                   capacity_factor=cf)
    rf = moe_layers(calls, MOE_CHECK_LAYERS)
    tail = fwd[:, LM_PROMPT - 1:].clone()
    del fwd, steps
    # (c) routed over four shards of the card; its capacities follow the
    # configuration's factor (the reference's rule), so the check's
    # configuration carries the check's factor. Then both variants' drops
    # at the configuration's own factor
    mesh = rt.DeviceMesh((dev,) * MOE_SHARDS)
    T = LM_BATCH * LM_PROMPT
    routed = dataclasses.replace(c8, moe_impl="routed")
    routed_cf = dataclasses.replace(routed, moe=dataclasses.replace(
        c8.moe, capacity_factor=cf))
    lr, _, rr, d_r = moe_prefill(rt, p8, routed_cf, prompts, max_seq, dev, mesh=mesh)
    routed_lost = routed_rows_dropped(rt, rr, routed_cf, T, MOE_SHARDS)
    picks_equal = all(torch.equal(a["order"], b["order"]) for a, b in zip(rc, rr))
    e_cr = float((lc - lr).abs().max())
    del lr
    drops_cfg = {}
    for name, (c, m) in (("global", (c8, None)), ("routed", (routed, mesh))):
        ldrop, _, rec, drops_cfg[name] = moe_prefill(rt, p8, c, prompts, max_seq, dev,
                                                     mesh=m)
        del ldrop
    drops_cfg["routed_rows_dropped"] = routed_rows_dropped(rt, rec, routed, T,
                                                           MOE_SHARDS)
    # (a) the same prefill through plain attend, routed as the chunked one
    forced = [r["order"] for r in rc]
    lf, _, rfull, d_f = moe_prefill(rt, p8, dataclasses.replace(c8, attn_impl="full"),
                                    prompts, LM_PROMPT, dev, cf=cf, force=forced)
    # the yardstick: the full-attention prefill of the same weights in fp32,
    # over the tokens whose picks agree with the bf16 run's: the logits'
    # error, and each layer's largest router-logit move
    c32 = dataclasses.replace(c8, dtype="float32", attn_impl="full")
    p32 = {"embed": p8["embed"].float(), "final_norm": p8["final_norm"].float(),
           "layers": {key: v.float() for key, v in p8["layers"].items()}}
    l32, _, r32, d_32 = moe_prefill(rt, p32, c32, prompts, LM_PROMPT, dev, cf=cf,
                                    force=forced)
    del p32
    share_y = moe_agreement(rfull, r32, "yardstick", [math.inf] * len(r32))[0]
    e_b = float((lf - l32).abs().max())
    e_b_tail = float((lf[:, -n:] - l32[:, -n:]).abs().max())
    e_c32 = float((lc - l32).abs().max())
    del l32
    tau = [float((la["logits"] - lb["logits"]).abs().max())
           for la, lb in zip(rfull, r32)]
    share_a, worst_a, fp32_a = moe_agreement(rc, rfull, "(a) chunked vs full", tau)
    e_cf = float((lc - lf).abs().max())
    del lf, lc
    share_b, worst_b, fp32_b = moe_agreement(served_rec, rf, "(b) decode vs forward",
                                             tau)
    e_dec = float((served - tail).abs().max())
    greedy = float((served.argmax(-1) == tail.argmax(-1)).float().mean())
    del served, tail
    gc.collect()
    torch.cuda.empty_cache()
    checks = dict(
        capacity_factor=cf, drops=dict(chunked=d_c, full=d_f, fp32=d_32, routed=d_r,
                                       forward=int(faux["moe_drops"]),
                                       routed_send=routed_lost["send"],
                                       routed_owner=routed_lost["owner"]),
        drops_at_config_factor=drops_cfg, chunked_vs_full=e_cf,
        decode_vs_forward=e_dec, global_vs_routed=e_cr,
        bf16_vs_fp32=e_b, bf16_vs_fp32_last33=e_b_tail, chunked_vs_fp32=e_c32,
        picks_disagree_share=dict(chunked_vs_full=share_a, decode_vs_forward=share_b,
                                  bf16_vs_fp32=share_y),
        router_logit_move_bf16_vs_fp32=tau,
        worst_disagreeing_gap_over_twice_that=dict(chunked_vs_full=worst_a,
                                                   decode_vs_forward=worst_b),
        worst_disagreeing_gap_over_fp32_router_bound=dict(chunked_vs_full=fp32_a,
                                                          decode_vs_forward=fp32_b),
        routed_picks_bit_identical=picks_equal, greedy_agree_decode_forward=greedy)
    log(f"moe checks (8 layers): {json.dumps(checks)}")
    if any(v for v in checks["drops"].values()):
        raise AssertionError(f"moe: rows dropped at capacity factor {cf}")
    # each run of a pair carries the bf16 model's own rounding error, so the
    # two may differ by twice it
    if not e_cf <= 2 * e_b:
        raise AssertionError(f"moe (a): chunked vs full prefill logits differ by "
                             f"{e_cf}, more than twice the bf16 model's own error "
                             f"{e_b}")
    if not e_dec <= 2 * e_b_tail:
        raise AssertionError(f"moe (b): decode vs forward logits differ by {e_dec}, "
                             f"more than twice the bf16 model's own error "
                             f"{e_b_tail}")
    if not picks_equal:
        raise AssertionError("moe (c): routed picked other experts than global")
    if not e_cr <= e_b:
        raise AssertionError(f"moe (c): global vs routed logits differ by {e_cr}, "
                             f"more than the bf16 model's own error {e_b}")

    # (d) layer 0's expert outputs against float64
    x0, out0 = captured["ffn"]
    rec0 = dict(rc[0])
    logits0 = rt.tfm.router_logits(x0, p8["layers"]["router"][0])
    rec0["next"] = torch.sort(logits0, dim=-1, descending=True,
                              stable=True)[1][:, c8.moe.top_k]
    layer0 = {key: v[0] for key, v in p8["layers"].items()}
    ratio_d, broken_d = moe_oracle(rt, x0, layer0, rec0, out0, c8, MOE_ORACLE_TOKENS)
    log(f"moe (d): layer 0's expert outputs of {MOE_ORACLE_TOKENS} tokens against "
        f"float64 given the card's picks and gates: {ratio_d} of the bf16/fp32 bound; "
        f"a broken variant (each token's last pick swapped for its next expert) "
        f"{broken_d} x")
    if not ratio_d <= 1.0:
        raise AssertionError(f"moe (d): {ratio_d} x the bound")
    if not broken_d > 1.0:
        raise AssertionError(f"moe (d): the broken variant passes ({broken_d} x)")

    # (e) K6 at hd 128 against its plain version, and timed
    q, k, v, window = captured["qkv"]
    if rt.fa_variant(q.dtype, q.shape[-1]) != "tensor_core":
        raise AssertionError(f"moe (e): bf16 at hd {q.shape[-1]} does not take the "
                             "tensor-core kernel")
    fa, ref = rt.flash_attention, rt.flash_attention_ref
    got, want = fa(q, k, v, window=window), ref(q, k, v, window=window)
    tol = rt.attention_bf16_tol(q, k, v, window=window)
    ratio_e = float(((got.double() - want.double()).abs() / tol).max())
    err_e = float((got.float() - want.float()).abs().max())
    del got, want, tol
    reps = [(q, k, v)] * 50
    kern = time_ms(lambda q, k, v: fa(q, k, v, window=window), reps)
    plain = time_ms(lambda q, k, v: ref(q, k, v, window=window), reps[:5])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    heads_first = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
    lib = time_ms(lambda q, k, v: sdpa(q, k, v, is_causal=True, enable_gqa=True),
                  [heads_first] * 50)
    B, Sq, Hq, hd = q.shape
    fl = 4.0 * hd * B * Hq * lm_pairs(Sq, k.shape[1], window)
    byt = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bnd = bound(byt, fl, BF16_FLOPS)
    k6 = dict(shape=[B, Sq, Hq, k.shape[2], hd], ms=kern[0], wall_ms=kern[1],
              plain_ms=plain[0], library_ms=lib[0], bound_ms=bnd[0], bound_by=bnd[1],
              tflops=fl / kern[0] / 1e9, bf16_tol_ratio=ratio_e, max_abs_err=err_e,
              moe_launches=launches["flashattn"],
              moe_launches_tensor_core=launches["flashattn.tensor_core"])
    log(f"moe (e): flashattn at layer 0's shape {k6['shape']}: {json.dumps(k6)}")
    if not ratio_e <= 1.0:
        raise AssertionError(f"moe (e): flashattn at {ratio_e} x the bf16 tolerance")
    row = next(r for r in kernels if r["name"] == "flashattn")
    row["moe"] = k6
    row["moe_launches"] = launches["flashattn"]
    row["max_abs_err"] = max(row["max_abs_err"], err_e)
    del p8, q, k, v, heads_first, captured, x0, out0
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"moe: phase {wall:.1f} s against a budget of {MOE_BUDGET_S} s; peak of the "
        f"checks {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return dict(timed=timed, checks=checks, oracle=dict(ratio=ratio_d, broken=broken_d),
                k6=k6, wall_s=wall)


# ---------------------------------------------------------------------------
# the train phase (internlm2-1.8b: the train_4k step, K6 with its backward)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def deterministic():
    """Deterministic implementations where torch has them (the embedding
    gather's backward adds with atomics otherwise): (d)'s two runs of the
    steps after the save, which come after the timed ones, since the mode
    does work the training path does not (sort-based scatters, memory
    filled on allocation). cuBLAS, on one stream, picks the same
    algorithms for the same shapes; ``warn_only`` because its workspace
    setting must precede the process's first cuBLAS call."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def train_cfg(rt):
    """internlm2-1.8b at full width and depth, bf16 compute over fp32
    master weights, ``remat="dots"``, chunked attention (K6 in every
    layer, forward and backward)."""
    return dataclasses.replace(rt.lm.INTERNLM2_18B, attn_impl="chunked", remat="dots")


def train_batch(rt, cfg, step: int, seed: int) -> dict:
    return rt.lm_batch(TR_BATCH, TR_SEQ, cfg.vocab_size, seed=seed + step)


def train_peak_gib(cfg) -> float:
    """The step's device memory, predicted: fp32 weights, both moments,
    the accumulated and one microbatch's gradients; per microbatch the
    kept ``mm`` outputs of every layer (bf16), the fp32 logits and their
    gradient, the fp32 copy of the embedding the head reads; 3 GiB of slack
    (a layer's recomputed activations, the optimizer's temporaries)."""
    n = cfg.param_count()
    tok = TR_BATCH // TR_MICRO * TR_SEQ
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    mm_out = 2 * tok * (cfg.q_dim + 2 * cfg.kv_dim + D + 2 * F + D) * cfg.n_layers
    byt = 5 * 4 * n + mm_out + 2 * 4 * tok * V + 4 * V * D
    return byt / 2**30 + 3.0


def layer_prefix(params, n: int) -> dict:
    """The first ``n`` layers of ``params`` (views of the same draw)."""
    return {"embed": params["embed"], "final_norm": params["final_norm"],
            "layers": {key: t[:n] for key, t in params["layers"].items()}}


def k6_nodes(root) -> list:
    """The K6 backward nodes (``FlashAttention``'s) of the autograd graph
    under ``root``, in the order of their forward calls: layer 0's first."""
    seen, stack, found = set(), [root], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == "FlashAttentionBackward":
            found.append(node)
        stack.extend(nxt for nxt, _ in node.next_functions)
    return sorted(found, key=lambda n: n._sequence_nr())


def layer0_k6_inputs(rt, params, cfg, tokens, dev) -> tuple:
    """Layer 0's K6 inputs for ``tokens``: ``(q, k, v, out, lse, window)``,
    the tensors ``FlashAttention`` saves in a one-layer forward of the same
    weights (no remat, so they are kept); layer 0 computes the same in the
    full model."""
    c1 = dataclasses.replace(cfg, n_layers=1, remat="none")
    p1 = rt.tree.map_(lambda t: t.detach().requires_grad_(), layer_prefix(params, 1))
    logits, _ = rt.tfm.forward(p1, c1, tokens, device=dev)
    node, = k6_nodes(logits.grad_fn)
    return tuple(t.detach().clone() for t in node.saved_tensors) + (node.window,)


class Step0Capture:
    """What (b) and (c) read from step 0, through autograd hooks (nothing
    of the port is replaced): each leaf's gradient accumulated over the
    microbatches as the step does (``g.float() / m`` in chunk order), and
    the output gradient and (dq, dk, dv) of layer 0's K6 backward in the
    first microbatch. ``loss_fn`` is the step's loss with the hooks on
    that microbatch's graph."""

    def __init__(self, rt, params, cfg, dev):
        self.rt, self.cfg, self.dev = rt, cfg, dev
        self.grads, self.k6, self.handles, self.hooked = {}, {}, [], False
        for name, p in rt.tree.named(params).items():
            p.requires_grad_(True)
            self.handles.append(p.register_hook(functools.partial(self._grad, name)))

    def _grad(self, name, g):
        x = g.float() / TR_MICRO
        self.grads[name] = self.grads[name].add_(x) if name in self.grads else x

    def loss_fn(self, p, batch):
        loss, aux = self.rt.tfm.loss_fn(p, self.cfg, batch, device=self.dev)
        if not self.hooked:
            node = k6_nodes(loss.grad_fn)[0]
            self.hooked = True
            self.handles.append(node.register_prehook(self._dout))
            self.handles.append(node.register_hook(self._dqkv))
        return loss, aux

    def _dout(self, grad_outputs):
        self.k6["dout"] = grad_outputs[0].detach().clone()

    def _dqkv(self, grad_inputs, grad_outputs):
        self.k6["dqkv"] = tuple(t.detach().clone() for t in grad_inputs[:3])

    def close(self):
        for h in self.handles:
            h.remove()


def loss_and_grads(rt, params, cfg, batch, dev):
    """``loss_fn``'s loss (a float) and the gradient of every leaf."""
    leaves = [t.detach().requires_grad_() for t in rt.tree.leaves(params)]
    loss, _ = rt.tfm.loss_fn(rt.tree.unflatten(params, leaves), cfg, batch, device=dev)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), dict(zip(rt.tree.named(params), grads))


def train_check_a(rt, params, cfg, batch, dev):
    """(a) step 0's loss and gradients at ``TR_CHECK_LAYERS`` layers of the
    same draw, on one microbatch: chunked (K6 and its tensor-core kernel
    backward) against full attention (plain ``attend``, autograd), within
    the bf16 model's own error, the full-attention run against the same
    weights in fp32: the loss within it, each gradient leaf's relative error
    (L2) within twice it (each run of the pair carries that error). The
    same model in fp32 with chunked attention (K6's CUDA-core forward and
    backward, the rule's for fp32) against the fp32 full-attention run:
    within a hundredth of the bf16 model's error, loss and every leaf. The
    K6 backward launches of each run are counted from 0 by variant."""
    c4 = dataclasses.replace(cfg, n_layers=TR_CHECK_LAYERS)
    p4 = layer_prefix(params, TR_CHECK_LAYERS)
    mb = {key: x[:TR_BATCH // TR_MICRO] for key, x in batch.items()}
    runs, bwd_launches = {}, {}
    for name, c in (("chunked", c4), ("full", dataclasses.replace(c4, attn_impl="full")),
                    ("fp32", dataclasses.replace(c4, dtype="float32", attn_impl="full")),
                    ("chunked_fp32", dataclasses.replace(c4, dtype="float32"))):
        rt.reset_counts()
        runs[name] = loss_and_grads(rt, p4, c, mb, dev)
        counts = rt.counts()
        bwd_launches[name] = {kern: counts[f"flashattn_bwd.{kern}"]
                              for kern in ("tensor_core", "cuda_core")}
    (lc, gc_), (lf, gf), (l32, g32) = runs["chunked"], runs["full"], runs["fp32"]
    lc32, gc32 = runs["chunked_fp32"]

    def rel(a, b, ref):
        return float((a.float() - b.float()).norm() / ref.float().norm())

    leaves = {}
    for name in g32:
        yard = rel(gf[name], g32[name], g32[name])
        leaves[name] = dict(chunked_vs_full=rel(gc_[name], gf[name], g32[name]),
                            bf16_vs_fp32=yard,
                            fp32_chunked_vs_full=rel(gc32[name], g32[name], g32[name]))
    out = dict(layers=TR_CHECK_LAYERS, tokens=mb["tokens"].size,
               loss=dict(chunked=lc, full=lf, fp32=l32, chunked_fp32=lc32,
                         chunked_vs_full=abs(lc - lf), bf16_vs_fp32=abs(lf - l32),
                         fp32_chunked_vs_full=abs(lc32 - l32)),
               grads=leaves, k6_backward_launches=bwd_launches)
    log(f"train (a): {json.dumps(out)}")
    n = TR_CHECK_LAYERS
    want = {"chunked": {"tensor_core": n, "cuda_core": 0},
            "chunked_fp32": {"tensor_core": 0, "cuda_core": n},
            "full": {"tensor_core": 0, "cuda_core": 0},
            "fp32": {"tensor_core": 0, "cuda_core": 0}}
    if bwd_launches != want:
        raise AssertionError(f"train (a): K6 backward launches {bwd_launches}, not {want}")
    if not abs(lc - lf) <= abs(lf - l32):
        raise AssertionError(f"train (a): chunked vs full loss {abs(lc - lf)}, more than "
                             f"the bf16 model's own error {abs(lf - l32)}")
    if not abs(lc32 - l32) <= abs(lf - l32) / 100:
        raise AssertionError(f"train (a): fp32 chunked vs full loss {abs(lc32 - l32)}, "
                             f"more than a hundredth of the bf16 error {abs(lf - l32)}")
    for name, r in leaves.items():
        if not r["chunked_vs_full"] <= 2 * r["bf16_vs_fp32"]:
            raise AssertionError(f"train (a): {name} chunked vs full {r} is more than "
                                 "twice the bf16 model's own error")
        if not r["fp32_chunked_vs_full"] <= r["bf16_vs_fp32"] / 100:
            raise AssertionError(f"train (a): {name} fp32 chunked vs full {r} is more "
                                 "than a hundredth of the bf16 model's own error")
    return out


def bwd_variants(rt, q, k, v, out, lse, dout, window):
    """Plain backward variants that must fail the bf16 check, each built
    from ``flash_attention_bwd_ref``: the causal diagonal one key back (the
    last key dropped, so key j stands where j + 1 did; its dk and dv rows
    zero), the GQA head map shifted by one, dk and dv taken from each
    group's first query head alone, and (with a window) the window one
    longer."""
    ref = rt.flash_attention_bwd_ref
    G = q.shape[2] // k.shape[2]
    sq, sk, sv = ref(q, k[:, :-1], v[:, :-1], out, lse, dout, window=window)
    hq, hk, hv = ref(q, k.roll(1, dims=2), v.roll(1, dims=2), out, lse, dout,
                     window=window)
    first = ref(q[:, :, ::G], k, v, out[:, :, ::G], lse[:, ::G], dout[:, :, ::G],
                window=window)
    bad = {
        "diagonal_off_by_one": (sq, *(torch.cat([t, torch.zeros_like(t[:, :1])], 1)
                                      for t in (sk, sv))),
        "heads_shifted": (hq, hk.roll(-1, dims=2), hv.roll(-1, dims=2)),
        "dk_not_summed_over_group": (ref(q, k, v, out, lse, dout, window=window)[0],
                                     first[1], first[2]),
    }
    if window > 0:
        bad["window_plus_one"] = ref(q, k, v, out, lse, dout, window=window + 1)
    return bad


def bwd_kernel_check(rt, name, q, k, v, out, lse, dout, window, g, step_grads=None):
    """(b) on one layer's bf16 inputs: each backward variant (the rule's
    tensor-core kernel and the CUDA-core one, forced) and the plain
    backward within the bf16 tolerance of the float64 gradient, the broken
    plain variants outside it, two runs of each kernel bit-identical, and
    the rule's kernel equal bit for bit to ``step_grads`` (the gradients the
    step's own backward gave for these inputs) when given; fp32 copies moved
    off the bf16 grid (batch row 0, the CUDA-core forward's out and lse)
    within the fp32 bound, which the plain backward in TF32 must break, and
    their largest difference from the plain fp32 backward."""
    bwd, ref = rt.flash_attention_bwd, rt.flash_attention_bwd_ref
    rule = rt.fa_variant(q.dtype, q.shape[-1])
    plain = ref(q, k, v, out, lse, dout, window=window)
    exact, _, tol16 = rt.attention_grads_f64(q, k, v, dout, window=window)
    row = dict(window=window, shape=list(q.shape) + [k.shape[2]], rule=rule,
               plain_bf16_tol_ratio=rt.grads_error_ratio(plain, exact, tol16),
               variants={})
    for kern in ("tensor_core", "cuda_core"):
        got = bwd(q, k, v, out, lse, dout, window=window, kernel=kern)
        again = bwd(q, k, v, out, lse, dout, window=window, kernel=kern)
        row["variants"][kern] = dict(
            bf16_tol_ratio=rt.grads_error_ratio(got, exact, tol16),
            bit_identical=all(torch.equal(a, b) for a, b in zip(got, again)),
            max_abs_err=max(float((a.float() - b.float()).abs().max())
                            for a, b in zip(got, plain)))
        if kern == rule:
            row["equal_to_the_step"] = (
                None if step_grads is None
                else all(torch.equal(a, b) for a, b in zip(got, step_grads)))
        del got, again
    mine = row["variants"][rule]
    row.update(bf16_tol_ratio=mine["bf16_tol_ratio"], max_abs_err=mine["max_abs_err"],
               bit_identical=all(r["bit_identical"] for r in row["variants"].values()))
    step_equal = row["equal_to_the_step"]
    row["broken_variant_ratios"] = {
        key: rt.grads_error_ratio(bad, exact, tol16)
        for key, bad in bwd_variants(rt, q, k, v, out, lse, dout, window).items()}
    del plain, exact, tol16
    q32, k32, v32, d32 = (t[:1].float().mul_(1 + (torch.rand(
        t[:1].shape, generator=g, device=t.device) - 0.5) * 2**-8) for t in (q, k, v, dout))
    o32, lse32 = rt.fa_forward(q32, k32, v32, window, None)
    exact, tol32, _ = rt.attention_grads_f64(q32, k32, v32, d32, window=window)
    got32 = bwd(q32, k32, v32, o32, lse32, d32, window=window)  # the rule's: CUDA-core
    row["fp32_bound_ratio"] = rt.grads_error_ratio(got32, exact, tol32)
    row["fp32_max_abs_err"] = max(
        float((a - b).abs().max())
        for a, b in zip(got32, ref(q32, k32, v32, o32, lse32, d32, window=window)))
    del got32
    with tf32_matmuls():
        row["tf32_bound_ratio"] = rt.grads_error_ratio(
            ref(q32, k32, v32, o32, lse32, d32, window=window), exact, tol32)
    del exact, tol32
    log(f"train (b) {name}: {json.dumps(row)}")
    if not (all(r["bf16_tol_ratio"] <= 1.0 for r in row["variants"].values())
            and row["plain_bf16_tol_ratio"] <= 1.0):
        raise AssertionError(f"train (b) {name}: outside the bf16 tolerance: {row}")
    if not row["bit_identical"]:
        raise AssertionError(f"train (b) {name}: two runs of a backward kernel differ")
    if step_equal is False:
        raise AssertionError(f"train (b) {name}: the kernel on the captured inputs "
                             "differs from the step's own gradients")
    for key, r in row["broken_variant_ratios"].items():
        if not r > 1.0:
            raise AssertionError(f"train (b) {name}: the broken variant {key} passes "
                                 f"({r} x)")
    real_check(f"train (b) {name}", row["fp32_bound_ratio"], row["tf32_bound_ratio"])
    return row


def bwd_times(rt, q, k, v, out, lse, dout, window,
              kernels=("tensor_core", "cuda_core")) -> dict:
    """K6's backward on these inputs, back to back: each of ``kernels``
    forced with ``kernel=`` (``time_ms``: device ms and wall ms a call), the
    plain version, sdpa's backward on the same q, k, v and output gradient
    (heads first, causal, with the window as an explicit mask when there is
    one; never called by the port), and the bound: five products at 2 hd
    flops a visible (query, key) pair at the peak of the inputs' dtype,
    against q, k, v, out, dout and the three gradients read or written once
    and lse once."""
    bwd, ref = rt.flash_attention_bwd, rt.flash_attention_bwd_ref
    reps = [(q, k, v, out, lse, dout)] * 20
    out_ = {}
    for kern in kernels:
        n = 20 if kern == "tensor_core" else 5
        out_[f"{kern}_ms"], out_[f"{kern}_wall_ms"] = time_ms(
            lambda *a, kern=kern: bwd(*a, window=window, kernel=kern), reps[:n])
    plain = time_ms(lambda *a: ref(*a, window=window), reps[:3])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, Sq, Hq, hd = q.shape
    mask = (dict(attn_mask=rt.attention_mask(Sq, k.shape[1], window, q.device))
            if window > 0 else dict(is_causal=True))
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    oh = sdpa(qh, kh, vh, enable_gqa=True, **mask)
    dh = dout.transpose(1, 2).contiguous()
    lib = time_ms(lambda: torch.autograd.grad(oh, (qh, kh, vh), dh, retain_graph=True),
                  [()] * 20)
    del qh, kh, vh, oh, dh, mask
    fl = 10.0 * hd * B * Hq * lm_pairs(Sq, k.shape[1], window)
    byt = (4 * q.numel() + 4 * k.numel()) * q.element_size() + 4 * lse.numel()
    bnd = bound(byt, fl, BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS)
    return dict(out_, plain_ms=plain[0], library_ms=lib[0], bound_ms=bnd[0],
                bound_by=bnd[1], flops=fl, bytes=byt, dtype=str(q.dtype).split(".")[-1])


def train_check_c(rt, cap, params, state, opt):
    """(c) after step 0, against a float64 AdamW of the same gradients:
    the grad norm within 1e-4 (relative; a sum of 1.7e9 squares in fp32,
    its serial runs a few thousand terms long), and the sampled leaves'
    params, m and v within the first-order fp32 bound of the update's
    arithmetic given the step's clip scale:

        m: 5u|m| + 4e   v: 8u|v| + 4e   p: u (lr (36 |d| + 6 |wd p|) + |p'|)

    (d = mhat / (sqrt(vhat) + eps); the clip scale, each constant's fp32
    rounding, the bias corrections' cancellation 1 - b^1 and each product,
    quotient, sqrt and sum rounded once; e = 2^-150, what a rounding into
    fp32's subnormal range may add: the embedding's gradient for tokens the
    softmax gives almost no weight is subnormal, and its square underflows
    to 0)."""
    U, E = 2.0**-24, 2.0**-150
    g32 = float(cap["gnorm32"])
    out = dict(grad_norm=g32, grad_norm_f64=cap["gnorm64"],
               grad_norm_rel_err=abs(g32 - cap["gnorm64"]) / cap["gnorm64"], leaves={})
    scale = min(1.0, opt.clip_norm / max(g32, 1e-9))
    named_p, named_m, named_v = (rt.tree.named(t) for t in (params, state["m"], state["v"]))
    worst = 0.0
    for name in TR_SAMPLED:
        p0, g = cap["p"][name].double(), cap["g"][name].double() * scale
        m = (1 - opt.b1) * g
        v = (1 - opt.b2) * g * g
        d = (m / (1 - opt.b1)) / ((v / (1 - opt.b2)).sqrt() + opt.eps)
        p1 = p0 - opt.lr * (d + opt.weight_decay * p0)
        tol = dict(m=5 * U * m.abs() + 4 * E, v=8 * U * v.abs() + 4 * E,
                   p=U * (opt.lr * (36 * d.abs() + 6 * (opt.weight_decay * p0).abs())
                          + p1.abs()))
        got = dict(m=named_m[name], v=named_v[name], p=named_p[name].detach())
        want = dict(m=m, v=v, p=p1)
        r = {}
        for key in ("p", "m", "v"):
            err = (got[key].double() - want[key]).abs()
            r[key] = float(torch.where(err == 0, 0.0, err / tol[key]).max())
        out["leaves"][name] = r
        worst = max(worst, *r.values())
        del p0, g, m, v, d, p1, tol, got, want
    log(f"train (c): {json.dumps(out)}")
    if not out["grad_norm_rel_err"] <= 1e-4:
        raise AssertionError(f"train (c): grad norm {g32} vs float64 {cap['gnorm64']}")
    if not worst <= 1.0:
        raise AssertionError(f"train (c): {worst} x the fp32 bound of the update")
    return out


def train_resume(rt, cfg, params, losses, step_fn, seed, dev):
    """(d): the state after step ``TR_STEPS - 1`` was saved through
    ``CheckpointManager`` in the reference's names and the run went on in
    memory; this restores it into fresh tensors and runs the same steps,
    whose losses and params must equal the uninterrupted run's bit for bit.
    Both runs are under :func:`deterministic`."""
    like = rt.tree.map_(lambda t: t.detach(), params)  # the structure only
    t0 = time.perf_counter()
    rp, rs, manifest = rt.train_cli.restore_train_state(
        rt.CheckpointManager(str(TR_DIR / "train_4k")), like,
        {"m": like, "v": like, "step": torch.zeros((), dtype=torch.int32)}, dev)
    del like
    t_restore = sync_now() - t0
    resumed = {}
    with deterministic():
        for step in range(manifest["step"], TR_STEPS + TR_RESUME_STEPS):
            rp, rs, m = step_fn(rp, rs, train_batch(rt, cfg, step, seed))
            resumed[step] = float(m["loss"])
    same_losses = all(resumed[s] == losses[s] for s in resumed)
    same_params = all(torch.equal(a, b) for a, b in zip(rt.tree.leaves(rp),
                                                        rt.tree.leaves(params)))
    return dict(resumed_from=manifest["step"], restore_s=t_restore, losses=resumed,
                losses_equal=same_losses, params_equal=same_params)


def start_train_subprocesses(root) -> tuple:
    """(e) the launcher and the example as a user runs them, on the card,
    the two at once; started while (d) restores its checkpoint (neither is
    timed) and waited for by :func:`wait_train_subprocesses`."""
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    cmds = {
        "launch.train": [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                         "internlm2-1.8b", "--steps", "30", "--microbatches", "2",
                         "--compress", "bf16", "--ckpt-dir", str(TR_DIR / "cli")],
        "torch_train_lm": [sys.executable, str(root / "examples" / "torch_train_lm.py")],
    }
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True, env=env, cwd=str(root))
             for name, cmd in cmds.items()}
    return procs, t0


def stop_processes(procs) -> None:
    for p in procs.values():
        if p.poll() is None:
            p.kill()
        p.communicate()


def wait_train_subprocesses(procs, t0) -> dict:
    """Each of (e)'s processes exits 0 with a ``loss a -> b OK`` line."""
    out = {}
    for name, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            stop_processes(procs)
            raise
        wall = time.perf_counter() - t0
        lines = stdout.strip().splitlines()
        for line in lines[:2] + lines[-3:]:
            log(f"train (e) {name}: {line}")
        ok = sum(bool(ln.startswith("loss ") and ln.endswith(" OK")) for ln in lines)
        if p.returncode != 0 or ok < 1:
            stop_processes(procs)
            raise AssertionError(f"train (e) {name}: exit {p.returncode}, {ok} OK lines\n"
                                 f"{stdout[-2000:]}\n{stderr[-4000:]}")
        out[name] = dict(wall_s=wall, ok_lines=ok, last=lines[-1])
        log(f"train (e) {name}: exit 0, {wall:.1f} s from the start of both")
    return out


def train_phase(rt, args, dev, kernels, t_start):
    """internlm2-1.8b at full width and depth trained on the card: the
    ``train_4k`` step (AdamW, weight decay 0.1, no compression) at seq 4096,
    the batch cut from 256 to 4 in 2 microbatches, ``remat="dots"``, K6's
    forward and kernel backward in every layer. Checks (a)-(e); times the
    steps, both K6 backward variants at the step's layer shape; adds the
    ``flashattn_bwd`` and ``flashattn_bwd_cuda_core`` rows to the kernels
    line."""
    t_phase = time.perf_counter()
    cfg = train_cfg(rt)
    opt = rt.AdamWConfig(weight_decay=0.1)
    cut = time.perf_counter() - t_start + TR_BUDGET_S > TR_LATEST_END_S
    timed_from = TR_STEPS - 2 if cut else 2
    free = shutil.disk_usage(TR_DIR.parent if TR_DIR.parent.exists()
                             else Path(__file__).resolve().parent).free
    need = 3 * 4 * cfg.param_count() * 1.2
    if free < need:
        raise AssertionError(f"train (d): {free / 2**30:.1f} GiB free on the disk, "
                             f"{need / 2**30:.1f} GiB needed")
    shutil.rmtree(TR_DIR, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = sync_now()
    params = rt.init_params(cfg.param_specs(),
                            torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    t_init = sync_now() - t0
    predicted = train_peak_gib(cfg)
    log(f"train: starts at {t_phase - t_start:.0f} s; {cfg.name}, {cfg.n_layers} layers "
        f"(full depth), {cfg.param_count()} parameters drawn on the card in {t_init:.3f} s "
        f"(fp32 master weights, {4 * cfg.param_count() / 2**30:.3f} GiB); bf16 compute, "
        f"remat {cfg.remat}, attn {cfg.attn_impl}; {TR_BATCH} x {TR_SEQ} tokens a step "
        f"(train_4k's batch {rt.lm.TRAIN_4K['batch']} cut to {TR_BATCH}) in {TR_MICRO} "
        f"microbatches; disk "
        f"{free / 2**30:.1f} GiB free; peak predicted {predicted:.1f} GiB"
        + ("; cut: steps 2 untimed" if cut else ""))
    check_a = train_check_a(rt, params, cfg, train_batch(rt, cfg, 0, args.seed), dev)
    gc.collect()
    torch.cuda.empty_cache()

    state = rt.train_state(params)
    step_fn = rt.make_train_step(lambda p, b: rt.tfm.loss_fn(p, cfg, b, device=dev), opt,
                                 microbatches=TR_MICRO)
    # step 0: layer 0's K6 inputs for the first microbatch, then the step
    # with hooks on its gradients (the same step, its loss hooked)
    batch0 = train_batch(rt, cfg, 0, args.seed)
    k6_in = layer0_k6_inputs(rt, params, cfg, batch0["tokens"][:TR_BATCH // TR_MICRO], dev)
    gc.collect()
    torch.cuda.empty_cache()
    named = rt.tree.named(params)
    cap = {"p": {n: named[n].detach().clone() for n in TR_SAMPLED}}
    capture = Step0Capture(rt, params, cfg, dev)
    try:
        t0 = sync_now()
        params, state, m0 = rt.make_train_step(capture.loss_fn, opt, microbatches=TR_MICRO)(
            params, state, batch0)
        t_step0 = sync_now() - t0
    finally:
        capture.close()
    cap["g"] = {n: capture.grads[n] for n in TR_SAMPLED}
    cap["gnorm64"] = math.sqrt(sum(float(x.double().square().sum())
                                   for x in capture.grads.values()))
    cap["gnorm32"] = m0["grad_norm"]
    cap["bwd"] = k6_in[:5] + (capture.k6["dout"], k6_in[5])
    cap["step_grads"] = capture.k6["dqkv"]
    del capture, named, k6_in
    losses = {0: float(m0["loss"])}
    check_c = train_check_c(rt, cap, params, state, opt)
    del cap["p"], cap["g"]
    gc.collect()
    torch.cuda.empty_cache()
    # step 1, traced: where a step's device time goes
    wall1 = [0.0]

    def step1():
        nonlocal params, state
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, train_batch(rt, cfg, 1, args.seed))
        losses[1] = float(m["loss"])
        wall1[0] = time.perf_counter() - t0

    ev, busy = device_trace(step1)
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:12]
    log(f"trace train step: device busy {busy} s of {wall1[0]} s wall (idle share "
        f"{1 - busy / wall1[0]}); {sum(e.count for e in ev)} kernels; top device time: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3} ms x{e.count}"
                    for e in top))
    # steps 2-4: the main path's counted run, timed, in torch's default mode
    rt.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    walls = {}
    for step in range(2, TR_STEPS):
        t0 = sync_now()
        params, state, m = step_fn(params, state, train_batch(rt, cfg, step, args.seed))
        losses[step] = float(m["loss"])
        walls[step] = sync_now() - t0
    launches = rt.counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    timed = [walls[s] for s in range(timed_from, TR_STEPS)]
    ms = sum(timed) / len(timed) * 1e3
    flops = rt.lm.lm_model_flops(cfg, TR_BATCH, TR_SEQ, "train")
    steps_run = TR_STEPS - 2
    # (d): save after step 4, run steps 5-6 on, then again from the checkpoint
    t0 = time.perf_counter()
    rt.CheckpointManager(str(TR_DIR / "train_4k")).save(TR_STEPS,
                                                        rt.tree.named((params, state)))
    save_s = time.perf_counter() - t0
    with deterministic():
        for step in range(TR_STEPS, TR_STEPS + TR_RESUME_STEPS):
            params, state, m = step_fn(params, state, train_batch(rt, cfg, step, args.seed))
            losses[step] = float(m["loss"])
    out_timed = dict(step0_s=t_step0, ms_a_step=ms, timed_steps=list(range(timed_from, TR_STEPS)),
                     tokens_s=TR_BATCH * TR_SEQ / ms * 1e3,
                     model_tflops=flops / ms / 1e9, losses=losses,
                     save_s=save_s, peak_gib=peak, peak_predicted_gib=predicted,
                     launches={k: v for k, v in launches.items() if v}, cut=cut)
    log(f"train timed: {json.dumps(out_timed)}")
    per_step = cfg.n_layers * TR_MICRO
    if launches["flashattn_bwd"] != per_step * steps_run:
        raise AssertionError(f"train: K6 backward launched {launches['flashattn_bwd']} "
                             f"times in {steps_run} steps, not {per_step} a step")
    if (launches["flashattn_bwd.tensor_core"] != launches["flashattn_bwd"]
            or launches["flashattn_bwd.cuda_core"]):  # bf16 at hd 128: the rule's
        raise AssertionError("train: the timed steps' K6 backward did not run on the "
                             f"tensor-core kernel alone: {launches}")
    if launches["flashattn"] != 2 * per_step * steps_run:  # remat runs it again
        raise AssertionError(f"train: K6 forward launched {launches['flashattn']} times")
    if not all(math.isfinite(x) for x in losses.values()):
        raise AssertionError(f"train: losses {losses}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    children = start_train_subprocesses(Path(__file__).resolve().parent)
    try:
        check_d = train_resume(rt, cfg, params, losses, step_fn, args.seed, dev)
        log(f"train (d): {json.dumps(check_d)}")
        check_e = wait_train_subprocesses(*children)
    except BaseException:
        stop_processes(children[0])
        raise
    if not (check_d["losses_equal"] and check_d["params_equal"]):
        raise AssertionError("train (d): the resumed run differs from the uninterrupted one")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (b) K6's backward on layer 0's captured inputs, and at gemma3-4b's
    # local-layer shape on seeded inputs
    g = torch.Generator(device=dev).manual_seed(args.seed + 7)
    q, k, v, o, lse, dout, window = cap["bwd"]
    check_b = {"layer0": bwd_kernel_check(rt, "layer 0", q, k, v, o, lse, dout, window, g,
                                          step_grads=cap.pop("step_grads"))}
    gl = TR_GEMMA_LOCAL
    x = [torch.randn((gl["B"], gl["S"], h, gl["hd"]), generator=g, device=dev)
         for h in (gl["Hq"], gl["Hkv"], gl["Hkv"], gl["Hq"])]
    x[0] = x[0] / x[0].square().mean(-1, keepdim=True).sqrt()
    x[1] = x[1] / x[1].square().mean(-1, keepdim=True).sqrt()
    lq, lk, lv, ld = (t.bfloat16() for t in x)
    lo, llse = rt.fa_forward(lq, lk, lv, gl["window"], None)
    check_b["gemma_local"] = bwd_kernel_check(rt, "gemma3-4b local", lq, lk, lv, lo,
                                              llse, ld, gl["window"], g)
    del x, lq, lk, lv, ld, lo, llse

    # K6 backward timed at the step's layer shape: both variants forced on
    # the step's bf16 inputs (an A/B: the rule sends these to the tensor-core
    # kernel alone), the plain version and sdpa's backward on the same inputs
    # (never called by the port); then the CUDA-core kernel on fp32 copies of
    # them, the inputs its own path gives it ((a)'s fp32 run, same shape)
    t = bwd_times(rt, q, k, v, o, lse, dout, window)
    q32, k32, v32, d32 = (x.float() for x in (q, k, v, dout))
    o32, lse32 = rt.fa_forward(q32, k32, v32, window, None)
    t32 = bwd_times(rt, q32, k32, v32, o32, lse32, d32, window, kernels=("cuda_core",))
    del q32, k32, v32, d32, o32, lse32
    B, Sq, Hq, hd = q.shape
    common = dict(route="cuda", replaces="src/repro/kernels/flashattn/kernel.py:80",
                  replaces_note="K6's gradient: the TPU kernel has no VJP (the reference "
                                "differentiates its XLA attention); no TPU counterpart",
                  library="scaled_dot_product_attention backward",
                  shape=[B, Sq, Hq, k.shape[2], hd])

    def timed(tt, kern):
        return dict(ms=tt[f"{kern}_ms"], wall_ms=tt[f"{kern}_wall_ms"],
                    plain_ms=tt["plain_ms"], library_ms=tt["library_ms"],
                    bound_ms=tt["bound_ms"], bound_by=tt["bound_by"], dtype=tt["dtype"],
                    flops=tt["flops"], bytes=tt["bytes"],
                    tflops=tt["flops"] / tt[f"{kern}_ms"] / 1e9)

    def worst(kern, key):
        return max(r["variants"][kern][key] for r in check_b.values())

    row = dict(name="flashattn_bwd", source="src/repro_torch/csrc/flashattn_bwd_tc.cu",
               variant="tensor_core", launches=launches["flashattn_bwd.tensor_core"],
               max_abs_err=worst("tensor_core", "max_abs_err"),
               bf16_tol_ratio=worst("tensor_core", "bf16_tol_ratio"),
               **timed(t, "tensor_core"), **common)
    row.update(bf16_peak_share=row["tflops"] / (BF16_FLOPS / 1e12),
               step_share=row["ms"] * per_step / out_timed["ms_a_step"])
    ab = timed(t, "cuda_core")
    cc = dict(name="flashattn_bwd_cuda_core", source="src/repro_torch/csrc/flashattn_bwd.cu",
              variant="cuda_core",
              launches=check_a["k6_backward_launches"]["chunked_fp32"]["cuda_core"],
              launches_path="train (a): loss_fn in fp32 with chunked attention at "
                            f"{TR_CHECK_LAYERS} layers (the rule's variant for fp32); the "
                            "timed bf16 steps launch it 0 times",
              max_abs_err=max(r["fp32_max_abs_err"] for r in check_b.values()),
              fp32_bound_ratio=max(r["fp32_bound_ratio"] for r in check_b.values()),
              tf32_bound_ratio=min(r["tf32_bound_ratio"] for r in check_b.values()),
              **timed(t32, "cuda_core"), **common)
    cc.update(fp32_peak_share=cc["tflops"] / (FP32_FLOPS / 1e12),
              forced_bf16_ab=dict(
                  note="forced with kernel='cuda_core' on the tensor-core row's bf16 "
                       "inputs, which no path sends it: an A/B figure, apart from "
                       "this row's launches and time",
                  ms=ab["ms"], wall_ms=ab["wall_ms"], tflops=ab["tflops"],
                  bf16_tol_ratio=worst("cuda_core", "bf16_tol_ratio"),
                  max_abs_err=worst("cuda_core", "max_abs_err")))
    log(f"flashattn_bwd: tensor-core {row['ms']} ms back to back at the step's "
        f"layer shape {row['shape']} ({row['wall_ms']} ms wall, "
        f"{row['tflops']:.2f} TFLOP/s, {row['bf16_peak_share']:.4f} of the bf16 peak); "
        f"CUDA-core forced on the same bf16 inputs {ab['ms']} ms "
        f"({ab['tflops']:.2f} TFLOP/s); plain {t['plain_ms']} ms; sdpa backward "
        f"{t['library_ms']} ms; bound {t['bound_ms']} ms by {t['bound_by']} "
        f"({t['flops'] / 1e9:.2f} GFLOP); {per_step} a step: "
        f"{row['step_share']:.3f} of the step. In fp32: CUDA-core {cc['ms']} ms "
        f"({cc['tflops']:.2f} TFLOP/s, {cc['fp32_peak_share']:.4f} of the fp32 peak); "
        f"plain {t32['plain_ms']} ms; sdpa backward {t32['library_ms']} ms; bound "
        f"{t32['bound_ms']} ms by {t32['bound_by']}")
    kernels.extend((row, cc))
    fa = next((r for r in kernels if r["name"] == "flashattn"), None)
    if fa is not None:
        fa["train_launches"] = launches["flashattn"]
    del q, k, v, o, lse, dout, cap
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(TR_DIR, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    log(f"train: phase {wall:.1f} s against a budget of {TR_BUDGET_S} s")
    return dict(timed=out_timed, a=check_a, b=check_b, c=check_c, d=check_d, e=check_e,
                bwd=t, bwd_fp32=t32, wall_s=wall)


# ---------------------------------------------------------------------------
# the recsys phase (DLRM-rm2, DIN, DIEN, two-tower with its 1M-candidate
# retrieval through the index, GIN-tu; all at full width)
# ---------------------------------------------------------------------------


def rs_rows(batch: dict, rows) -> dict:
    return {k: v[rows] for k, v in batch.items()}


def rs_models(rt) -> dict:
    """The four recsys configurations at full width, with their entry
    points, batch makers and FLOPs a sample (``configs/recsys.py``)."""
    c, m = rt.crec, rt.recsys
    return {
        "dlrm-rm2": dict(cfg=c.DLRM_RM2, loss=m.dlrm_loss, serve=m.dlrm_forward,
                         flops=c.DLRM_FLOPS_PER_SAMPLE, train_b=c.TRAIN_B, chunk=None),
        "din": dict(cfg=c.DIN, loss=m.din_loss, serve=m.din_forward,
                    flops=c.din_flops_per_sample(c.DIN), train_b=c.TRAIN_B,
                    chunk=RS_CHUNK),
        "dien": dict(cfg=c.DIEN, loss=m.din_loss, serve=m.din_forward,
                     flops=c.dien_flops_per_sample(c.DIEN), train_b=c.TRAIN_B,
                     chunk=RS_CHUNK),
        "two-tower-retrieval": dict(cfg=c.TWO_TOWER, loss=m.twotower_loss,
                                    serve=m.pair_score, flops=c.TWOTOWER_SERVE_FLOPS,
                                    train_b=RS_TT_TRAIN_B, chunk=None),
    }


def rs_serve_batch(rt, name, cfg, shape, b, seed, g, cache) -> dict:
    """The batch of a serve shape: the port's numpy generators where the
    host is quick (serve_p99; two-tower's uniform ids at every size), the
    same distributions drawn on the card for the bulk and candidate shapes
    of the Zipf-id models. DIN and DIEN share theirs (``cache``)."""
    dev = g.device
    if name == "two-tower-retrieval":
        bt = rt.twotower_batch(b, cfg.n_user_fields, cfg.n_item_fields,
                               cfg.vocab_per_field, seed=seed + b)
        if shape == "retrieval_cand":
            bt = {"user_ids": bt["user_ids"][:1], "cand_ids": bt["item_ids"]}
        return {k: torch.as_tensor(v, device=dev) for k, v in bt.items()}
    key = ("din" if name in ("din", "dien") else name, shape)
    if key not in cache:
        if shape == "serve_p99" and name == "dlrm-rm2":
            cache[key] = rt.dlrm_batch(b, cfg.n_dense, cfg.n_sparse, cfg.vocab_per_field,
                                       seed=seed + 11)
        elif shape == "serve_p99":
            cache[key] = rt.din_batch(b, cfg.seq_len, cfg.vocab, seed=seed + 12)
        elif name == "dlrm-rm2":
            cache[key] = rt.crec.dlrm_batch_on(cfg, b, g)
        else:
            cache[key] = rt.crec.din_batch_on(cfg, b, g)
        cache[key] = {k: torch.as_tensor(v, device=dev)
                      for k, v in cache[key].items() if k != "label"}
    return cache[key]


def rs_forward(rt, spec, shape):
    """The serve shape's entry point: two-tower's retrieval_cand scores one
    user against every candidate; every other shape scores its rows
    (``chunk`` rows a call for DIN and DIEN)."""
    if shape == "retrieval_cand" and spec["cfg"].name == "two-tower-retrieval":
        return lambda params, cfg, batch, dev: rt.recsys.twotower_score(
            params, cfg, batch, device=dev)
    fn, step = spec["serve"], spec["chunk"]

    def run(params, cfg, batch, dev):
        n = len(next(iter(batch.values())))
        if not step or step >= n:
            return fn(params, cfg, batch, device=dev)
        return torch.cat([fn(params, cfg, rs_rows(batch, slice(s, s + step)), device=dev)
                          for s in range(0, n, step)])

    return run


def rs_check_rows(n: int, seed: int, dev) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randperm(n, generator=g)[:RS_SAMPLED].sort().values.to(dev)


def rs_serve_check(rt, run, params, p64, cfg, batch, out, shape, seed, dev) -> dict:
    """(a): ``RS_SAMPLED`` rows of the fp32 output against the same port
    function in float64 (params and inputs cast), within the
    configuration's ``RS_LIMIT_U``; the same rows in TF32 must exceed it."""
    retrieval = "cand_ids" in batch
    n = out.shape[0]
    rows = rs_check_rows(n, seed, dev)
    sub = ({"user_ids": batch["user_ids"], "cand_ids": batch["cand_ids"][rows]}
           if retrieval else rs_rows(batch, rows))
    sub64 = {k: v.double() if v.is_floating_point() else v for k, v in sub.items()}
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    y64 = run(p64, cfg64, sub64, dev).double()
    with tf32_matmuls():
        ytf = run(params, cfg, sub, dev).double()
    limit = RS_LIMIT_U[cfg.name] * 2.0**-24 * max(1.0, float(y64.abs().max()))
    err = float((out[rows].double() - y64).abs().max())
    err_tf = float((ytf - y64).abs().max())
    ratio, tf32_ratio = real_check(f"{cfg.name} {shape} (a)", err / limit, err_tf / limit)
    return dict(err=err, limit=limit, ratio=ratio, tf32_err=err_tf, tf32_ratio=tf32_ratio)


def rs_finite(what, *tensors):
    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{what} (c): a value is not finite")


def rs_top(ev, n: int = 4) -> list:
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:n]
    return [f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for e in top]


def rs_traced(fn) -> dict:
    """``device_ms`` (the profiler's busy time), ``top`` and ``kernels`` of
    one extra call of ``fn`` when ``RS_TRACES``, else nothing."""
    if not RS_TRACES:
        return {}
    ev, busy = device_trace(fn)
    return dict(device_ms=busy * 1e3, top=rs_top(ev), kernels=sum(e.count for e in ev))


def rs_line(what, wall_s, samples, flops, peak, **extra) -> dict:
    out = dict(wall_ms=wall_s * 1e3, samples_s=samples / wall_s,
               tflops=flops / wall_s / 1e12, peak_gib=peak, **extra)
    log(f"recsys {what}: {json.dumps(out)}")
    return out


def rs_same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def rs_train(rt, what, init, step_fn, batch, samples, flops, timed_steps) -> dict:
    """A train shape: (b) one step from ``init()``'s fresh state under
    ``deterministic()``, the same step again from a second fresh state:
    params, m and v bit for bit; (c) loss and grad norm finite; then
    ``timed_steps`` steps in torch's default mode and one traced."""
    walls = []

    def det_step():
        params = init()
        state = rt.train_state(params)
        with deterministic():
            t0 = sync_now()
            params, state, m = step_fn(params, state, batch)
            walls.append(sync_now() - t0)
        return params, state, m

    params, state, m0 = det_step()
    p2, s2, _ = det_step()
    equal = all(rs_same(rt.tree.leaves(a), rt.tree.leaves(b)) for a, b in (
        (params, p2), (state["m"], s2["m"]), (state["v"], s2["v"])))
    del p2, s2
    if not equal:
        raise AssertionError(f"{what} (b): two runs of the step differ")
    rs_finite(what, m0["loss"], m0["grad_norm"])
    gc.collect()  # the cache keeps its blocks: the timed steps reuse them
    torch.cuda.reset_peak_memory_stats()
    timed = []
    for _ in range(timed_steps):
        t0 = sync_now()
        params, state, m = step_fn(params, state, batch)
        timed.append(sync_now() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    rs_finite(what, m["loss"], m["grad_norm"])

    def traced():
        nonlocal params, state
        params, state, _ = step_fn(params, state, batch)

    wall = sum(timed) / len(timed)
    out = rs_line(f"{what} train step", wall, samples, flops * samples, peak,
                  deterministic_ms=[w * 1e3 for w in walls],
                  default_ms=[w * 1e3 for w in timed], loss=float(m0["loss"]),
                  grad_norm=float(m0["grad_norm"]), rerun_bit_identical=equal,
                  **rs_traced(traced))
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def rs_recsys_model(rt, name, spec, seed, cut, dev, cache) -> tuple:
    """Every shape of one recsys configuration: serve_p99, serve_bulk,
    retrieval_cand (forward only, each with (a) and (c)), then
    train_batch ((b), (c)). Returns (lines, two-tower's params or None)."""
    cfg = spec["cfg"]
    g = torch.Generator(device=dev).manual_seed(seed + 101)
    crec = rt.crec

    def init():
        return rt.init_params(cfg.param_specs(),
                              torch.Generator(device=dev).manual_seed(seed), device=dev)

    t0 = sync_now()
    params = init()
    log(f"recsys {name}: {cfg.param_count()} parameters "
        f"({4 * cfg.param_count() / 2**30:.3f} GiB fp32) drawn in {sync_now() - t0:.3f} s")
    lines = {}
    p64 = {k: v.double() for k, v in params.items()}
    serve_flops = spec["flops"]
    for shape, b in (("serve_p99", crec.P99_B), ("serve_bulk", crec.BULK_B),
                     ("retrieval_cand", crec.CAND_N)):
        batch = rs_serve_batch(rt, name, cfg, shape, b, seed, g, cache)
        run = rs_forward(rt, spec, shape)
        flops = (crec.TWOTOWER_RETRIEVAL_FLOPS
                 if shape == "retrieval_cand" and "cand_ids" in batch else serve_flops)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            t0 = sync_now()
            out = run(params, cfg, batch, dev)
            wall = sync_now() - t0
            if tuple(out.shape) != (b,):
                raise AssertionError(f"{name} {shape}: output {tuple(out.shape)}")
            rs_finite(f"{name} {shape}", out)
            a = rs_serve_check(rt, run, params, p64, cfg, batch, out, shape, seed, dev)
            del out
            if shape == "serve_p99":  # its first call's wall is mostly set-up
                t0 = sync_now()
                run(params, cfg, batch, dev)
                wall = sync_now() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            traced = rs_traced(lambda: run(params, cfg, batch, dev))
        lines[shape] = rs_line(f"{name} {shape}", wall, b, b * flops, peak, batch=b, a=a,
                               **traced)
        del batch
    del p64
    gc.collect()
    torch.cuda.empty_cache()
    tt = params if name == "two-tower-retrieval" else None
    del params
    b = spec["train_b"]
    if name == "two-tower-retrieval":
        batch = rt.twotower_batch(b, cfg.n_user_fields, cfg.n_item_fields,
                                  cfg.vocab_per_field, seed=seed + 13)
        flops = crec.twotower_train_flops(b)
    elif name == "dlrm-rm2":
        batch = rt.dlrm_batch(b, cfg.n_dense, cfg.n_sparse, cfg.vocab_per_field,
                              seed=seed + 14)
        flops = 3.0 * serve_flops
    else:
        if ("din", "train_batch") not in cache:
            cache[("din", "train_batch")] = rt.din_batch(b, cfg.seq_len, cfg.vocab,
                                                         seed=seed + 15)
        batch = cache[("din", "train_batch")]
        flops = 3.0 * serve_flops
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    loss = spec["loss"]
    step_fn = rt.make_train_step(lambda p, bb: loss(p, cfg, bb, device=dev),
                                 rt.AdamWConfig())
    lines["train_batch"] = rs_train(rt, f"{name} train_batch (B {b})", init, step_fn,
                                    batch, b, flops, 1 if cut else 2)
    lines["train_batch"]["batch"] = b
    return lines, tt


def rs_gin_batch(rt, shape: str, seed: int, dev) -> tuple:
    """gin-tu's ``shape`` as a padded batch on the card
    (``configs.gnn.gin_batch``), its edges then sorted both ways
    (``gnn.prepare``, timed)."""
    batch, sizes = rt.cgnn.gin_batch(shape, seed, dev, prepare=False)
    t0 = sync_now()
    batch = rt.gnn.prepare(batch, device=dev)
    return batch, dict(sizes, prepare_s=sync_now() - t0)


def rs_gin(rt, seed, dev) -> tuple:
    """gin-tu at its four shapes, one training step each (checked, then
    timed). Returns (lines, ogb_products' batch for the segsum check)."""
    lines, ogb = {}, None
    for shape in rt.cgnn.SHAPES:
        t0 = sync_now()
        batch, sizes = rs_gin_batch(rt, shape, seed, dev)
        sizes["data_s"] = sync_now() - t0
        cfg = rt.cgnn.gin_config(shape)

        def init(cfg=cfg):
            return rt.init_params(cfg.param_specs(),
                                  torch.Generator(device=dev).manual_seed(seed), device=dev)

        step_fn = rt.make_train_step(
            lambda p, b, cfg=cfg: rt.gnn.loss_fn(p, cfg, b, device=dev), rt.AdamWConfig())
        pad = sizes["padded"]
        flops = 3.0 * rt.cgnn.gin_flops(cfg, pad["nodes"], pad["edges"])
        lines[shape] = rs_train(rt, f"gin-tu {shape}", init, step_fn, batch, 1, flops, 1)
        lines[shape].update(sizes)
        if shape == "ogb_products":
            ogb = batch
        else:
            del batch
        gc.collect()
        torch.cuda.empty_cache()
    return lines, ogb


def rs_retrieval(rt, params, cfg, seed, dev) -> dict:
    """(d): two-tower's 1M candidates through the port's index. The item
    tower over the candidate id rows gives (1M, 256) L2-normalised rows;
    ``build_tree`` (fanouts 32 x 32, Lloyd-refined twice), ``build_index``
    (fp32 wire) and ``batch_search`` of 1,024 users' embeddings at k = 10,
    probes 1 and 3, ``impl="pallas"`` (K1) and ``"fused"`` (K2): overflow
    0, the two impls bit-identical, each user's ids a float64 brute force
    over the rows of the leaves it probed, by (distance, row), up to ties
    fp32 cannot order, distances within fp32's bound of the float64 ones
    (``rs_brute_force``; P1's 1e-6 x ||q||^2 printed beside it). Recall@10
    against the exact dense top-10 (dot product over every candidate) and
    ``pairs`` as a share of the dense count are printed, not gated."""
    crec = rt.crec
    cand = rt.twotower_batch(crec.CAND_N, cfg.n_user_fields, cfg.n_item_fields,
                             cfg.vocab_per_field, seed=seed + 21)["item_ids"]
    users = rt.twotower_batch(RS_USERS, cfg.n_user_fields, cfg.n_item_fields,
                              cfg.vocab_per_field, seed=seed + 22)["user_ids"]
    with torch.no_grad():
        t0 = sync_now()
        items = rt.recsys.tower(params, cfg, "item", cand, device=dev)
        u = rt.recsys.tower(params, cfg, "user", users, device=dev)
        t_towers = sync_now() - t0
        t0 = sync_now()
        dense = torch.topk(u @ items.T, RS_K, dim=1).indices  # the exact top-10
        t_dense = sync_now() - t0
    t0 = sync_now()
    tree = rt.build_tree(items, RS_FANOUTS, generator=torch.Generator().manual_seed(seed),
                         refine_iters=2, device=dev)
    t_tree = sync_now() - t0
    t0 = sync_now()
    index = rt.build_index(items, tree, wire_dtype=torch.float32, device=dev)
    t_index = sync_now() - t0
    if int(index.overflow) != 0:
        raise AssertionError("recsys (d): index routing overflow")
    leaf_rows = torch.bincount(index.leaves[index.ids >= 0].long(), minlength=index.n_leaves)
    out = dict(towers_s=t_towers, dense_s=t_dense, build_tree_s=t_tree,
               build_index_s=t_index, rows=index.rows,
               leaf_rows=dict(mean=float(leaf_rows.float().mean()),
                              max=int(leaf_rows.max()), empty=int((leaf_rows == 0).sum())))
    row_of = torch.full((crec.CAND_N,), -1, dtype=torch.int64, device=dev)
    valid = index.ids >= 0
    row_of[index.ids[valid].long()] = torch.nonzero(valid)[:, 0]
    for probes in RS_PROBES:
        res = {}
        for impl in ("pallas", "fused"):
            t0 = sync_now()
            r = rt.batch_search(index, tree, u, RS_K, probes=probes, impl=impl,
                                q_cap=RS_Q_CAP, device=dev)
            res[impl] = (r, sync_now() - t0)
            if int(r.q_cap_overflow) != 0:
                raise AssertionError(f"recsys (d) probes {probes} {impl}: q_cap overflow")
        a, b = res["pallas"][0], res["fused"][0]
        if not (torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
                and torch.equal(a.pairs, b.pairs)):
            raise AssertionError(f"recsys (d) probes {probes}: K1 and K2 differ")
        check = rs_brute_force(rt, index, tree, items, u, a, probes, row_of)
        recall = float(torch.tensor([len(set(x) & set(y)) for x, y in zip(
            a.ids.tolist(), dense.tolist())], dtype=torch.float64).mean()) / RS_K
        out[f"probes_{probes}"] = dict(
            pallas_s=res["pallas"][1], fused_s=res["fused"][1], **check,
            recall_at_10=recall, pairs=float(a.pairs),
            pairs_share=float(a.pairs) / (RS_USERS * crec.CAND_N))
    log(f"recsys (d): {json.dumps(out)}")
    return dict(out, index=index, tree=tree, users=u, items=items)


def rs_row_tol(rt, p, u, qn):
    """Float64 distances of the rows ``p`` (Q, k, d) from their users ``u``
    (Q, d), and each one's fp32 bound: the partial ``||p||^2 - 2 p.q``'s
    (``topk_f64``'s), ||q||^2's own sum (gamma_d ||q||^2) and the final
    add's rounding."""
    g = rt.fp32_gamma(u.shape[1])
    pn = p.square().sum(-1)
    part = pn - 2.0 * (p * u[:, None]).sum(-1)
    x = part + qn[:, None]
    tol = (g * (pn + 2.0 * (p.abs() * u.abs()[:, None]).sum(-1)) + 2.0**-24 * part.abs()
           + g * qn[:, None] + 2.0**-24 * x.abs())
    return x, tol


def rs_brute_force(rt, index, tree, items, u, res, probes, row_of) -> dict:
    """Each user's top-10 in float64 over the rows of the leaves it probed
    (``topk_f64`` over the probes' lookup rows, the probe lists merged by
    (distance, row)) against the search's ids and distances. Each
    returned distance lies within its row's fp32 bound (``rs_row_tol``) of
    that row's float64 distance, and the i-th within the user's largest
    bound of the brute force's i-th. Ids may leave the float64 order only
    where fp32 can: a row returned before another, or returned where a
    brute-force row is not, lies within the two rows' own bounds of it;
    at most ``RS_MAX_SWAPS`` positions differ. P1's 1e-6 x ||q||^2, held
    at d = 32, is printed beside (``p1_ratio``): at d = 256 it is tighter
    than fp32's bound."""
    lk = rt.build_lookup(tree, u, probes=probes)
    pd, prow, ptol = rt.topk_f64(index.vecs, index.leaves, lk.vecs, lk.leaves, RS_K,
                                 chunk_rows=RS_F64_ROWS)
    Q, d = u.shape
    ud = u.double()
    qn = ud.square().sum(1)
    slot = lk.qids.long()  # user * probes + probe rank
    full = torch.full((Q * probes, RS_K), math.inf, dtype=torch.float64, device=u.device)
    rows = torch.full((Q * probes, RS_K), -1, dtype=torch.int64, device=u.device)
    full[slot] = pd + qn[slot // probes, None]
    rows[slot] = prow
    full = full.reshape(Q, probes * RS_K)
    rows = rows.reshape(Q, probes * RS_K)
    key = torch.where(rows >= 0, rows, torch.iinfo(torch.int64).max)
    order = torch.argsort(key, dim=1, stable=True)  # by row, then stably by distance
    full, rows = full.gather(1, order), rows.gather(1, order)
    order = torch.argsort(full, dim=1, stable=True)[:, :RS_K]
    bd, brow = full.gather(1, order), rows.gather(1, order)
    bid = torch.where(brow >= 0, index.ids[brow.clamp(min=0)].long(), -1)
    part_tol = torch.zeros(Q, dtype=torch.float64, device=u.device).scatter_reduce(
        0, slot // probes, ptol, reduce="amax")
    fin = torch.isfinite(bd)
    tol = (part_tol + rt.fp32_gamma(d) * qn)[:, None] + 2.0**-24 * torch.where(
        fin, bd, 0.0)
    p1 = 1e-6 * qn[:, None]
    sid = res.ids.long()
    found = sid >= 0
    if not torch.equal(found, bid >= 0):
        raise AssertionError(f"recsys (d) probes {probes}: result counts differ")
    xs, ts = rs_row_tol(rt, items[sid.clamp(min=0)].double(), ud, qn)
    xb, tb = rs_row_tol(rt, items[bid.clamp(min=0)].double(), ud, qn)
    derr = (res.dists.double() - bd).abs()
    own = (res.dists.double() - xs).abs()
    if not (derr[fin] <= tol[fin]).all():
        raise AssertionError(f"recsys (d) probes {probes}: distances off by "
                             f"{float((derr / tol)[fin].max())} x fp32's bound")
    if not (own[fin] <= ts[fin]).all():
        raise AssertionError(f"recsys (d) probes {probes}: a distance is "
                             f"{float((own / ts)[fin].max())} x its row's fp32 bound "
                             f"off its row's")
    # fp32 may order r before s (or return r, not s) only if x_r - x_s <= t_r + t_s
    gap = xs[:, :, None] - xs[:, None, :] - ts[:, :, None] - ts[:, None, :]
    before = torch.ones(RS_K, RS_K, dtype=torch.bool, device=u.device).triu(1)
    out_b = ~(bid[:, :, None] == sid[:, None, :]).any(-1) & (bid >= 0)  # not returned
    gap_b = xs[:, :, None] - xb[:, None, :] - ts[:, :, None] - tb[:, None, :]
    wrong = (((gap > 0) & before & found[:, :, None] & found[:, None, :]).any()
             or ((gap_b > 0) & found[:, :, None] & out_b[:, None, :]).any())
    if bool(wrong):
        raise AssertionError(f"recsys (d) probes {probes}: ids out of the float64 "
                             f"order beyond the two rows' fp32 bounds")
    # every returned id lies in a leaf its user probed
    leaf = index.leaves[row_of[sid.clamp(min=0)]].long()
    probed = rt.probe_leaves(tree, u, probes).long()
    inside = (leaf[:, :, None] == probed[:, None, :]).any(-1) | ~found
    if not bool(inside.all()):
        raise AssertionError(f"recsys (d) probes {probes}: an id outside the probed leaves")
    swaps = int(((sid != bid) & found).sum())
    if swaps > RS_MAX_SWAPS:
        raise AssertionError(f"recsys (d) probes {probes}: {swaps} ids out of the "
                             f"float64 order (at most {RS_MAX_SWAPS})")
    return dict(ids_equal=swaps == 0, near_tie_swaps=swaps,
                ids_not_in_brute_force=int(((~(sid[:, :, None] == bid[:, None, :]).any(-1))
                                            & found).sum()),
                max_dist_err=float(derr[fin].max()),
                fp32_bound_ratio=float((derr / tol)[fin].max()),
                own_bound_ratio=float((own / ts)[fin].max()),
                p1_ratio=float((derr / p1)[fin].max()),
                max_tol=float(tol[fin].max()))


def rs_kernel_checks(rt, rd, launches, kernels, seed) -> None:
    """(e): K1 on one wave of the retrieval's pallas sweep, K2 on its fused
    call and K3 on one of its build's waves, at d = 256 on the towers'
    real-valued rows: each within ``fp32_bound``'s bound of a float64
    oracle, which the plain version in TF32 must break (P5); timed beside
    the plain version, a library yardstick and the bound. The K1, K2 and K3
    rows of the kernels line gain these numbers and the phase's launches."""
    index, tree, u, items = rd["index"], rd["tree"], rd["users"], rd["items"]
    dev, d, k = u.device, u.shape[1], RS_K
    Q = u.shape[0]
    rows = {r["name"]: r for r in kernels}
    lk = rt.build_lookup(tree, u, probes=1)

    # K1: a wave of the probes-1 pallas sweep, its slab as the sweep cuts it
    plan = rt.make_plan(rows=index.rows, n_leaves=index.n_leaves, n_queries=Q,
                        n_shards=1, k=k, probes=1, impl="pallas", q_cap=RS_Q_CAP)
    flk = rt.pad_lookup(lk, rt.lookup_q_total(plan, Q))
    B, qc = plan.block_rows, plan.q_cap
    # the sweep's wave with the most same-leaf pairs (most waves meet few
    # users: 1,024 users over 1,024 leaves)
    nl = index.n_leaves
    real = (index.leaves >= 0) & (index.leaves < nl)
    hq = torch.bincount(lk.leaves.long(), minlength=nl)
    per_row = torch.where(real, hq[index.leaves.long().clamp(0, nl - 1)], 0)
    s = int(per_row[:index.rows // B * B].reshape(-1, B).sum(1).argmax()) * B
    plf = index.leaves[s:s + B]
    slab = rt.leaf_slab(flk.offsets, plf[0], n_entries=index.n_leaves,
                        total_rows=flk.vecs.shape[0], cap=qc)
    st = int(slab.start)
    wave = (index.vecs[s:s + B], plf, flk.vecs[st:st + qc].contiguous(),
            flk.leaves[st:st + qc].contiguous())
    kd, ki = rt.l2_topk(*wave, k=k)
    pdd, pi = rt.l2_topk_ref(*wave, k)
    fin = torch.isfinite(pdd)
    err1 = float((kd - pdd)[fin].abs().max()) if bool(fin.any()) else 0.0
    exact, _, tol = rt.topk_f64(*wave, k)
    kr = rt.topk_error_ratio(kd, ki, wave[0], wave[2], exact, tol)
    with tf32_matmuls():
        tr = rt.topk_error_ratio(*rt.l2_topk_ref(*wave, k), wave[0], wave[2], exact, tol)
    real_check("l2topk recsys", kr, tr)
    pairs = int(rt.count_pairs(wave[1], wave[3]))
    need = int(torch.isin(wave[1], wave[3]).sum())
    matched = int(torch.isin(wave[3], wave[1]).sum())

    def lib_topk(p, plf, q, qlf):
        d2 = torch.where(qlf[:, None] == plf[None, :],
                         torch.addmm((p * p).sum(1)[None, :], q, p.T, alpha=-2.0),
                         torch.inf)
        return torch.topk(d2, k, dim=1, largest=False)

    kern = time_ms(lambda *w: rt.l2_topk(*w, k=k), [wave] * 20)
    plain = time_ms(lambda *w: rt.l2_topk_ref(*w, k), [wave] * 20)
    lib = time_ms(lib_topk, [wave] * 20)
    bnd = bound((need + matched) * d * 4 + (B + qc) * 4 + qc * k * 8, (pairs + need) * 2 * d)
    rows["l2topk"].update(recsys_launches=launches["l2topk"], recsys_shape=[B, qc, d, k],
                          recsys_ms=kern[0], recsys_wall_ms=kern[1], recsys_plain_ms=plain[0],
                          recsys_library_ms=lib[0], recsys_bound_ms=bnd[0],
                          recsys_bound_by=bnd[1], recsys_max_abs_err=err1,
                          recsys_fp32_bound_ratio=kr, recsys_tf32_bound_ratio=tr,
                          recsys_pairs=pairs)

    # K2: the probes-1 fused call, sampled rows against the plain version
    fplan = rt.make_plan(rows=index.rows, n_leaves=index.n_leaves, n_queries=Q,
                         n_shards=1, k=k, probes=1, impl="fused", q_cap=RS_Q_CAP)
    flk2 = rt.pad_lookup(lk, rt.lookup_q_total(fplan, Q))
    full = (index.vecs, index.leaves, index.ids, flk2.vecs, flk2.leaves)
    kd, ki = rt.fused_topk(*full, k=k)
    pick = sample_rows(flk2, RS_SAMPLED, seed + 23)
    sq, sl = flk2.vecs[pick], flk2.leaves[pick]
    want = rt.map_ids(*chunked_plain(rt, index.vecs, index.leaves, sq, sl, k), index.ids)
    fin = torch.isfinite(want[0])
    err2 = float((kd[pick] - want[0])[fin].abs().max())
    rows_as_ids = torch.arange(index.rows, dtype=torch.int32, device=dev)
    nd, nr = rt.fused_topk(index.vecs, index.leaves, rows_as_ids, flk2.vecs, flk2.leaves,
                           k=k)
    exact, _, tol = rt.topk_f64(index.vecs, index.leaves, sq, sl, k, chunk_rows=CHUNK_POINTS)
    kr2 = rt.topk_error_ratio(nd[pick], nr[pick], index.vecs, sq, exact, tol)
    with tf32_matmuls():
        ctrl = chunked_plain(rt, index.vecs, index.leaves, sq, sl, k)
    tr2 = rt.topk_error_ratio(*ctrl, index.vecs, sq, exact, tol)
    real_check("fusedscan recsys", kr2, tr2)
    del nd, nr, rows_as_ids
    kern = fused_time(rt, full, k)
    plain = time_ms(lambda q, ql: chunked_plain(rt, index.vecs, index.leaves, q, ql, k),
                    [(sq, sl)], warmup=1)
    need, pairs, Qf = fused_need(index, flk2)
    bnd = fused_bound(need, pairs, Qf, d, k)
    rows["fusedscan"].update(recsys_launches=launches["fusedscan"],
                             recsys_shape=[index.rows, Qf, d, k], recsys_ms=kern[0],
                             recsys_wall_ms=kern[1], recsys_plain_ms=plain[0],
                             recsys_plain_rows=int(pick.numel()), recsys_library_ms=None,
                             recsys_bound_ms=bnd[0], recsys_bound_by=bnd[1],
                             recsys_max_abs_err=err2, recsys_fp32_bound_ratio=kr2,
                             recsys_tf32_bound_ratio=tr2, recsys_pairs=pairs)

    # K3: one 4,096-row wave of the build's assignment against level 0
    x, c = items[len(items) // 2:len(items) // 2 + 4096].contiguous(), tree.levels[0]
    ki3, kd3 = rt.l2_nearest(x, c)
    pi3, pd3 = rt.l2_nearest_ref(x, c)
    kr3 = rt.nearest_error_ratio(ki3, kd3, x, c)
    with tf32_matmuls():
        tr3 = rt.nearest_error_ratio(*rt.l2_nearest_ref(x, c), x, c)
    real_check("l2nn recsys", kr3, tr3)
    differ = ki3 != pi3
    if bool(differ.any()) and not bool(rt.ties_within_bound(x, c, ki3, pi3)[differ].all()):
        raise AssertionError("l2nn recsys: a nearest centroid differs outside a near-tie")
    err3 = float((kd3 - pd3).abs().max())
    kern = time_ms(rt.l2_nearest, [(x, c)] * 20)
    plain = time_ms(lambda x, c: rt.l2_nearest_ref(x, c), [(x, c)] * 20)
    lib = time_ms(lambda x, c: torch.cdist(x, c).min(1), [(x, c)] * 20)
    n, C = x.shape[0], c.shape[0]
    bnd = bound(n * d * 4 + C * d * 4 + n * 8, n * C * 2 * d + (n + C) * 2 * d)
    rows["l2nn"].update(recsys_launches=launches["l2nn"], recsys_shape=[n, C, d],
                        recsys_ms=kern[0], recsys_wall_ms=kern[1], recsys_plain_ms=plain[0],
                        recsys_library_ms=lib[0], recsys_bound_ms=bnd[0],
                        recsys_bound_by=bnd[1], recsys_max_abs_err=err3,
                        recsys_fp32_bound_ratio=kr3, recsys_tf32_bound_ratio=tr3,
                        recsys_argmin_near_ties=int(differ.sum()))
    for name in ("l2topk", "fusedscan", "l2nn"):
        log(f"{name} at d = {d} (recsys retrieval): " + json.dumps(
            {key: v for key, v in rows[name].items() if key.startswith("recsys_")}))


def rs_segsum_check(rt, batch, launches, seed) -> dict:
    """segsum at ogb_products' shape (61.9M edges, d 64, a layer's width):
    the forward's order (edges by destination) and the backward's (by
    source, power-law rows split into items) against the plain version
    (``index_add_``) and within ``fp32_bound.segsum_f64``'s bound, two runs
    bit-identical; timed beside the plain version, ``torch.sparse.mm`` on
    the same CSR (never called by the port) and the bound, and each order's
    two passes timed alone (``passes``). Returns the kernels line's row."""
    graph = batch["graph"]
    n = graph.fwd.n_rows
    dev = batch["feats"].device
    g = torch.Generator(device=dev).manual_seed(seed + 41)
    h = torch.randn((n, 64), generator=g, device=dev)
    check = {}
    for name, csr in (("fwd", graph.fwd), ("bwd", graph.bwd)):
        out = rt.segsum(h, csr)
        again = rt.segsum(h, csr)
        plain = rt.segsum_ref(h, csr.indptr, csr.cols, csr.w)
        exact, tol = rt.segsum_f64(h, csr)
        check[name] = dict(
            bit_identical=bool(torch.equal(out, again)),
            max_abs_err=float((out - plain).abs().max()),
            fp32_bound_ratio=rt.segsum_error_ratio(out, exact, tol),
            plain_fp32_bound_ratio=rt.segsum_error_ratio(plain, exact, tol),
            long_rows=int(csr.longs.shape[0]), items=int(csr.items.shape[0]),
            longest_row=int((csr.indptr[1:] - csr.indptr[:-1]).max()))
        del out, again, plain, exact, tol
        if not (check[name]["bit_identical"] and check[name]["fp32_bound_ratio"] <= 1.0):
            raise AssertionError(f"segsum {name}: {check[name]}")
    csr = graph.fwd
    E = int(csr.cols.shape[0])
    kern = time_ms(lambda hh: rt.segsum(hh, csr), [(h,)] * 5)
    plain = time_ms(lambda hh: rt.segsum_ref(hh, csr.indptr, csr.cols, csr.w), [(h,)] * 2,
                    warmup=1)
    a = torch.sparse_csr_tensor(csr.indptr, csr.cols, csr.w, size=(n, n))
    lib = time_ms(lambda hh: torch.sparse.mm(a, hh), [(h,)] * 5)
    d = h.shape[1]
    byt = n * d * 4 + E * 8 + csr.items.numel() * 4 + n * d * 4
    bnd = bound(byt, 2.0 * E * d)
    # each order's two passes timed alone with CUDA events (late in the
    # script the profiler's traces of this phase hold no segsum event): the
    # items pass, and the long rows' tree, one launch a level, over the
    # partial rows the items pass left; the passes in turn are the call
    passes = {}
    for name, c in (("fwd", graph.fwd), ("bwd", graph.bwd)):
        out, part = rt.segsum_ops.items_pass(h, c)
        rt.segsum_ops.tree_pass(part, out, c)
        if not torch.equal(out, rt.segsum(h, c)):
            raise AssertionError(f"segsum {name}: its two passes are not the call")
        items = time_ms(lambda hh, c=c: rt.segsum_ops.items_pass(hh, c), [(h,)] * 5)
        tree = time_ms(lambda c=c: rt.segsum_ops.tree_pass(part, out, c), [()] * 20)
        passes[name] = dict(
            items_ms=items[0], long_pass_ms=tree[0],
            long_pass_launches=len(c.tree_levels) - 1,
            tree_groups=int(c.tree.shape[0]), partial_rows=c.part_rows)
        del out, part
    row = dict(name="segsum", route="cuda", source="src/repro_torch/csrc/segsum.cu",
               replaces="src/repro/models/gnn.py:66",
               replaces_note="no TPU kernel: the reference's jax.ops.segment_sum over "
                             "gathered messages (XLA); a kernel here for a deterministic "
                             "sum without the (E, d) messages",
               launches=launches["segsum"],
               max_abs_err=max(c["max_abs_err"] for c in check.values()),
               ms=kern[0], wall_ms=kern[1], plain_ms=plain[0], bound_ms=bnd[0],
               bound_by=bnd[1], library_ms=lib[0], library="torch.sparse.mm (CSR)",
               shape=[n, E, d], fp32_bound_ratio=max(c["fp32_bound_ratio"]
                                                      for c in check.values()),
               checks=check, gathered_gib=E * d * 4 / 2**30,
               gathered_floor_ms=E * d * 4 / HBM_BYTES_PER_S * 1e3, passes=passes)
    log(f"segsum at ogb_products' shape: {json.dumps(row)}")
    return row


def recsys_phase(rt, args, dev, kernels, t_start) -> dict:
    """The recsys family and GIN at full width on the card: DLRM-rm2, DIN,
    DIEN and two-tower at serve_p99, serve_bulk, retrieval_cand and
    train_batch; two-tower's candidates through the vocabulary-tree index;
    gin-tu at its four shapes. Checks (a)-(e) (``rs_*``); the kernels line
    gains the retrieval path's K1, K2 and K3 numbers and a segsum row.
    With ``RS_TRACES`` (``scripts/recsys_phase.py``) each line also gets
    ``device_ms`` and its top ops from the profiler over one extra call;
    ``chip_smoke.py`` leaves them out: this late in the script the
    profiler's traces of this phase lost up to 60 ms of the card's work
    each and came back empty for DLRM's serve shapes (a host sleep before
    and after the call did not help)."""
    t_phase = time.perf_counter()
    elapsed = t_phase - t_start
    cut = elapsed + RS_BUDGET_S + RS_AFTER_S > RS_LATEST_END_S
    log(f"recsys: starts at {elapsed:.0f} s; "
        + (f"cut: one timed step a train shape (the script would pass "
           f"{RS_LATEST_END_S} s)" if cut else "no cut"))
    gc.collect()
    torch.cuda.empty_cache()
    rt.reset_counts()
    lines, cache, tt = {}, {}, None
    for name, spec in rs_models(rt).items():
        lines[name], params = rs_recsys_model(rt, name, spec, args.seed, cut, dev, cache)
        if params is not None:
            tt = params
        gc.collect()
        torch.cuda.empty_cache()
    del cache
    rd = rs_retrieval(rt, tt, rt.crec.TWO_TOWER, args.seed, dev)
    del tt
    gc.collect()
    torch.cuda.empty_cache()
    lines["gin-tu"], ogb = rs_gin(rt, args.seed, dev)
    launches = rt.counts()
    log(f"recsys: launches on the phase's path {json.dumps(launches)}")
    for name in ("l2topk", "fusedscan", "l2nn", "segsum"):
        if launches[name] <= 0:
            raise AssertionError(f"recsys: {name} was not launched on the phase's path")
    rs_kernel_checks(rt, rd, launches, kernels, args.seed)
    del rd
    gc.collect()
    torch.cuda.empty_cache()
    kernels.append(rs_segsum_check(rt, ogb, launches, args.seed))
    del ogb
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"recsys: phase {wall:.1f} s against a budget of {RS_BUDGET_S} s")
    return dict(lines=lines, launches=launches, wall_s=wall, cut=cut)


def dryrun_phase(rt, args, dev, kernels, t_start) -> dict:
    """The cell registry's dry-run (``launch/dryrun.py``): ``--list``, the
    abstract records on three layouts, then :data:`DR_CELLS` measured on
    the card, each in a process of its own, and K6 alone at 32,768
    tokens (:func:`k6_at_32k`)."""
    t0 = time.perf_counter()
    start = t0 - t_start
    cut = start > DR_LATEST_START_S
    cells = DR_CUT_CELLS if cut else DR_CELLS
    log(f"dryrun: starts at {start:.1f} s" + (
        f"; past {DR_LATEST_START_S} s: the abstract records and "
        f"{'/'.join(c[1] for c in cells)} only (a cut)" if cut else ""))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = rt.dryrun.main(["--list"])
    listed = [line.split(" -> ") for line in buf.getvalue().splitlines()]
    n_cells = sum(len(shapes.split(", ")) for _, shapes in listed)
    if rc or len(listed) != 11 or n_cells != 44:
        raise AssertionError(f"dryrun --list: rc {rc}, {len(listed)} architectures, "
                             f"{n_cells} cells (11 and 44 expected)")
    log(f"dryrun --list: {len(listed)} architectures, {n_cells} cells")
    registry = rt.registry
    recs = [rt.dryrun.abstract_record(registry[a].cell(s), mesh)
            for a in registry for s in registry[a].cells
            for mesh in ("16x16", "2x16x16", "card")]
    card = [r for r in recs if r["mesh"] == "card"]
    whole = [r for r in card if r["status"] == "ok"
             and r["card_cut"]["batch"] == r["card_cut"]["full"]]
    at_cut = [r for r in card if r["status"] == "ok" and r not in whole]
    no_fit = [r for r in card if r["status"] == "skip" and "card_cut" in r]
    log(f"dryrun --abstract: {len(recs)} records (44 cells x 16x16, 2x16x16, card); "
        f"{len(whole)} of 44 cells fit one card whole, {len(at_cut)} more at a cut, "
        f"{len(no_fit)} do not fit it at batch 1 "
        f"({', '.join(r['arch'] + ' ' + r['shape'] for r in no_fit)}), "
        f"{sum(r['status'] == 'skip' for r in card) - len(no_fit)} are the "
        f"reference's own skips")
    gc.collect()
    torch.cuda.empty_cache()
    # each cell in a process of its own, as `dryrun --all` runs it: late in
    # this one the profiler's traces lose the hand-written kernels' events
    recs = []
    for arch, shape, batch in cells:
        rec, rc = rt.dryrun.measured_in_child(arch, shape, argparse.Namespace(
            device="cuda", seed=args.seed, steps=DR_STEPS, batch=batch), timeout=DR_BUDGET_S)
        if rc:
            raise AssertionError(f"dryrun {arch} {shape}: the measuring process exit {rc}: "
                                 f"{rec.get('error') or rec.get('status')}")
        recs.append(rec)
    out = {}
    for rec in recs:
        arch, shape = rec["arch"], rec["shape"]
        log(json.dumps(rec))
        if rec["status"] != "ok":
            raise AssertionError(f"dryrun {arch} {shape}: {rec['status']} "
                                 f"{rec.get('skip_reason') or rec.get('error')}")
        roof = rec["roofline"]
        for key in ("wall_s", "device_s", "traced_wall_s", "mfu"):
            if not (isinstance(roof[key], float) and math.isfinite(roof[key])
                    and roof[key] > 0):
                raise AssertionError(f"dryrun {arch} {shape}: {key} {roof[key]}")
        if not roof["mfu"] < 1.0:
            raise AssertionError(f"dryrun {arch} {shape}: mfu {roof['mfu']} over the peak")
        if rec["launches"].get("flashattn.cuda_core"):  # bf16 at hd 128: tensor cores
            raise AssertionError(f"dryrun {arch} {shape}: K6 launched its CUDA-core "
                                 f"kernel {rec['launches']['flashattn.cuda_core']} times")
        for name, n in DR_KERNELS.get(shape, {}).items():
            got = rec["launches"].get(name, 0)
            if got <= 0 or (n is not None and got != n):
                raise AssertionError(f"dryrun {arch} {shape}: {name} launched {got} "
                                     f"times in the traced step ({n} expected)")
        log(f"dryrun {arch} {shape}: batch {rec['batch']} "
            f"(reduced {json.dumps(rec['reduced'])}), wall {roof['wall_s']} s, device "
            f"{roof['device_s']} s, idle share {roof['idle_share']}, mfu {roof['mfu']}, "
            f"peak {rec['memory']['peak_bytes'] / 2**30:.3f} GiB, dominant "
            f"{roof['dominant']}; launches in the traced step {json.dumps(rec['launches'])}")
        out[shape] = rec
    kernels_by_name = {kr["name"]: kr for kr in kernels}
    for rec in out.values():
        for name, n in rec["launches"].items():
            if name in kernels_by_name:  # variant counts ("flashattn.tensor_core") aside
                kernels_by_name[name].setdefault("dryrun_launches", {})[
                    f"{rec['arch']} {rec['shape']}"] = n
    if "prefill_32k" in out:
        kernels_by_name["flashattn"]["k6_32k"] = k6_at_32k(rt, dev, args.seed,
                                                           out["prefill_32k"])
    log(f"dryrun: phase {time.perf_counter() - t0:.1f} s (budget {DR_BUDGET_S} s)")
    return out


def k6_at_32k(rt, dev, seed: int, rec: dict) -> dict:
    """K6 at llama3.2-3b's 32,768-token layer (1 x 32768, 24 / 8 heads, hd
    128, causal, bf16) on seeded inputs: held against its plain version
    (:func:`k6_32k_check`), timed alone beside the plain version (in the
    check's pieces) and ``scaled_dot_product_attention``, its device ms a
    launch in the prefill's trace, and its bound (q, k, v read and out
    written once; the causal half of the products at the bf16 peak)."""
    cfg = rt.lm.LLAMA32_3B
    S, Hq, Hkv, hd = rt.lm.PREFILL_32K["seq"], cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(seed + 61)
    q = torch.randn((1, S, Hq, hd), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((1, S, Hkv, hd), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((1, S, Hkv, hd), generator=g, device=dev).to(torch.bfloat16)
    check = k6_32k_check(rt, q, k, v)
    ms, _ = time_ms(lambda q, k, v: rt.flash_attention(q, k, v), [(q, k, v)] * 4, 1)
    plain_ms, _ = time_ms(lambda q, k, v: [rt.flash_attention_ref(*piece) for _, _, piece
                                           in k6_32k_pieces(q, k, v)], [(q, k, v)], 0)
    # sdpa on keys and values repeated to the query heads (K6's GQA map),
    # which keeps it on its flash backend
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k.repeat_interleave(Hq // Hkv, 2),
                                              v.repeat_interleave(Hq // Hkv, 2)))
    sdpa_ms, _ = time_ms(lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True), [(qt, kt, vt)] * 4, 1)
    flops = 4.0 * S * (S + 1) / 2 * Hq * hd
    bytes_moved = S * (2 * Hq + 2 * Hkv) * hd * 2
    bound_ms, by = bound(bytes_moved, flops, BF16_FLOPS)
    traced = [op for op in rec["top_ops"] if "flash" in op["name"]]
    row = dict(shape=[1, S, Hq, Hkv, hd], **check, ms=ms, plain_ms=plain_ms,
               sdpa_ms=sdpa_ms, bound_ms=bound_ms, bound_by=by, tflops=flops / ms / 1e9,
               trace_ms_a_launch=(traced[0]["device_ms"] / traced[0]["launches"]
                                  if traced else None),
               prefill_launches=rec["launches"].get("flashattn"))
    log(f"K6 at 32,768 tokens: {check['bf16_tol_ratio']} x the bf16 tolerance (broken "
        f"variants {json.dumps(check['broken_variant_ratios'])}); {ms} ms a call "
        f"({row['tflops']} TFLOP/s), in the prefill's trace {row['trace_ms_a_launch']} ms "
        f"a launch, plain {plain_ms} ms (in {K6_32K_ROWS}-row pieces a GQA group), sdpa "
        f"{sdpa_ms} ms, bound {bound_ms} ms ({by})")
    return row


K6_32K_ROWS = 4096  # query rows a piece: a GQA group's float64 scores 3.2 GB


def k6_32k_pieces(q, k, v):
    """(rows, heads, (q, k, v)): pieces of one GQA group (its query heads
    against its KV head) and ``K6_32K_ROWS`` query rows each, rows [i, e)
    against keys [0, e), which under the causal mask is the whole
    attention of those rows."""
    S, G = q.shape[1], q.shape[2] // k.shape[2]
    for h in range(k.shape[2]):
        for i in range(0, S, K6_32K_ROWS):
            e = min(S, i + K6_32K_ROWS)
            rows, heads = slice(i, e), slice(h * G, (h + 1) * G)
            yield rows, heads, (q[:, rows, heads], k[:, :e, h:h + 1], v[:, :e, h:h + 1])


def k6_32k_check(rt, q, k, v) -> dict:
    """K6's output at 32k tokens against ``flash_attention_ref`` piece by
    piece (:func:`k6_32k_pieces`), within ``attention_bf16_tol``; and two
    broken plain variants on the first group that must fail: each row
    missing its own key (rows 1 .. ``K6_32K_ROWS``), and the keys past the
    last 2,048 dropped (``window=2048``, the last ``K6_32K_ROWS`` rows),
    a fault that only rows past 2,048 keys can show."""
    ref, tolf = rt.flash_attention_ref, rt.attention_bf16_tol
    got = rt.flash_attention(q, k, v)
    S, G, R = q.shape[1], q.shape[2] // k.shape[2], K6_32K_ROWS

    def ratio(a, b, tol):
        return float(((a.double() - b.double()).abs() / tol).max())

    tol_ratio, err = 0.0, 0.0
    for rows, heads, piece in k6_32k_pieces(q, k, v):
        a, want = got[:, rows, heads], ref(*piece)
        tol_ratio = max(tol_ratio, ratio(a, want, tolf(*piece)))
        err = max(err, float((a.float() - want.float()).abs().max()))
        del want
    q0, k0, v0 = q[:, :, :G], k[:, :, :1], v[:, :, :1]
    broken = {
        "diagonal_off_by_one": ratio(got[:, 1:R + 1, :G],
                                     ref(q0[:, 1:R + 1], k0[:, :R], v0[:, :R]),
                                     tolf(q0[:, 1:R + 1], k0[:, :R + 1], v0[:, :R + 1])),
        "keys_past_2048_dropped": ratio(got[:, S - R:, :G],
                                        ref(q0[:, S - R:], k0, v0, window=2048),
                                        tolf(q0[:, S - R:], k0, v0)),
    }
    del got
    if not tol_ratio <= 1.0:
        raise AssertionError(f"K6 at {S} tokens: {tol_ratio} x the bf16 tolerance")
    for name, br in broken.items():
        if not br > 1.0:
            raise AssertionError(f"K6 at {S} tokens: the broken plain variant {name} "
                                 f"passes the check ({br} x)")
    return dict(bf16_tol_ratio=tol_ratio, max_abs_err=err, broken_variant_ratios=broken)


def examples_phase(dev):
    """The port's examples as a user runs them, on the card: the
    quickstart and the Copydays evaluation, each a subprocess; crop10
    recall@1 must reach ``CD_CROP10_MIN``."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = {}
    for name in ("torch_quickstart", "torch_copydays_eval"):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, str(root / "examples" / f"{name}.py")],
                           capture_output=True, text=True, env=env, cwd=str(root),
                           timeout=300)
        wall = time.perf_counter() - t0
        lines = p.stdout.strip().splitlines()
        for line in lines:
            log(f"example {name}: {line}")
        if p.returncode != 0:
            raise AssertionError(f"example {name}: exit {p.returncode}\n"
                                 f"{p.stderr[-4000:]}")
        out[name] = wall
        log(f"example {name}: exit 0 in {wall:.1f} s")
    crop10 = next(ln for ln in lines if ln.startswith("crop10"))
    recall = float(crop10.split()[-1].rstrip("%")) / 100
    if recall < CD_CROP10_MIN:
        raise AssertionError(f"example Copydays: crop10 recall@1 {recall} < "
                             f"{CD_CROP10_MIN}")
    return dict(walls=out, crop10=recall)


class Port:
    """The port's entry points and kernel wrappers, imported from ``src``
    (this checkout's by default)."""

    def __init__(self, src=None):
        sys.path.insert(0, str(src or Path(__file__).resolve().parent / "src"))
        import repro_torch
        from repro_torch import obs
        from repro_torch.codes import IndexRowReader, ProductQuantizer, rerank_exact
        from repro_torch.codes import pq as pq_module
        from repro_torch.configs import REGISTRY, lm
        from repro_torch.launch import dryrun
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
        from repro_torch.core.index_build import routing_capacity
        from repro_torch.distributed import meshutil
        from repro_torch.distributed.meshutil import shard_submeshes
        from repro_torch.core.search import (
            lookup_q_total,
            pad_lookup,
            search_with_lookup,
        )
        from repro_torch.data import synth
        from repro_torch.data.batches import lm_batch
        from repro_torch.core.engine.plan import largest_divisor_leq
        from repro_torch.data import copydays
        from repro_torch.data.store import VirtualStore
        from repro_torch.index import lifecycle
        from repro_torch.index.manifest import latest as manifest_latest
        from repro_torch.index.manifest import list_versions
        from repro_torch.launch import index as index_cli
        from repro_torch.launch import train as train_cli
        from repro_torch.kernels import _build, fp32_bound
        from repro_torch.kernels.adcscan.ops import adc_topk
        from repro_torch.kernels.adcscan.ref import adc_topk_ref
        from repro_torch.kernels.flashattn.ops import _forward as fa_forward
        from repro_torch.kernels.flashattn.ops import (
            flash_attention,
            flash_attention_bwd,
            variant,
        )
        from repro_torch.kernels.flashattn.ref import (
            attention_mask,
            flash_attention_bwd_ref,
            flash_attention_ref,
        )
        from repro_torch.kernels.fusedscan.ops import fused_adc_topk, fused_topk
        from repro_torch.kernels.fusedscan.ref import map_ids
        from repro_torch.kernels.l2nn.ops import l2_nearest
        from repro_torch.kernels.l2nn.ref import l2_nearest_ref
        from repro_torch.kernels.l2topk import ops as l2topk_ops
        from repro_torch.kernels.l2topk.ops import l2_topk
        from repro_torch.kernels.l2topk.ref import l2_topk_ref
        from repro_torch.models import transformer as tfm
        from repro_torch.models import gnn, recsys
        from repro_torch.models.module import init_one, init_params
        from repro_torch.configs import gnn as cgnn
        from repro_torch.configs import recsys as crec
        from repro_torch.core.lookup import probe_leaves
        from repro_torch.data import graph
        from repro_torch.data.batches import din_batch, dlrm_batch, twotower_batch
        from repro_torch.kernels.segsum import ops as segsum_ops
        from repro_torch.kernels.segsum import segsum
        from repro_torch.kernels.segsum.ref import segsum_ref
        from repro_torch.distributed.checkpoint import CheckpointManager
        from repro_torch.train import AdamWConfig, make_train_step, tree
        from repro_torch.train.step import init_train_state

        self.build_tree, self.VocabTree = repro_torch.build_tree, repro_torch.VocabTree
        self.build_index = repro_torch.build_index
        self.DeviceMesh, self.SearchResult = repro_torch.DeviceMesh, repro_torch.SearchResult
        self.ShardedIndex = repro_torch.ShardedIndex
        self.shard_submeshes, self.meshutil = shard_submeshes, meshutil
        self.routing_capacity = routing_capacity
        self.batch_search = repro_torch.batch_search
        self.tree_assign = repro_torch.tree_assign
        self.Index, self.obs, self.route = repro_torch.Index, obs, route
        self.serving, self.PlanShapes = serving, PlanShapes
        self.plan_signature, self.signature_key = plan_signature, signature_key
        self.resolve_model, self.snap_to_bucket = resolve_model, snap_to_bucket
        self.leaf_slab, self.routed_capacity = leaf_slab, routed_capacity
        self.manifest_versions = list_versions
        self.manifest_latest, self.lifecycle = manifest_latest, lifecycle
        self.index_cli, self.copydays = index_cli, copydays
        self.VirtualStore, self.largest_divisor_leq = VirtualStore, largest_divisor_leq
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
        self.registry, self.dryrun = REGISTRY, dryrun
        self.init_one, self.fp32_gamma = init_one, fp32_bound.gamma
        self.flash_attention, self.flash_attention_ref = flash_attention, flash_attention_ref
        self.fa_variant = variant
        self.attention_f64 = fp32_bound.attention_f64
        self.attention_error_ratio = fp32_bound.attention_error_ratio
        self.attention_bf16_tol = fp32_bound.attention_bf16_tol
        self.fa_forward = fa_forward
        self.flash_attention_bwd = flash_attention_bwd
        self.flash_attention_bwd_ref = flash_attention_bwd_ref
        self.attention_mask = attention_mask
        self.attention_grads_f64 = fp32_bound.attention_grads_f64
        self.grads_error_ratio = fp32_bound.grads_error_ratio
        self.CheckpointManager, self.tree, self.train_cli = CheckpointManager, tree, train_cli
        self.AdamWConfig, self.make_train_step = AdamWConfig, make_train_step
        self.train_state = init_train_state
        self.recsys, self.gnn, self.crec, self.cgnn = recsys, gnn, crec, cgnn
        self.graph, self.probe_leaves = graph, probe_leaves
        self.dlrm_batch, self.din_batch = dlrm_batch, din_batch
        self.twotower_batch = twotower_batch
        self.segsum, self.segsum_ref = segsum, segsum_ref
        self.segsum_ops = segsum_ops
        self.segsum_f64 = fp32_bound.segsum_f64
        self.segsum_error_ratio = fp32_bound.segsum_error_ratio
        self.wrappers = {"l2topk": l2_topk, "fusedscan": fused_topk,
                         "l2nn": l2_nearest, "adcscan": adc_topk,
                         "fusedadc": fused_adc_topk, "flashattn": flash_attention,
                         "flashattn_bwd": flash_attention_bwd, "segsum": segsum}

    def reset_counts(self):
        for fn in self.wrappers.values():
            fn.launches = 0
            fn.by_device.clear()
            for r in getattr(fn, "route_launches", {}):
                fn.route_launches[r] = 0
        for fn in (self.flash_attention, self.flash_attention_bwd):
            for name in fn.variant_launches:
                fn.variant_launches[name] = 0

    def counts(self):
        """Launches by wrapper; ``<name>.<route>``: those of them on each
        route of the scan kernels (``kernels/l2topk/ops.py route``)."""
        out = {name: fn.launches for name, fn in self.wrappers.items()}
        for name, fn in self.wrappers.items():
            for r, n in getattr(fn, "route_launches", {}).items():
                out[f"{name}.{r}"] = n
        for name, n in self.flash_attention.variant_launches.items():
            out[f"flashattn.{name}"] = n
        for name, n in self.flash_attention_bwd.variant_launches.items():
            out[f"flashattn_bwd.{name}"] = n
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
    print(smi.splitlines()[0], flush=True)  # as nvidia-smi gives it
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
    pq = run["codes"]["pq"]  # the shards phase's codebooks
    del run  # the search phases' tensors (the dense phase peaks at 41 GiB)
    gc.collect()
    torch.cuda.empty_cache()
    k3 = next(kr for kr in kernels if kr["name"] == "l2nn")
    k3.update(trace_build(rt, args, dev, sizes, tree, build_wall))
    index_job_phase(rt, dev, args.seed, kernels, t_start)
    shards_phase(rt, args, dev, tree, pq, kernels, t_start, rows=SH_CUT_ROWS)
    del tree, pq
    log(f"before the LM phase: {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    lm = run_lm_path(rt, args, dev)
    check_lm_path(rt, lm)
    kernels.append(lm_kernel_check(rt, lm, args.seed))
    trace_lm(rt, lm)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    log(f"before the moe phase: {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
        f"allocated")
    moe_phase(rt, args, dev, kernels, t_start)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"before the train phase: {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
        f"allocated")
    train_phase(rt, args, dev, kernels, t_start)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"before the recsys phase: {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
        f"allocated")
    recsys_phase(rt, args, dev, kernels, t_start)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"before the dryrun phase: {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
        f"allocated")
    dryrun_phase(rt, args, dev, kernels, t_start)
    examples_phase(dev)
    log(f"script: {time.perf_counter() - t_start:.1f} s to here")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
