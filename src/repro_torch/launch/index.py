"""Streaming index-creation CLI -- a thin shell over ``repro_torch.index.Index``.

The paper's Table 2 workflow, on every visible card (one shard a card,
``local_mesh``) unless ``--device cpu`` or ``--device cuda:N`` names one
device: descriptor blocks stream through wave-based assignment into index
files, and the searchable collection keeps growing between runs. Each
store block becomes one ``Index.append`` wave under the WaveScheduler
(retry + wave statistics, the jobtracker analog); ``commit`` publishes the
appended segments atomically (``--commit-every`` controls durability
granularity); ``--index-dir`` makes the grown index reopenable by later
index/serve runs -- the paper's "index once, search many, keep growing"
loop. ``--compact`` folds all segments into one at the end.

The directory and its ingest cursor are the JAX package's format, so a
job started by either package's ``launch/index.py`` is resumed and
finished by the other's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.index --rows 300000 \\
      --block-rows 50000 [--index-dir /tmp/idx] [--commit-every 2] \\
      [--compact] [--inject-failures] [--verify-queries 64]
  PYTHONPATH=src python -m repro_torch.launch.index --device cpu \\
      --rows 40000 --dim 32 --block-rows 20000 --fanout 16 16 \\
      --verify-queries 32
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="streaming index creation over the segment lifecycle API"
    )
    ap.add_argument("--rows", type=int, default=300_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--block-rows", type=int, default=50_000)
    ap.add_argument("--fanout", type=int, nargs=2, default=(32, 32))
    ap.add_argument("--tree-sample", type=int, default=65_536)
    ap.add_argument("--inject-failures", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the index lives and its builds and searches "
                         "run: cuda (the default: one shard on every visible "
                         "card; raises without a card), cuda:N (one card) "
                         "or cpu")
    ap.add_argument(
        "--index-dir", default=None,
        help="durable index directory (create or grow); default: ephemeral",
    )
    ap.add_argument(
        "--commit-every", type=int, default=0,
        help="commit after every N appended blocks (0 = one commit at the "
        "end)",
    )
    ap.add_argument(
        "--compact", action="store_true",
        help="merge all segments into one after the appends",
    )
    ap.add_argument(
        "--compact-incremental", action="store_true",
        help="run size-tiered incremental compaction steps (one small "
        "tier or tombstone-heavy batch per step) until the policy reaches "
        "a fixed point, instead of one stop-the-world merge",
    )
    ap.add_argument(
        "--wire-dtype", choices=("float32", "bfloat16"), default="float32",
        help="routed-shuffle payload dtype for appends (float32 keeps grown "
        "indexes bit-identical to one-shot rebuilds)",
    )
    ap.add_argument(
        "--verify-queries", type=int, default=0,
        help="after indexing, search N perturbed corpus rows and report "
        "recall (0 = skip)",
    )
    ap.add_argument(
        "--layout",
        choices=("point_major", "query_routed", "scan_codes", "auto"),
        default="auto", help="scan layout for the verification search",
    )
    ap.add_argument(
        "--probes", type=int, default=1,
        help="multi-probe width for the verification search",
    )
    ap.add_argument(
        "--codes", action="store_true",
        help="train product-quantized codes over the grown index and "
        "persist them with the commit; an index that already carries codes "
        "re-encodes appended segments automatically, with or without this "
        "flag",
    )
    ap.add_argument(
        "--subvectors", type=int, default=8,
        help="PQ subvectors per row for --codes (= compressed bytes/row)",
    )
    ap.add_argument(
        "--code-bits", type=int, default=8,
        help="PQ bits per subvector code for --codes (8 = 256 centroids)",
    )
    ap.add_argument(
        "--rerank", type=int, default=None,
        help="ADC candidate depth for the verification search on the "
        "codes tier (default: engine heuristic)",
    )
    ap.add_argument(
        "--cost-model",
        choices=("auto", "heuristic", "observed", "fitted"),
        default="auto",
        help="cost model for the verification search's auto layout "
        "(consults the index's persisted calibration)",
    )
    ap.add_argument(
        "--trace-out", default=None,
        help="record index-lifecycle spans (append/commit/compact) and "
        "write them here: .jsonl = structured log, else Chrome "
        "trace_event JSON",
    )
    ap.add_argument(
        "--trace-sample", type=float, default=1.0,
        help="trace sample rate (lifecycle spans are process-scoped and "
        "always kept; this only thins request-scoped spans)",
    )
    ap.add_argument(
        "--metrics-out", default=None,
        help="dump the unified metrics registry snapshot (index.appends/"
        "commits/compacts, ...) as JSON here",
    )
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.obs import NULL_TRACER, Tracer, tracing

    tracer = (
        Tracer(sample=args.trace_sample, seed=args.seed)
        if args.trace_out else NULL_TRACER
    )
    # scoped install: main() is called in-process by tests and chip_smoke,
    # so the previous tracer must come back whatever happens below
    with tracing(tracer):
        return _run(args, tracer)


def _run(args, tracer) -> int:
    import torch

    from repro_torch.core.tree import build_tree
    from repro_torch.data.store import VirtualStore
    from repro_torch.device import dtype_name
    from repro_torch.distributed import meshutil
    from repro_torch.distributed.failure import FailureInjector
    from repro_torch.distributed.wavescheduler import WaveScheduler
    from repro_torch.index import Index, has_index

    # every visible card for cuda (raises without one), one shard for cpu
    # or cuda:N
    mesh = meshutil.local_mesh(args.device)
    dev = mesh.first

    def sync():
        for d in mesh.distinct:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    store = VirtualStore(
        args.rows, args.dim, block_rows=args.block_rows, seed=args.seed
    )
    print(f"store: {store.n_rows} rows in {store.n_blocks} blocks")

    wire = getattr(torch, args.wire_dtype)
    if args.index_dir and has_index(args.index_dir):
        t0 = time.perf_counter()
        idx = Index.open(args.index_dir, mesh=mesh)
        print(
            f"index: opened {args.index_dir} v{idx.version} "
            f"({idx.n_segments} segments, {idx.rows} rows) in "
            f"{time.perf_counter() - t0:.2f}s — appending"
        )
        if wire != idx.wire_dtype:
            print(
                f"warning: --wire-dtype {args.wire_dtype} ignored — the "
                f"index was created with {dtype_name(idx.wire_dtype)} and "
                "appends keep the creation-time dtype"
            )
        tree = idx.tree
    else:
        t0 = time.perf_counter()
        # the port's own tree: its random picks come from a seeded torch
        # generator, so it is not the JAX package's tree for the same seed
        tree = build_tree(
            torch.as_tensor(store.sample_for_tree(args.tree_sample)),
            tuple(args.fanout),
            generator=torch.Generator().manual_seed(args.seed),
            device=dev,
        )
        sync()
        print(f"tree: {tree.n_leaves} leaves "
              f"({time.perf_counter() - t0:.2f}s)")
        idx = Index.create(tree, args.index_dir, mesh=mesh, wire_dtype=wire,
                           extra={"corpus_seed": args.seed})

    # --- resumable ingest: a crashed --commit-every run must not re-append
    # its already-committed blocks on rerun. The cursor (store signature +
    # next block + base id) rides in the index meta and is bumped in the
    # same manifest as each commit, so it can never disagree with the data.
    sig = {"seed": args.seed, "rows": args.rows, "dim": args.dim,
           "block_rows": args.block_rows}
    cursor = idx.meta.get("ingest") or {}
    if cursor.get("sig") == sig and cursor.get("next_block", 0) > 0:
        start_block = int(cursor["next_block"])
        base_id = int(cursor["base_id"])
        print(f"ingest: resuming this store at block {start_block}/"
              f"{store.n_blocks} (base id {base_id})")
    else:
        start_block = 0
        base_id = idx.next_id  # appended block ids stay globally unique
    appended: dict[int, dict] = {}

    def wave_fn(block_id: int):
        # idempotent under WaveScheduler retries: a wave that failed
        # *after* its append staged durably (e.g. mid-commit IO error)
        # must not re-append the same ids on the retry
        if block_id not in appended:
            block = store.read_block(block_id)
            name = idx.append(block.vecs, ids=base_id + block.ids)
            seg = idx.segments[-1]
            appended[block_id] = {"name": name, "rows": seg.valid_rows,
                                  "overflow": int(seg.index.overflow)}
        if args.commit_every and (block_id + 1) % args.commit_every == 0:
            idx.update_meta(ingest={"sig": sig, "next_block": block_id + 1,
                                    "base_id": base_id})
            idx.commit()
        return appended[block_id]

    def fold(state, wave_out):
        state = state or {"segments": [], "rows": 0, "overflow": 0}
        state["segments"].append(wave_out["name"])
        state["rows"] += wave_out["rows"]
        state["overflow"] += wave_out["overflow"]
        return state

    injector = (
        FailureInjector(fail_at=[(1, 0), (3, 0)]) if args.inject_failures else None
    )
    sched = WaveScheduler(wave_fn, fold, failure_injector=injector, max_retries=2)
    t0 = time.perf_counter()
    result = sched.run(range(store.n_blocks), start_at=start_block)
    done = {"sig": sig, "next_block": result.completed, "base_id": base_id}
    if idx.meta.get("ingest") != done:
        idx.update_meta(ingest=done)
    if args.codes and idx.quantizer is None:
        # train once over everything appended so far; the codes artifacts
        # publish in the same commit as the final ingest cursor
        t_c = time.perf_counter()
        idx.enable_codes(m=args.subvectors, bits=args.code_bits,
                         seed=args.seed)
        sync()
        cs = idx.codes_stats()
        print(f"codes: trained m={cs['code_m']} bits={cs['code_bits']} "
              f"({cs['bytes_per_row']} B/row vs "
              f"{cs['raw_bytes_per_row']} raw, "
              f"{cs['compression_ratio']:.1f}x) in "
              f"{time.perf_counter() - t_c:.2f}s")
    version = idx.commit()
    dt = time.perf_counter() - t0

    waves_run = store.n_blocks - start_block
    ok = [r for r in result.records if r.ok]
    failed = [r for r in result.records if not r.ok]
    durations = sorted(r.duration_s for r in ok) or [0.0]
    print(
        f"index job: {result.completed - start_block}/{waves_run} append "
        f"waves in {dt:.2f}s; {len(failed)} failed attempts (retried), "
        f"route overflow {result.state['overflow'] if result.state else 0}; "
        f"committed v{version} ({idx.n_segments} segments, {idx.rows} live "
        "rows)"
    )
    print(
        "wave stats: avg {:.2f}s min {:.2f}s max {:.2f}s median {:.2f}s "
        "(Table 5 analog)".format(
            float(np.mean(durations)),
            durations[0],
            durations[-1],
            durations[len(durations) // 2],
        )
    )
    n_indexed = result.state["rows"] if result.state else 0
    expected = store.n_rows - min(start_block * args.block_rows, store.n_rows)
    if n_indexed != expected:
        raise AssertionError(f"indexed {n_indexed} descriptors, expected "
                             f"{expected}")
    print(f"indexed {n_indexed} descriptors == remaining corpus size OK")

    if args.compact:
        t0 = time.perf_counter()
        name = idx.compact()
        sync()
        print(f"compacted -> {name} (v{idx.version}, {idx.rows} rows) in "
              f"{time.perf_counter() - t0:.2f}s")
    elif args.compact_incremental:
        # one published step per iteration; the policy's empty selection
        # (None without a version bump) is the fixed point
        steps = 0
        t0 = time.perf_counter()
        while steps < 64:
            v0 = idx.version
            name = idx.compact(incremental=True)
            if idx.version == v0:  # empty selection: nothing published
                break
            steps += 1
            print(f"compact step {steps}: -> {name or '(dropped dead rows)'} "
                  f"(v{idx.version}, {len(idx.segments)} segments)")
        print(f"incremental compaction: {steps} steps in "
              f"{time.perf_counter() - t0:.2f}s")

    if args.verify_queries:
        # verification search straight off the lifecycle facade: perturbed
        # corpus rows must find themselves under the requested plan
        rng = np.random.default_rng(args.seed + 7)
        rows = np.sort(rng.choice(store.n_rows, args.verify_queries,
                                  replace=False))
        planted = store.read_rows(rows)
        queries = (
            planted
            + rng.standard_normal((len(rows), args.dim)).astype(np.float32)
        )
        res = idx.search(queries, k=1, layout=args.layout,
                         probes=args.probes, cost_model=args.cost_model,
                         rerank=args.rerank)
        got = res.ids[:, 0].cpu().numpy()
        hit = got == base_id + rows
        # a grown index may hold exact copies of the planted row (e.g. the
        # same seeded store appended twice): a returned neighbour at least
        # as close as the planted row is a find, not a miss (2.0 absolute
        # slack: fp32 ||p||^2-2pq+||q||^2 vs the (p-q)^2 oracle)
        planted_d = ((planted - queries) ** 2).sum(1)
        hit |= res.dists[:, 0].cpu().numpy() <= planted_d + 2.0
        recall = float(hit.mean())
        print(
            f"verify: layout={args.layout} probes={args.probes} "
            f"recall@1 {recall:.3f} pairs {float(res.pairs):.3g} "
            f"q_cap_overflow {int(res.q_cap_overflow)}"
        )

    if args.trace_out:
        from repro_torch.obs import export_trace

        export_trace(tracer, args.trace_out)
        d = tracer.describe()
        print(f"trace -> {args.trace_out} ({d['spans']} spans, "
              f"{d['events']} events)")
    if args.metrics_out:
        from repro_torch.obs import get_registry

        get_registry().dump(args.metrics_out)
        print(f"metrics registry -> {args.metrics_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
