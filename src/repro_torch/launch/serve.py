"""Online search service CLI -- a thin shell over ``repro_torch.serving``.

The paper's Exp #5 measures batch-search throughput (~210 ms/image at 12k-
image batches); this launcher runs the same engine as a *service*, on the
card unless ``--device cpu`` is given: the index is loaded or built once
through the segment lifecycle (``--index-dir`` holds a committed
``repro_torch.index.Index``, so index-once / serve-many works across
invocations, in the JAX package's directory format), a ladder of
batch-size buckets is built and warmed, and a trace-driven request stream
is played through the micro-batcher -- reporting the latency distribution
(p50/p95/p99), engine ms/image, cache hit rate, and the steady-state
recompile count (the serving invariant: 0 after warmup).

Scheduling is deadline-aware by default (``--scheduler edf``): requests
carry priority classes, the batcher dispatches earliest-deadline-first
with fitted-cost admission control, and ``--target-p95-ms`` lets the
fitted cost model pick the bucket ladder for a latency target.
``--scheduler fifo`` keeps arrival-order coalescing for comparison.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --trace zipf --requests 500
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --rows 20000 \\
      --dim 32 --images 400 --fanout 16 16 --trace zipf --requests 100
  PYTHONPATH=src python -m repro_torch.launch.serve --index-dir /tmp/idx \\
      --trace uniform --requests 200 --rate 100 --cache-leaves 64
  # multi-tenant trace + latency target, FIFO baseline for comparison:
  PYTHONPATH=src python -m repro_torch.launch.serve --trace multi \\
      --requests 600 --target-p95-ms 100 --scheduler fifo
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _build_corpus(args, dpi: int):
    """The synthetic image collection of the old CLI."""
    from repro_torch.data import synth

    vecs, _ = synth.sample_images(args.images, dpi, args.dim, seed=args.seed)
    return vecs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="online search service over a (built or restored) index"
    )
    # corpus / index
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--images", type=int, default=2000)
    ap.add_argument("--fanout", type=int, nargs=2, default=(32, 32))
    ap.add_argument("--desc-per-image", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the index lives and searches run: cuda "
                         "(the default; raises without a card) or cpu")
    ap.add_argument("--index-dir", default=None,
                    help="persist/restore the built index + corpus here "
                         "(index-once/serve-many)")
    ap.add_argument("--rebuild", action="store_true",
                    help="ignore an existing --index-dir checkpoint")
    # engine
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument(
        "--layout",
        choices=("point_major", "query_routed", "scan_codes", "auto"),
        default="auto",
        help="scan layout; auto lets the engine plan() heuristic pick "
             "(scan_codes requires a codes-enabled index or --codes)",
    )
    ap.add_argument("--probes", type=int, default=1,
                    help="multi-probe width: leaves visited per query")
    ap.add_argument("--codes", action="store_true",
                    help="train PQ codes on the index (if not already "
                         "enabled) so auto planning may serve the "
                         "compressed tier")
    ap.add_argument("--subvectors", type=int, default=8,
                    help="PQ subvectors per row for --codes (bytes/row)")
    ap.add_argument("--code-bits", type=int, default=8,
                    help="PQ bits per subvector code for --codes")
    ap.add_argument("--rerank", type=int, default=None,
                    help="ADC candidate depth refetched for the exact "
                         "rerank on the codes tier (default: engine "
                         "heuristic, max(k, min(8k, 64)) clamped)")
    ap.add_argument("--impl", choices=("xla", "pallas", "fused", "auto"),
                    default="xla",
                    help="xla/pallas: the per-tile kernels (K1, K4); fused: "
                         "the whole-shard kernels (K2, K5); auto: priced")
    ap.add_argument("--cost-model",
                    choices=("auto", "heuristic", "observed", "fitted"),
                    default="auto",
                    help="which cost model ranks an auto layout: auto "
                         "prefers fitted > observed > heuristic over the "
                         "index's manifest-persisted calibration")
    # serving
    ap.add_argument("--max-batch-rows", type=int, default=4096,
                    help="largest micro-batch bucket (query rows)")
    ap.add_argument("--n-buckets", type=int, default=3)
    ap.add_argument("--buckets", default=None,
                    help="explicit comma-separated bucket sizes (query rows)")
    ap.add_argument("--max-wait-ms", type=float, default=None,
                    help="micro-batcher base coalescing deadline "
                         "(default 5.0, or the tuned slack under "
                         "--target-p95-ms)")
    ap.add_argument("--max-queue", type=int, default=4096,
                    help="pending-request cap (backpressure)")
    ap.add_argument("--scheduler", choices=("edf", "fifo"), default="edf",
                    help="micro-batcher scheduler: edf (default) is "
                         "deadline-aware — earliest-deadline-first within "
                         "priority class, fitted-cost admission control "
                         "shedding overload batch work; fifo is the "
                         "original arrival-order coalescing (identical "
                         "results, different latency profile)")
    ap.add_argument("--refresh-every", type=int, default=0,
                    help="call session.maybe_refresh() after every N "
                         "engine dispatches, adopting index versions "
                         "committed by a concurrent writer between "
                         "batches; 0 = serve the "
                         "pinned version for the whole trace")
    ap.add_argument("--target-p95-ms", type=float, default=None,
                    help="closed-loop latency target: the fitted cost "
                         "model picks the bucket ladder (and per-shard "
                         "slab budgets) whose largest dispatch fits this "
                         "p95 (ignored when --buckets is explicit; no-op "
                         "until the index carries a usable calibration)")
    ap.add_argument("--cache-leaves", type=int, default=0,
                    help="hot-leaf cache capacity in leaves (0 = off)")
    ap.add_argument("--cache-admit", type=int, default=2,
                    help="leaf routings before a leaf is admitted")
    ap.add_argument("--cache-eviction", choices=("cost", "lru"),
                    default="cost",
                    help="hot-leaf eviction policy: cost ranks resident "
                         "leaves by predicted ms-saved-per-resident-byte "
                         "(fitted cost model), lru is the original "
                         "recency policy")
    ap.add_argument("--shards", type=int, default=None,
                    help="scatter-gather serving over N index shards "
                         "(default: the index's persisted shard plan, or "
                         "unsharded)")
    ap.add_argument("--shard-plan", choices=("round_robin", "balanced"),
                    default=None,
                    help="segment->shard assignment strategy for --shards "
                         "(default: the index's persisted strategy, else "
                         "round_robin; persisted in the index manifest "
                         "when --index-dir is given)")
    # workload
    ap.add_argument("--trace", choices=("fixed", "uniform", "zipf", "multi"),
                    default=None,
                    help="request stream; fixed replays the legacy batch "
                         "protocol; multi is the multi-tenant mix "
                         "(bursty batch + steady interactive/standard "
                         "priority classes)")
    ap.add_argument("--requests", type=int, default=500)
    ap.add_argument("--zipf-s", type=float, default=1.1)
    ap.add_argument("--rate", type=float, default=None,
                    help="arrival rate req/s (default: all at t=0, the "
                         "paper's offline batch as a degenerate trace)")
    ap.add_argument("--trace-seed", type=int, default=1)
    ap.add_argument("--noise", type=float, default=4.0)
    ap.add_argument("--no-recall", action="store_true")
    ap.add_argument("--json", default=None,
                    help="dump the metrics JSON here")
    # observability
    ap.add_argument("--trace-out", default=None,
                    help="record a per-request span timeline and write it "
                         "here: .jsonl = structured event log, anything "
                         "else = Chrome trace_event JSON (open in "
                         "ui.perfetto.dev / chrome://tracing). Tracing "
                         "never changes "
                         "results — ids/dists are bit-identical on or off")
    ap.add_argument("--trace-sample", type=float, default=1.0,
                    help="fraction of requests traced (deterministic "
                         "per-request hash under --seed, so the same "
                         "subset is traced every replay)")
    ap.add_argument("--metrics-out", default=None,
                    help="dump the unified metrics registry snapshot "
                         "(serving + cache + index + calibration series) "
                         "as JSON here")
    # legacy fixed-batch protocol
    ap.add_argument("--batches", type=int, default=None)
    ap.add_argument("--batch-images", type=int, default=256)
    args = ap.parse_args(argv)

    from repro_torch.obs import NULL_TRACER, Tracer, tracing

    tracer = (
        Tracer(sample=args.trace_sample, seed=args.seed)
        if args.trace_out else NULL_TRACER
    )
    # scoped install: main() is called in-process by benchmarks/tests, so
    # the previous tracer must come back whatever happens below
    with tracing(tracer):
        return _serve(args, tracer)


def _serve(args, tracer) -> int:
    import torch

    from repro_torch.core.index_build import build_index
    from repro_torch.core.tree import build_tree
    from repro_torch.data import synth
    from repro_torch.device import resolve
    from repro_torch.index import Index
    from repro_torch.serving import (
        MicroBatcher,
        SearchSession,
        ShardedSearchSession,
        TraceLoadGenerator,
        default_tenant_mix,
        persist,
        tune_ladder,
    )
    from repro_torch.serving.session import load_or_build_index, sync

    dev = resolve(args.device)  # raises for cuda without a card
    dpi = args.desc_per_image or max(1, args.rows // args.images)

    corpus_vecs = None  # resident fallback when no --index-dir

    def build_fn():
        nonlocal corpus_vecs
        vecs_np = _build_corpus(args, dpi)
        t0 = time.perf_counter()
        vecs = torch.as_tensor(vecs_np, device=dev)
        # the tree's random picks come from an explicit generator (seed 1)
        tree = build_tree(vecs, tuple(args.fanout),
                          generator=torch.Generator().manual_seed(1),
                          device=dev)
        extra = {
            "images": args.images, "desc_per_image": dpi,
            "corpus_seed": args.seed,
        }
        corpus_vecs = vecs_np
        if args.index_dir:
            persist.save_corpus(args.index_dir, vecs_np)
        if args.shards and args.shards > 1:
            # one appended segment per shard so every scatter leg owns
            # real rows (segment search is bit-identical to one-shot, so
            # this only changes the partitioning, never the results)
            idx = Index.create(tree, args.index_dir or None, device=dev,
                               extra=extra, overwrite=True)
            for chunk in np.array_split(vecs_np, args.shards):
                idx.append(chunk)
            idx.commit()
            print(f"index: built {idx.rows} rows ({tree.n_leaves} leaves, "
                  f"{idx.n_segments} segments) in "
                  f"{time.perf_counter() - t0:.2f}s")
            return idx
        # float32 wire, the lifecycle's recorded default: a later append
        # grows this index with the same dtype
        index = build_index(vecs, tree, wire_dtype=torch.float32, device=dev)
        sync(dev)
        print(f"index: built {int(index.n_valid.sum())} rows "
              f"({tree.n_leaves} leaves) in {time.perf_counter() - t0:.2f}s "
              f"(overflow {int(index.overflow)})")
        return index, tree, extra

    session_kw = dict(
        k=args.k, layout=args.layout, probes=args.probes, impl=args.impl,
        max_batch_rows=args.max_batch_rows, n_buckets=args.n_buckets,
        cache_leaves=args.cache_leaves, cache_admit_after=args.cache_admit,
        cache_eviction=args.cache_eviction, cost_model=args.cost_model,
        rerank=args.rerank,
    )
    if args.buckets:
        session_kw["buckets"] = [int(b) for b in args.buckets.split(",")]
    t0 = time.perf_counter()
    idx, meta = load_or_build_index(
        args.index_dir, build_fn=build_fn, device=dev, rebuild=args.rebuild,
    )
    if args.codes and idx.quantizer is None:
        t_c = time.perf_counter()
        idx.enable_codes(m=args.subvectors, bits=args.code_bits,
                         seed=args.seed)
        if args.index_dir:
            idx.commit()
        cs = idx.codes_stats()
        print(f"codes: trained m={cs['code_m']} bits={cs['code_bits']} "
              f"({cs['bytes_per_row']} B/row vs {cs['raw_bytes_per_row']} "
              f"raw, {cs['compression_ratio']:.1f}x) in "
              f"{time.perf_counter() - t_c:.2f}s")
    elif idx.quantizer is not None:
        cs = idx.codes_stats()
        print(f"codes: restored m={cs['code_m']} bits={cs['code_bits']} "
              f"({cs['compression_ratio']:.1f}x compression)")
    dpi = int(meta.get("desc_per_image", dpi))
    max_wait_ms = args.max_wait_ms
    if args.target_p95_ms and not args.buckets:
        # closed loop: the fitted cost model picks the ladder whose
        # largest dispatch still fits the target (stock ladder until the
        # index carries a usable calibration)
        decision = tune_ladder(
            idx.calibration, target_p95_ms=args.target_p95_ms,
            rows=idx.rows, n_leaves=idx.n_leaves, desc_per_image=dpi,
            max_batch_rows=args.max_batch_rows, n_buckets=args.n_buckets,
            n_shards=args.shards
            or (idx.shard_plan.n_shards if idx.shard_plan else 1),
            k=args.k, probes=args.probes, layout=args.layout,
            impl=args.impl, cost_model=args.cost_model,
            base_max_wait_ms=args.max_wait_ms
            if args.max_wait_ms is not None else 5.0,
        )
        session_kw["buckets"] = list(decision.buckets)
        if max_wait_ms is None:
            max_wait_ms = decision.max_wait_ms
        pred = decision.predicted_dispatch_ms
        print(
            f"ladder tuner: target p95 {args.target_p95_ms:.0f} ms -> "
            f"buckets {list(decision.buckets)}, "
            f"max_wait {decision.max_wait_ms:.1f} ms "
            f"({decision.decided_by}"
            + (f", predicted dispatch {pred:.1f} ms)" if pred is not None
               else ")")
        )
    if max_wait_ms is None:
        max_wait_ms = 5.0
    if args.shards is not None or idx.shard_plan is not None:
        # strategy precedence: explicit flag > the index's persisted
        # strategy > round_robin — so `--shards N` alone never flips a
        # persisted balanced plan back to the flag default
        strategy = args.shard_plan or (
            idx.shard_plan.strategy
            if idx.shard_plan is not None
            and idx.shard_plan.strategy != "explicit"
            else "round_robin"
        )
        session = ShardedSearchSession(
            idx, shards=args.shards,
            shard_strategy=strategy, target_p95_ms=args.target_p95_ms,
            **session_kw,
        )
        shard_stats = session.per_shard_stats()["shards"]
        empty = [s["shard"] for s in shard_stats if not s["segments"]]
        if empty:
            # the shard unit is a segment: a restored index with fewer
            # segments than shards cannot spread — say so, and don't lock
            # the degenerate topology into the manifest
            print(
                f"warning: {len(empty)}/{session.n_shards} shards own no "
                f"segments (this index has {idx.n_segments}); grow it with "
                "appends, or --rebuild to re-partition "
                "the corpus into one segment per shard"
            )
        # make the plan durable so later serve runs (and Index.open
        # consumers) reuse the same scatter topology without re-deriving —
        # only when the user explicitly asked for a real topology
        # (--shards > 1): a serve run must not rewrite a persisted plan,
        # or pin a pointless 1-shard plan, as a side effect
        elif (args.index_dir and args.shards is not None and args.shards > 1
              and session.shard_plan != idx.shard_plan):
            idx.set_shard_plan(session.shard_plan)
            idx.commit()
        print(f"shards: {session.shard_plan.describe()}")
        for s in shard_stats:
            print(f"  shard {s['shard']}: {len(s['segments'])} segments, "
                  f"{s['rows']} rows")
    else:
        session = SearchSession(idx, **session_kw)
    if meta.get("restored"):
        live = int(meta.get("live_rows", meta.get("valid_rows",
                                                  meta["rows"])))
        print(f"index: restored from {args.index_dir} in "
              f"{time.perf_counter() - t0:.2f}s "
              f"(v{meta.get('version', '?')}, "
              f"{meta.get('n_segments', 1)} segments, "
              f"{live} rows, {meta['n_leaves']} leaves)")
        dpi = int(meta.get("desc_per_image", dpi))
        # an index grown by appends carries no image geometry;
        # treat its contiguous id space as images of dpi rows each
        n_images = int(meta.get("images", 0)) or max(1, live // dpi)
    else:
        n_images = args.images
    dim = int(meta.get("dim", args.dim))
    print(f"corpus: {n_images} images x {dpi} descriptors x d={dim} "
          f"(layout={args.layout}, probes={args.probes}, k={args.k})")
    print(f"cost model: {session.active_cost_model()} "
          f"({len(session.index.calibration)} calibration records)")
    for p in session.plan_summary():
        tail = (f" rerank={p['rerank']}"
                if p["layout"] == "scan_codes" else "")
        print(f"bucket {p['bucket']:>6} rows: layout={p['layout']} "
              f"q_total={p['q_total']} block_rows={p['block_rows']} "
              f"q_cap={p['q_cap']} q_tile={p['q_tile']} p_cap={p['p_cap']}"
              + tail)

    warm_ms = session.warmup()
    print(f"warmup: {session.recompiles()} executors and device segments "
          f"built in {warm_ms / 1e3:.2f}s on {dev}")

    # ---- workload ---------------------------------------------------------
    corpus = corpus_vecs
    if corpus is None and args.index_dir:
        import os

        if os.path.isdir(persist.corpus_dir(args.index_dir)):
            corpus = persist.load_corpus(args.index_dir)
        else:
            # no corpus/ store (an index grown by appends): the
            # descriptor rows live in the segments — read them by id
            corpus = session.index
            live = int(meta.get("live_rows", 0))
            if live and live != int(meta.get("next_id", live)):
                print(
                    "warning: the id space has gaps (deletes); trace "
                    "requests that touch a missing descriptor id will "
                    "fail — restrict with --images/--desc-per-image"
                )
    gen = TraceLoadGenerator(corpus, dpi, noise=args.noise,
                             seed=args.trace_seed)
    mode = args.trace or "fixed"
    if mode == "fixed":
        # legacy --batches overrides; otherwise --requests applies here too
        n_req = (
            args.batches * args.batch_images
            if args.batches is not None
            else args.requests
        )
        rng = np.random.default_rng(args.trace_seed)
        replace = n_req > n_images
        image_ids = rng.choice(n_images, n_req, replace=replace)
        arrivals = np.zeros(n_req)
    elif mode == "multi":
        classes = default_tenant_mix(args.requests, rate=args.rate or 100.0)
        reqs = gen.multi_tenant(classes, n_images, seed=args.trace_seed)
        image_ids = [r.image_id for r in reqs]
    else:
        image_ids, arrivals = synth.sample_trace(
            args.requests, n_images, skew=mode, zipf_s=args.zipf_s,
            rate=args.rate, seed=args.trace_seed,
        )
    if mode != "multi":
        reqs = gen.requests(image_ids, arrivals)
    uniq = len(set(int(i) for i in image_ids))
    # fixed mode always bursts at t=0; --rate only paces the others
    paced = (args.rate or 100.0) if mode == "multi" else (
        args.rate if mode != "fixed" else None
    )
    print(f"trace: {mode}, {len(reqs)} requests over {uniq} distinct images"
          + (f", rate={paced}/s" if paced else ", all at t=0"))
    if mode == "multi":
        by_class = {}
        for r in reqs:
            by_class[r.priority] = by_class.get(r.priority, 0) + 1
        print("classes: " + ", ".join(
            f"{c}={n}" for c, n in sorted(by_class.items())
        ))

    batcher = MicroBatcher(session, max_wait_ms=max_wait_ms,
                           max_queue=args.max_queue,
                           scheduler=args.scheduler,
                           refresh_every=args.refresh_every)
    t0 = time.perf_counter()
    completions = batcher.run(reqs)
    wall = time.perf_counter() - t0

    # ---- report -----------------------------------------------------------
    m = session.metrics
    lat = m.latency.summary()
    print(
        f"served {m.requests}/{len(reqs)} requests "
        f"({m.rejected} rejected, {m.shed} shed, {m.downgraded} downgraded, "
        f"{m.engine_batches} micro-batches, "
        f"{m.cache_images} cache-served) in {wall:.2f}s wall "
        f"[scheduler={batcher.scheduler}]"
    )
    if lat.get("count"):
        print(
            f"latency: p50 {lat['p50_ms']:.1f} ms, p95 {lat['p95_ms']:.1f} ms, "
            f"p99 {lat['p99_ms']:.1f} ms (mean {lat['mean_ms']:.1f} ms)"
        )
        wait, comp = m.wait.summary(), m.compute.summary()
        if wait.get("count"):
            print(
                f"breakdown: queue-wait p95 {wait['p95_ms']:.1f} ms "
                f"(mean {wait['mean_ms']:.1f}), compute p95 "
                f"{comp['p95_ms']:.1f} ms (mean {comp['mean_ms']:.1f})"
            )
    for name, cm in sorted(
        m.per_class.items(), key=lambda kv: kv[0]
    ):
        cl = cm.latency.summary()
        if not cl.get("count") and not (cm.shed or cm.rejected):
            continue
        slo = (f"SLO<{cm.deadline_ms:.0f}ms attained "
               f"{cm.slo_attainment:.2f}  " if cm.deadline_ms else "")
        print(
            f"  class {name:<12} p50 {cl.get('p50_ms', 0.0):7.1f} ms  "
            f"p95 {cl.get('p95_ms', 0.0):7.1f} ms  " + slo +
            f"(done {cm.completed}, shed {cm.shed}, rej {cm.rejected})"
        )
    print(
        f"throughput: {m.ms_per_image:.1f} ms/image engine "
        f"(paper Exp #5: 210 ms/image), queue depth mean "
        f"{np.mean(m.queue_depth) if m.queue_depth else 0:.1f} "
        f"max {max(m.queue_depth) if m.queue_depth else 0}, "
        f"q_cap_overflow {m.q_cap_overflow}"
    )
    if session.cache.enabled:
        c = session.cache.stats()
        print(f"hot-leaf cache: {c['cached_leaves']}/{c['capacity_leaves']} "
              f"leaves, hit rate {c['hit_rate']:.2f} "
              f"({c['hits']} hits / {c['misses']} misses)")
    n_recomp = session.steady_state_recompiles()
    print(f"steady-state recompiles after warmup: {n_recomp} "
          f"({'OK' if n_recomp == 0 else 'REGRESSION'})")

    # make this run's measured ms/image durable: the next serve run's
    # plan(model="auto") then opens with a warm calibration store
    if args.index_dir and session.index.calibration.dirty:
        # best-effort: a lost calibration commit (concurrent committer,
        # full/read-only disk) must not fail an otherwise-good serve run
        try:
            v = session.index.commit()
            print(f"calibration: {len(session.index.calibration)} plan "
                  f"signatures committed (manifest v{v})")
        except OSError as e:  # incl. FileExistsError from a commit race
            print(f"warning: calibration not persisted ({e})")

    if not args.no_recall:
        ok = n = 0
        for c in completions:
            if c.ids is None:
                continue
            votes = np.asarray(c.ids)[:, 0]
            votes = votes[votes >= 0] // dpi
            if votes.size:
                vals, cnts = np.unique(votes, return_counts=True)
                ok += int(vals[np.argmax(cnts)] == c.image_id)
            n += 1
        if n:
            print(f"recall@1 (image voting): {ok}/{n} = {ok / n:.3f}")

    if args.json:
        payload = {
            "metrics": m.to_dict(),
            "cache": session.cache.stats(),
            "plans": session.plan_summary(),
            "cost_model": session.active_cost_model(),
            "plan_observations": session.index.calibration.snapshot(),
            "wall_s": wall,
            "shards": (
                session.per_shard_stats()
                if isinstance(session, ShardedSearchSession)
                else None
            ),
        }
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"metrics JSON -> {args.json}")

    if args.trace_out:
        from repro_torch.obs import export_trace, summary as trace_summary

        export_trace(tracer, args.trace_out)
        d = tracer.describe()
        print(f"trace -> {args.trace_out} ({d['spans']} spans, "
              f"{d['events']} events, {d['dropped']} dropped, "
              f"sample={d['sample']})")
        print(trace_summary(tracer, top=3))
    if args.metrics_out:
        from repro_torch.obs import get_registry

        get_registry().dump(args.metrics_out)
        print(f"metrics registry -> {args.metrics_out}")
    return 0 if n_recomp == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
