"""Serving launchers (port of ``repro.launch.serve``): the LM decode server
and the WMD query server.

``--arch <id>`` serves an LM built from its config with random weights
(seed 0; ``--reduced`` for the CPU-smoke-test variant): ``--batch``
sequences decode greedily for ``--steps`` tokens, one serve step per
token. MoE archs route every layer with the config's router (the paper's
Sinkhorn-Knopp solver for qwen2-moe and qwen3-moe). Prints one JSON
record: ms per step (p50, p99) and tokens per second over the steps after
the first two, and the card it ran on::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_moe_a2_7b \
        --batch 4 --steps 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \
        --reduced --device cpu --steps 4                       # host run

``--wmd`` scores ``--batch-queries`` stream requests per step through the
persistent engine: exhaustive ``query_batch`` by default, or the staged
top-k retrieval (prune -> solve -> rank) with ``--top-k K``; ``--prune
ivf+...`` runs the IVF cascade (``--nprobe P`` clusters per query,
``--n-clusters C|auto`` at index build) and ``--mode refine`` the
rank-then-refine search (``--refine-factor F``). ``--tol T`` runs the
adaptive solve (``--check-every``, ``--scope``, ``--warm-start``; the
record gains the realized iteration counts) and ``--precision`` picks
fp32, bf16, log or bf16+log. ``--impl sparse`` runs the einsum solve,
where ``--warm-start`` takes effect and ``--kcache-slots N`` keeps N
words' distance rows on the card across batches (the record gains the
cache's counters). Prints one JSON record with the per-batch latency and
the card it ran on::

    PYTHONPATH=src python -m repro_torch.launch.serve --wmd --top-k 10 \\
        --prune rwmd --n-docs 5000 --vocab 100000 --embed-dim 300 \\
        --precision log --lam 10
    PYTHONPATH=src python -m repro_torch.launch.serve --wmd --top-k 10 \\
        --prune ivf+wcd+rwmd --nprobe 4 --n-clusters auto --n-docs 5000 \\
        --vocab 100000 --embed-dim 300 --precision log --lam 10
    PYTHONPATH=src python -m repro_torch.launch.serve --wmd --top-k 10 \\
        --prune rwmd --n-docs 5000 --vocab 100000 --embed-dim 300 \\
        --lam 0.25 --tol 0.03 --check-every 2 --precision bf16
    PYTHONPATH=src python -m repro_torch.launch.serve --wmd --top-k 10 \\
        --impl sparse --kcache-slots 512 --prune ivf+wcd+rwmd \\
        --n-docs 5000 --vocab 100000 --embed-dim 300 --lam 1
    PYTHONPATH=src python -m repro_torch.launch.serve --wmd --device cpu \\
        --n-docs 64 --vocab 512 --embed-dim 16 --steps 3   # host run

``--serve`` drives the long-lived :class:`ServingRuntime` open-loop
(``--requests`` Poisson arrivals at ``--rate`` per second; deadline-or-full
micro-batching, backpressure, tiered degradation, ``--inject-*`` fault
injection) and prints one JSON line per request and a summary record.
The engine is the port's default ``--impl kernel`` (K1, K2 and K2s on the
card), which cannot host the K-column cache, so the runtime serves
without it; ``--impl sparse`` serves the einsum engine with the cache::

    PYTHONPATH=src python -m repro_torch.launch.serve --wmd --serve \\
        --top-k 10 --prune ivf+wcd+rwmd --n-docs 5000 --vocab 100000 \\
        --embed-dim 300 --precision log --lam 10 --requests 256 --rate 100
    PYTHONPATH=src python -m repro_torch.launch.serve --wmd --serve \\
        --device cpu --n-docs 48 --vocab 256 --embed-dim 8 --requests 8 \\
        --top-k 4 --rate 50                                  # host run

``--shards N`` (N > 1) partitions the corpus into N cluster-aligned doc
shards over ``corpus_mesh(N)`` (round-robin over the visible cards; with
one card every shard on it, with ``--device`` every shard on that device)
and serves through a :class:`ShardedWmdEngine`: each shard runs the whole
cascade (K1, K2 and K2s) and one ``all_gather`` merges the shards' top-k.
Under ``--serve`` the fan-out is deadline-bounded (``--shard-timeout-ms``),
shard faults can be injected (``--inject-shard-*``), responses that miss a
shard are tagged ``partial`` with their coverage, and ``--snapshot-dir``
writes per-shard snapshots after the warm-up. The record gains ``shards``
and ``docs_per_shard``::

    PYTHONPATH=src python -m repro_torch.launch.serve --wmd --serve \\
        --shards 2 --top-k 10 --prune ivf+wcd+rwmd --n-docs 5000 \\
        --vocab 100000 --embed-dim 300 --precision log --lam 10 \\
        --requests 64 --rate 8 --snapshot-dir build/wmd-snap
    PYTHONPATH=src python -m repro_torch.launch.serve --wmd --serve \\
        --shards 2 --device cpu --n-docs 48 --vocab 256 --embed-dim 8 \\
        --requests 8 --top-k 4 --inject-shard-crash 1        # host run
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.index import WmdEngine, build_index
from repro_torch.core.prune import PRUNERS
from repro_torch.core.sinkhorn import LamUnderflowError
from repro_torch.data.corpus import make_corpus
from repro_torch.data.pipeline import wmd_request_stream


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _build_engine(args):
    """(corpus, engine) for the flags: the synthetic corpus (seed 0) and
    its index on ``--device``, or with ``--shards N > 1`` its N shards
    over ``corpus_mesh(N)`` under a :class:`ShardedWmdEngine`."""
    device = resolve_device(args.device)
    corpus = make_corpus(vocab_size=args.vocab, embed_dim=args.embed_dim,
                         n_docs=args.n_docs, n_queries=8, seed=0)
    kw = dict(lam=args.lam, n_iter=args.n_iter, impl=args.impl,
              precision=args.precision,
              tol=args.tol if args.tol > 0 else None,
              check_every=args.check_every, scope=args.scope,
              warm_start=args.warm_start,
              kcache_slots=(args.kcache_slots
                            if args.kcache_slots > 0 else None))
    if args.shards > 1:
        from repro_torch.core.shard_index import (ShardedWmdEngine,
                                                  shard_corpus)
        from repro_torch.runtime.sharding import corpus_mesh
        mesh = corpus_mesh(args.shards, None if args.device is None
                           else [device])
        sindex = shard_corpus(corpus.docs, corpus.vecs, args.shards,
                              n_clusters=args.n_clusters, devices=mesh)
        timeout = args.shard_timeout_ms
        return corpus, ShardedWmdEngine(
            sindex, shard_timeout_s=timeout / 1e3 if timeout > 0 else None,
            snapshot_dir=args.snapshot_dir, **kw)
    index = build_index(corpus.docs, corpus.vecs, device=device,
                        n_clusters=args.n_clusters)
    return corpus, WmdEngine(index, **kw)


def serve_lm(args) -> dict:
    """Greedy decode of ``--batch`` sequences for ``--steps`` tokens; the
    reference's record plus the device."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import make_serve_step
    from repro_torch.models.transformer import Transformer
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    times = []
    with torch.inference_mode():
        model = Transformer(cfg, torch.Generator(device).manual_seed(0),
                            device=device)
        cache = model.init_cache(args.batch, max_len=args.steps + 8)
        step = make_serve_step(model)
        tok = torch.ones((args.batch, 1), dtype=torch.long, device=device)
        for _ in range(args.steps):
            _sync(device)
            t0 = time.perf_counter()
            tok, _, cache = step(cache, tok)
            _sync(device)
            times.append(time.perf_counter() - t0)
    times = np.asarray(times[2:] if len(times) > 2 else times) * 1e3
    rec = {"arch": cfg.name, "batch": args.batch, "steps": args.steps,
           "ms_per_token_p50": float(np.percentile(times, 50)),
           "ms_per_token_p99": float(np.percentile(times, 99)),
           "tokens_per_s": args.batch / (times.mean() / 1e3),
           "device": _device_name(device)}
    print(json.dumps(rec))
    return rec


def _shard_fields(engine) -> dict:
    """The record's ``shards`` and ``docs_per_shard`` for a sharded engine
    (and where its shards sit), nothing for a single one."""
    if getattr(engine, "n_shards", 1) <= 1:
        return {}
    return {"shards": engine.n_shards,
            "docs_per_shard": [int(n) for n in engine.docs_per_shard],
            "placement": [str(d) for d in engine.sindex.devices]}


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def serve_wmd(args) -> dict:
    corpus, engine = _build_engine(args)
    device = engine.device
    reqs = wmd_request_stream(corpus)
    bq = max(1, args.batch_queries)
    prune = None if args.prune == "none" else args.prune
    nprobe = args.nprobe if args.nprobe > 0 else None

    def score(batch):
        if args.top_k > 0:
            return engine.search(batch, args.top_k, prune=prune,
                                 nprobe=nprobe, mode=args.mode,
                                 refine_factor=args.refine_factor)
        return engine.query_batch(batch)

    times, solved = [], []
    underflows = 0
    for i in range(args.steps):
        batch = [next(reqs) for _ in range(bq)]
        _sync(device)
        t0 = time.perf_counter()
        try:
            out = score(batch)
        except LamUnderflowError:
            # per-request isolation: re-score one at a time so batchmates
            # still get answers; the failing request gets a JSON error
            out = None
            for qi, q in enumerate(batch):
                try:
                    sub = score([q])
                    out = sub if out is None else out
                except LamUnderflowError as e:
                    underflows += 1
                    print(json.dumps({
                        "step": i, "query": qi, "ok": False,
                        "error": {"code": "lam_underflow",
                                  "underflow_report": str(e)}}))
        _sync(device)
        times.append(time.perf_counter() - t0)
        if args.top_k > 0 and out is not None:
            solved.append(float(out.solved.mean()))
    # the first step builds the kernels and warms the allocator
    times = np.asarray(times[1:] if len(times) > 1 else times) * 1e3
    p50 = float(np.percentile(times, 50))
    rec = {
        "workload": "wmd_topk" if args.top_k > 0 else "wmd_batched",
        "impl": args.impl,
        "device": _device_name(device),
        "n_docs": args.n_docs, "vocab": args.vocab,
        "embed_dim": args.embed_dim, "batch_queries": bq,
        "steps": args.steps, "lam": args.lam, "n_iter": args.n_iter,
        "ms_per_batch_p50": p50,
        "queries_per_s": bq / (p50 / 1e3),
        "precision": engine.precision.name,
        "iter_stats_dropped": engine.iter_stats_dropped,
    }
    if underflows:
        rec["underflow_errors"] = underflows
    if engine.kcache_stats() is not None:
        rec["kcache"] = engine.kcache_stats()
    iters = engine.iter_stats()
    if args.tol > 0 and iters.size:
        rec["tol"] = args.tol
        rec["scope"] = args.scope
        rec["solve_iters_mean"] = float(iters.mean())
        rec["solve_iters_max"] = int(iters.max())
        for st, arr in engine.iter_stats_by_stage().items():
            if arr.size:
                rec[f"solve_iters_{st}_mean"] = float(arr.mean())
        if args.warm_start:
            rec["warm_start"] = True
    if args.top_k > 0:
        rec["top_k"] = args.top_k
        rec["prune"] = args.prune
        if args.mode != "exact":
            rec["mode"] = args.mode
            rec["refine_factor"] = args.refine_factor
        if solved:
            rec["solved_frac"] = float(np.mean(solved)) / args.n_docs
        if args.prune.startswith("ivf"):
            counts = getattr(engine, "cluster_counts", None) \
                or (engine.index.clusters.n_clusters,)
            rec["n_clusters"] = (list(counts) if len(counts) > 1
                                 else counts[0])
            rec["nprobe"] = nprobe if nprobe else \
                ("all" if len(counts) > 1 else counts[0])
    rec.update(_shard_fields(engine))
    print(json.dumps(rec))
    return rec


def serve_async(args) -> dict:
    """Drive the long-lived :class:`ServingRuntime` open-loop and print
    per-request JSON lines + a summary record (returned too)."""
    from repro_torch.runtime.serving import (FaultInjector, ServeConfig,
                                             ServingRuntime,
                                             poisson_arrivals, rwmd_topk,
                                             run_open_loop)
    corpus, engine = _build_engine(args)
    injector = None
    if args.inject_latency_rate or args.inject_transient_rate \
            or args.inject_poison_rate or args.inject_shard_latency_rate \
            or args.inject_shard_transient_rate \
            or args.inject_shard_crash >= 0:
        injector = FaultInjector(
            latency_rate=args.inject_latency_rate,
            latency_s=args.inject_latency_ms / 1e3,
            transient_rate=args.inject_transient_rate,
            poison_rate=args.inject_poison_rate,
            shard_latency_rate=args.inject_shard_latency_rate,
            shard_latency_s=args.inject_shard_latency_ms / 1e3,
            shard_transient_rate=args.inject_shard_transient_rate,
            crash_shard=args.inject_shard_crash,
            crash_after=args.inject_shard_crash_after,
            seed=args.inject_seed)
    cfg = ServeConfig(
        max_batch=max(1, args.batch_queries),
        window_s=args.window_ms / 1e3, max_queue=args.max_queue,
        deadline_s=args.deadline_ms / 1e3 if args.deadline_ms > 0 else None,
        prune="rwmd" if args.prune == "none" else args.prune,
        nprobe=args.nprobe if args.nprobe > 0 else None,
        refine_factor=args.refine_factor,
        kcache_slots=(args.kcache_slots if args.kcache_slots >= 0
                      else ServeConfig.kcache_slots))
    runtime = ServingRuntime(engine, cfg, injector=injector)
    k = max(1, args.top_k)
    # warm every tier OUTSIDE the measured stream (the first call builds
    # the kernels and warms the allocator)
    reqs = wmd_request_stream(corpus)
    warm = [next(reqs) for _ in range(2)]
    for tier in runtime.tiers:
        if tier.solve:
            engine.search(warm, k, prune=cfg.prune, nprobe=tier.nprobe,
                          mode=tier.mode,
                          refine_factor=tier.refine_factor or 4)
        else:
            rwmd_topk(engine, warm, k)
    engine.reset_iter_stats()
    if args.snapshot_dir and hasattr(engine, "snapshot"):
        # the recovery snapshot is taken after the warm-up, so a restored
        # shard rejoins with the kernels already built
        engine.snapshot()
    n = max(1, args.requests)
    queries = [next(reqs) for _ in range(n)]
    arrivals = poisson_arrivals(n, rate_per_s=args.rate, seed=1)
    # handle_signals: SIGTERM/SIGINT drain the admission queue instead of
    # killing in-flight futures; late arrivals get `shutting_down`
    responses, stats = run_open_loop(runtime, queries, arrivals, k=k,
                                     handle_signals=True)
    for r in responses:
        print(json.dumps(r.to_json()))
    lat = np.asarray([r.queue_ms + r.service_ms for r in responses
                      if r.ok])
    span = float(arrivals[-1]) + max(
        (r.service_ms for r in responses), default=0.0) / 1e3
    rec = {
        "workload": "wmd_serve", "impl": args.impl,
        "device": _device_name(engine.device),
        "n_docs": args.n_docs, "requests": n, "rate_qps": args.rate,
        "latency_ms_p50": round(float(np.percentile(lat, 50)), 2)
        if lat.size else None,
        "latency_ms_p99": round(float(np.percentile(lat, 99)), 2)
        if lat.size else None,
        "throughput_qps": round(n / span, 1) if span > 0 else None,
        "stats": stats,
        **_shard_fields(engine),
    }
    print(json.dumps(rec))
    return rec


def main(argv=None) -> None:
    from repro_torch.configs.base import ARCH_IDS
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS,
                    help="the LM decode server for this architecture "
                         "(families dense, moe, vlm, audio)")
    ap.add_argument("--reduced", action="store_true",
                    help="--arch: the config's reduced variant")
    ap.add_argument("--batch", type=int, default=4,
                    help="--arch: sequences decoded together")
    ap.add_argument("--wmd", action="store_true",
                    help="the WMD query server")
    ap.add_argument("--impl", default="kernel", choices=["kernel", "sparse"],
                    help="the solve: the Hopper kernel K1, or the einsum "
                         "solve (warm start and the K-column cache). "
                         "--serve keeps the kernel default, which cannot "
                         "host the K-column cache: a default server runs "
                         "without it; --impl sparse serves with it")
    ap.add_argument("--batch-queries", type=int, default=8)
    ap.add_argument("--steps", type=int, default=None,
                    help="decode steps (--arch; default 32) or query "
                         "batches (--wmd; default 8)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="> 0: staged top-k retrieval (prune->solve->rank) "
                         "instead of exhaustive scoring")
    ap.add_argument("--prune", default="rwmd",
                    choices=["none", *PRUNERS],
                    help="lower bound or IVF cascade for the prune stage "
                         "(with --top-k)")
    ap.add_argument("--nprobe", type=int, default=0,
                    help="ivf cascades: probe this many clusters per query "
                         "(0 = all = exact top-k)")
    ap.add_argument("--mode", default="exact", choices=["exact", "refine"],
                    help="with --top-k: 'refine' ranks candidates by the "
                         "bound and solves only the best refine-factor*k "
                         "per query")
    ap.add_argument("--refine-factor", type=int, default=4,
                    help="--mode refine: solve budget multiple (k' = "
                         "refine_factor*k)")
    ap.add_argument("--n-clusters", default=None,
                    help="IVF cluster count at index build (default: "
                         "sqrt(n_docs); 'auto' sweeps cluster-radius "
                         "statistics)")
    ap.add_argument("--precision", default="fp32",
                    choices=["fp32", "bf16", "log", "bf16+log"],
                    help="bf16 operands with fp32 sums and/or the "
                         "log-domain solve (underflow-free at any lam)")
    ap.add_argument("--tol", type=float, default=0.0,
                    help="> 0: the adaptive solve, which exits at this "
                         "relative doc-marginal residual; --n-iter becomes "
                         "a cap (counts land on 1 + k*check-every)")
    ap.add_argument("--check-every", type=int, default=4,
                    help="adaptive solve: iterations between residual "
                         "checks")
    ap.add_argument("--scope", default="query", choices=["chunk", "query"],
                    help="adaptive solve: 'query' scopes each query's "
                         "survivor exit to its own candidates and counts "
                         "iterations per query; 'chunk' tests every doc")
    ap.add_argument("--warm-start", action="store_true",
                    help="with --tol and --impl sparse: survivor solves "
                         "start from the seed solve's converged profile "
                         "(inert on the kernel impl, as in the reference)")
    ap.add_argument("--kcache-slots", type=int, default=-1,
                    help="> 0: the cross-request K-column cache with this "
                         "many device-resident (V,) distance rows, enabled "
                         "at engine build (needs --impl sparse; results "
                         "are bit-exact); 0: no cache; -1 (default): no "
                         "cache for --wmd, and for --serve the runtime's "
                         "default (ServeConfig.kcache_slots), which only "
                         "--impl sparse can host")
    ap.add_argument("--serve", action="store_true",
                    help="long-lived async serving runtime: "
                         "deadline-or-full micro-batching, backpressure, "
                         "tiered degradation, fault injection; prints a "
                         "JSON line per request and a summary record")
    ap.add_argument("--requests", type=int, default=32,
                    help="--serve: open-loop request count")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="--serve: offered load (requests/s)")
    ap.add_argument("--window-ms", type=float, default=10.0,
                    help="--serve: coalescer deadline (a partial batch "
                         "dispatches once its oldest member waited this)")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="--serve: admission bound (queued + in flight); "
                         "arrivals beyond it get structured rejections")
    ap.add_argument("--deadline-ms", type=float, default=500.0,
                    help="--serve: per-request deadline budget "
                         "(0 = none); blown budgets degrade, not drop")
    ap.add_argument("--inject-latency-rate", type=float, default=0.0,
                    help="fault injection: per-attempt probability of "
                         "added dispatch latency")
    ap.add_argument("--inject-latency-ms", type=float, default=50.0)
    ap.add_argument("--inject-transient-rate", type=float, default=0.0,
                    help="fault injection: per-dispatch probability of a "
                         "transient first-attempt failure (retried)")
    ap.add_argument("--inject-poison-rate", type=float, default=0.0,
                    help="fault injection: per-request probability of a "
                         "poison request (isolated, structured error)")
    ap.add_argument("--inject-seed", type=int, default=0,
                    help="fault injection: deterministic replay seed")
    ap.add_argument("--shards", type=int, default=0,
                    help="> 1: partition the corpus into this many "
                         "cluster-aligned doc shards over corpus_mesh(N) "
                         "(round-robin over the visible cards; every shard "
                         "on --device when it is given); per-shard "
                         "cascades merge through one all_gather")
    ap.add_argument("--shard-timeout-ms", type=float, default=30000.0,
                    help="sharded fan-out: per-dispatch deadline; shards "
                         "that miss it are left out of the merge and the "
                         "response is tagged partial (0 = wait forever)")
    ap.add_argument("--snapshot-dir", default=None,
                    help="sharded engine: write per-shard snapshots here "
                         "after the warm-up; restore_shard() rebuilds a "
                         "dead shard from them (bit-compatible)")
    ap.add_argument("--inject-shard-latency-rate", type=float, default=0.0,
                    help="fault injection: per-shard-attempt probability "
                         "of added latency inside the fan-out")
    ap.add_argument("--inject-shard-latency-ms", type=float, default=50.0)
    ap.add_argument("--inject-shard-transient-rate", type=float,
                    default=0.0,
                    help="fault injection: per-shard-attempt probability "
                         "of a transient failure (burns a shard retry)")
    ap.add_argument("--inject-shard-crash", type=int, default=-1,
                    help="fault injection: crash this shard id on every "
                         "attempt from --inject-shard-crash-after on "
                         "(-1 = off); responses go partial with honest "
                         "coverage")
    ap.add_argument("--inject-shard-crash-after", type=int, default=0,
                    help="fan-out sequence number the crash window opens "
                         "at")
    ap.add_argument("--n-docs", type=int, default=1024)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--embed-dim", type=int, default=64)
    # this synthetic corpus' distance scale is ~sqrt(2*embed_dim); lam must
    # keep lam*dist < ~87 in fp32 or K underflows (the engine raises)
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--n-iter", type=int, default=15)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions on the host)")
    args = ap.parse_args(argv)
    if args.steps is None:
        args.steps = 8 if (args.wmd or args.serve) else 32
    if args.serve:
        serve_async(args)
    elif args.wmd:
        serve_wmd(args)
    else:
        if not args.arch:
            ap.error("--arch is required for LM serving (or pass --wmd or "
                     "--serve)")
        serve_lm(args)


if __name__ == "__main__":
    main()
