"""Staged top-k WMD document retrieval on the PyTorch port.

    PYTHONPATH=src python examples/torch_wmd_search.py [--n-docs 2048] \
        [--queries 8] [--device cpu]

A stream of query documents retrieved against the whole corpus: the index
is frozen once on ``--device`` (the card by default), queries are bucketed
by support size, and each batch runs prune -> solve -> rank: a lower bound
(``--prune``) excludes most documents, the Sinkhorn solve runs only on the
survivors, and the exact top-k comes back with latency and the solved
count per query. ``--prune none`` scores every document; ``--mode refine``
solves only ``refine-factor * topk`` bound-ranked candidates per query;
``--looped`` scores each query alone with ``one_to_many``; ``--shards N``
splits the corpus into N cluster-aligned shards over ``corpus_mesh(N)``
(with one card, every shard on it) and merges their top-k.
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (IMPLS, PRUNERS, ShardedWmdEngine,  # noqa: E402
                              WmdEngine, build_index, one_to_many,
                              shard_corpus)
from repro_torch.core.device import resolve_device  # noqa: E402
from repro_torch.data.corpus import make_corpus  # noqa: E402
from repro_torch.runtime.sharding import corpus_mesh  # noqa: E402

LAM = 4.0   # distance scale here is ~sqrt(2*64) ~ 11; keep lam*dist << 87


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-docs", type=int, default=2048)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--topk", type=int, default=5)
    ap.add_argument("--prune", default="rwmd", choices=["none", *PRUNERS],
                    help="prune-stage lower bound or IVF cascade; "
                         "'none' = exhaustive")
    ap.add_argument("--nprobe", type=int, default=0,
                    help="ivf cascades: clusters probed per query "
                         "(0 = all = exact top-k)")
    ap.add_argument("--mode", default="exact", choices=["exact", "refine"],
                    help="'refine': solve only the top refine-factor*topk "
                         "bound-ranked candidates per query (needs --prune)")
    ap.add_argument("--refine-factor", type=int, default=4)
    ap.add_argument("--impl", default="kernel",
                    help="engine: kernel|sparse; --looped accepts any of "
                         f"{', '.join(IMPLS)}")
    ap.add_argument("--n-clusters", default=None,
                    help="IVF cluster count at index build (int or 'auto'; "
                         "default sqrt(n_docs))")
    ap.add_argument("--precision", default="fp32",
                    choices=["fp32", "bf16", "log", "bf16+log"])
    ap.add_argument("--tol", type=float, default=0.0,
                    help="> 0: the adaptive solve (15 iterations become a "
                         "cap)")
    ap.add_argument("--check-every", type=int, default=4)
    ap.add_argument("--scope", default="query", choices=["chunk", "query"])
    ap.add_argument("--warm-start", action="store_true")
    ap.add_argument("--shards", type=int, default=0,
                    help="> 1: cluster-aligned doc shards over "
                         "corpus_mesh(N); one top-k merge")
    ap.add_argument("--batches", type=int, default=4,
                    help="timed engine passes over the query set")
    ap.add_argument("--looped", action="store_true",
                    help="one_to_many per query instead of the engine")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the host)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    corpus = make_corpus(vocab_size=args.vocab, embed_dim=64,
                         n_docs=args.n_docs, n_queries=args.queries, seed=7)
    queries = list(corpus.queries)
    print(f"corpus: {args.n_docs} docs, vocab {args.vocab}, on {device}")

    if args.looped:
        def run():
            return np.stack([one_to_many(q, corpus.docs, corpus.vecs,
                                         lam=LAM, n_iter=15, impl=args.impl,
                                         device=device).cpu().numpy()
                             for q in queries])
        run()                                      # builds the kernels
        t0 = time.perf_counter()
        d = run()
        batch_ms = [(time.perf_counter() - t0) * 1e3]
        for qi, q in enumerate(queries):
            top = np.argsort(d[qi])[:args.topk]
            print(f"query {qi} (v_r={int((q > 0).sum())}): "
                  f"top-{args.topk} = {top.tolist()} "
                  f"d={np.round(d[qi][top].astype(float), 3).tolist()}")
    else:
        prune = None if args.prune == "none" else args.prune
        nprobe = args.nprobe if args.nprobe > 0 else None
        kw = dict(lam=LAM, n_iter=15, impl=args.impl,
                  tol=args.tol if args.tol > 0 else None,
                  check_every=args.check_every, precision=args.precision,
                  scope=args.scope, warm_start=args.warm_start)
        if args.shards > 1:
            mesh = corpus_mesh(args.shards, None if args.device is None
                               else [device])
            sindex = shard_corpus(corpus.docs, corpus.vecs, args.shards,
                                  n_clusters=args.n_clusters, devices=mesh)
            engine = ShardedWmdEngine(sindex, **kw)
            print(f"sharded: {engine.n_shards} cluster-aligned shards, "
                  f"docs/shard {list(engine.docs_per_shard)}, "
                  f"clusters/shard {list(engine.cluster_counts)}")
        else:
            index = build_index(corpus.docs, corpus.vecs, device=device,
                                n_clusters=args.n_clusters)   # frozen once
            engine = WmdEngine(index, **kw)

        def run():
            return engine.search(queries, args.topk, prune=prune,
                                 nprobe=nprobe, mode=args.mode,
                                 refine_factor=args.refine_factor)
        run()                                      # builds the kernels
        batch_ms = []
        for _ in range(args.batches):
            _sync(device)
            t0 = time.perf_counter()
            res = run()
            _sync(device)
            batch_ms.append((time.perf_counter() - t0) * 1e3)
        for qi, q in enumerate(queries):
            print(f"query {qi} (v_r={int((q > 0).sum())}): "
                  f"top-{args.topk} = {res.indices[qi].tolist()} "
                  f"d={np.round(res.distances[qi].astype(float), 3).tolist()} "
                  f"solved={int(res.solved[qi])}/{args.n_docs}")

    batch_ms = np.asarray(batch_ms)
    per_query = batch_ms.mean() / args.queries
    print(f"\nbatch latency p50={np.percentile(batch_ms, 50):.1f}ms "
          f"({args.queries} queries)  per-query={per_query:.2f}ms  "
          f"throughput={args.n_docs / (per_query / 1e3):,.0f} docs/s/query")
    if not args.looped and args.tol > 0:
        iters = engine.iter_stats()
        if iters.size:
            print(f"adaptive solve: realized iters/query "
                  f"mean={iters.mean():.1f} max={int(iters.max())} "
                  f"(cap 15, tol={args.tol:g}, scope={args.scope})")


if __name__ == "__main__":
    main()
