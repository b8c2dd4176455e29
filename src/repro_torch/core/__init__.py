"""Core of the port: index, engine, pruners, solvers, sparse containers, the
sharded engine and the Sinkhorn MoE router. Re-exports every public name
of the reference's ``repro.core``; ``count_collectives`` is the port's
run-time counter (``repro_torch.runtime.sharding``), not the reference's
jaxpr walk."""
from repro_torch.runtime.sharding import count_collectives

from .index import (CorpusIndex, DocGroup, IvfClusters, SearchResult,
                    WmdEngine, append_docs, auto_n_clusters, bucket_size,
                    build_index, default_n_clusters, load_index, save_index)
from .prune import (PRUNERS, CascadePruner, MaxPruner, Pruner, RwmdPruner,
                    WcdPruner, resolve_pruner)
from .sinkhorn import (LamUnderflowError, cdist, precompute, select_support,
                       sinkhorn_wmd_dense, sinkhorn_wmd_dense_stabilized,
                       underflow_report)
from .sinkhorn_sparse import (SolvePrecision, precompute_sparse,
                              precompute_sparse_log, reconstruct_gm,
                              sinkhorn_wmd_sparse,
                              sinkhorn_wmd_sparse_unfused)
from .sparse import (BlockSparse, PaddedDocs, block_density,
                     block_sparse_from_dense, padded_docs_from_dense,
                     padded_docs_from_lists, padded_docs_to_dense)
from .shard_index import (ShardCoverage, ShardSearchError,
                          ShardedCorpusIndex, ShardedWmdEngine,
                          append_docs_sharded, bin_pack_clusters,
                          restore_shard, shard_corpus, snapshot_shards)
from .wmd import IMPLS, many_to_many, one_to_many, search
from .router import route, sinkhorn_route, topk_route

__all__ = [
    "CorpusIndex", "DocGroup", "IvfClusters", "SearchResult", "WmdEngine",
    "append_docs", "auto_n_clusters", "bucket_size", "build_index",
    "default_n_clusters", "load_index", "save_index",
    "PRUNERS", "CascadePruner", "MaxPruner", "Pruner", "RwmdPruner",
    "WcdPruner", "resolve_pruner", "LamUnderflowError",
    "cdist", "precompute", "select_support", "sinkhorn_wmd_dense",
    "sinkhorn_wmd_dense_stabilized", "underflow_report", "SolvePrecision",
    "precompute_sparse", "precompute_sparse_log",
    "reconstruct_gm", "sinkhorn_wmd_sparse", "sinkhorn_wmd_sparse_unfused",
    "BlockSparse", "PaddedDocs", "block_density", "block_sparse_from_dense",
    "padded_docs_from_dense", "padded_docs_from_lists",
    "padded_docs_to_dense", "IMPLS", "many_to_many", "one_to_many", "search",
    "ShardCoverage", "ShardSearchError",
    "ShardedCorpusIndex", "ShardedWmdEngine", "append_docs_sharded",
    "bin_pack_clusters", "count_collectives", "restore_shard",
    "shard_corpus", "snapshot_shards",
    "route", "sinkhorn_route", "topk_route",
]
