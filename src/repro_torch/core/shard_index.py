"""Sharded corpus serving: cluster-aligned doc shards over a corpus mesh
(port of ``repro.core.shard_index``).

The corpus is partitioned into DOC SHARDS over the positions of a 1-D
:class:`~repro_torch.runtime.sharding.CorpusMesh`, and each shard runs the
whole single-device cascade (probe -> radius drop -> WCD -> RWMD ->
seed/survivor Sinkhorn) on its own position's device, as a full
:class:`~repro_torch.core.index.WmdEngine`: on the card that is K2, K2s
and K1 per shard.

- **Cluster-aligned**: whole IVF clusters per shard. One torch k-means
  runs over the whole corpus (:func:`shard_corpus`), a greedy bin-pack
  over cluster sizes balances doc counts, and each shard's
  :class:`CorpusIndex` is built by :func:`build_index` over its owned
  clusters (relabelled locally) as a precomputed quantizer.
- **One merge collective**: each shard's local top-k is packed into one
  (Q, 2k) float32 tensor on its own device (k distances, then k global
  doc ids as float lanes; exact below 2^24), and the global top-k is ONE
  :func:`~repro_torch.runtime.sharding.all_gather` of the (S, Q, 2k)
  stack to the mesh's first device followed by a stable sort there. Ties
  go to the lowest shard-major index, as ``lax.top_k``'s do, so one shard
  is bit-compatible with the single engine. The per-shard cascades are
  collective-free.
- **Exactness**: at ``nprobe=None`` the sharded top-k equals the single
  engine's up to tie order. A smaller ``nprobe`` applies per shard: each
  shard probes its ``nprobe`` nearest owned clusters.

The model is the reference's single controller: one process, one pool
thread per shard, positions that may repeat a device. With one card
every shard sits on ``cuda:0``; on the host every shard sits on
``"cpu"``, which is how the tests run 2, 4 and 8 shards in one process.
Kernel launches from the pool threads go to each shard's device (the
wrappers in :mod:`repro_torch.kernels.ops` pin it).

Fault tolerance, snapshots and recovery: :class:`ShardedWmdEngine`'s
fan-out is deadline-bounded and health-gated, a failed or late shard is
left out of the merge and the result is tagged with a
:class:`ShardCoverage`; :func:`snapshot_shards` / :func:`restore_shard`
persist and reload one shard at a time. One shard on the host::

    >>> from repro_torch.core.shard_index import (ShardedWmdEngine,
    ...                                           shard_corpus)
    >>> from repro_torch.data.corpus import make_corpus
    >>> c = make_corpus(vocab_size=64, embed_dim=8, n_docs=12,
    ...                 n_queries=2, words_per_doc=(3, 8), seed=0)
    >>> sindex = shard_corpus(c.docs, c.vecs, 1, n_clusters=3,
    ...                       devices=["cpu"])
    >>> engine = ShardedWmdEngine(sindex, lam=2.0, n_iter=10)
    >>> engine.search(list(c.queries), 3).indices.shape
    (2, 3)
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.runtime.fault_tolerance import PoisonStep, ShardHealth
from repro_torch.runtime.sharding import CorpusMesh, all_gather, corpus_mesh

from .index import (SearchResult, WmdEngine, _assign_clusters,
                    _compact_slots, _doc_centroids, _host, _kmeans,
                    append_docs, auto_n_clusters, build_index,
                    default_n_clusters, index_to_device, load_index,
                    save_index, snapshot_checksum)
from .sinkhorn import LamUnderflowError
from .sparse import PaddedDocs

# global doc ids ride through the merge collective as float32 payload
# lanes; above 2^24 the round trip stops being exact
_MAX_DOCS_F32 = 1 << 24


def bin_pack_clusters(sizes: np.ndarray, n_shards: int) -> np.ndarray:
    """Greedy bin-pack: assign whole clusters to shards, balancing doc
    count. Clusters are placed largest-first onto the currently lightest
    shard (LPT scheduling, within 4/3 of the optimal makespan). Returns
    ``shard_of_cluster`` (C,) int32. Deterministic: ties in both the size
    sort and the argmin break toward lower ids."""
    sizes = np.asarray(sizes, np.int64)
    order = np.argsort(-sizes, kind="stable")
    loads = np.zeros(n_shards, np.int64)
    shard_of = np.empty(sizes.shape[0], np.int32)
    for c in order:
        s = int(np.argmin(loads))
        shard_of[c] = s
        loads[s] += sizes[c]
    return shard_of


class ShardedCorpusIndex(NamedTuple):
    """Corpus partitioned into cluster-aligned doc shards over a mesh.

    Each shard's :class:`CorpusIndex` speaks its own local id space;
    ``global_ids[s]`` lifts shard-local caller ids to the global caller
    ids the sharded engine reports, and ``owner`` maps a global doc id to
    its shard."""

    shards: tuple            # tuple[CorpusIndex], one per mesh position
    global_ids: tuple        # tuple[np (n_s,)]: shard-local -> global id
    owner: np.ndarray        # (N,) host: global doc id -> shard
    centers: torch.Tensor    # (C, w) global k-means centers, mesh device 0
    shard_of_cluster: np.ndarray  # (C,) host: global cluster -> shard
    mesh: CorpusMesh         # 1-D mesh, axis "shard"

    @property
    def devices(self) -> tuple:
        return self.mesh.devices

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def n_docs(self) -> int:
        return int(self.owner.shape[0])

    @property
    def docs_per_shard(self) -> tuple:
        return tuple(ix.n_docs for ix in self.shards)

    @property
    def cluster_counts(self) -> tuple:
        return tuple(ix.clusters.n_clusters for ix in self.shards)


def _mesh(n_shards: int, devices) -> CorpusMesh:
    mesh = (devices if isinstance(devices, CorpusMesh)
            else corpus_mesh(n_shards, devices))
    if mesh.size != n_shards:
        raise ValueError(f"{n_shards} shards on a mesh of {mesh.size} "
                         "positions")
    return mesh


def shard_corpus(docs: PaddedDocs, vecs, n_shards: int, doc_groups: int = 4,
                 n_clusters=None, ivf_iters: int = 10, ivf_seed: int = 0,
                 devices=None, n_pivots: int = 8,
                 pivot_seed: int = 0) -> ShardedCorpusIndex:
    """Partition a corpus into cluster-aligned doc shards.

    One k-means over the per-doc centroids (the quantizer
    :func:`build_index` would freeze), on the mesh's first device; then
    :func:`bin_pack_clusters` balances whole clusters over ``n_shards`` by
    doc count, and each shard's :class:`CorpusIndex` is built over its
    owned docs with its subset of the global centers as a precomputed
    quantizer, then placed on its position's device
    (:func:`index_to_device`). The vocabulary embeddings are replicated
    per shard; doc-proportional state is ~N/S per shard.

    ``devices`` is a :class:`CorpusMesh` of ``n_shards`` positions, or the
    devices :func:`corpus_mesh` deals the shards to (default: the visible
    CUDA devices, round-robin; repeats allowed). ``n_clusters`` resolves
    as in :func:`build_index` and is clamped up to ``n_shards`` so every
    shard can own a cluster; ``n_pivots``/``pivot_seed`` go to each
    shard's build (the pivots are chosen over the replicated vocabulary,
    so every shard freezes the same set).

    Raises ``ValueError`` when the corpus reaches the merge's 2^24 id-lane
    limit, when ``n_docs < n_shards``, or when a shard would own no docs;
    ``RuntimeError`` when no device is named and no CUDA device is
    visible."""
    n_shards = int(n_shards)
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    mesh = _mesh(n_shards, devices)
    dev0 = mesh.devices[0]
    idx_np, val_np = _compact_slots(docs)
    n_docs = idx_np.shape[0]
    if n_docs >= _MAX_DOCS_F32:
        raise ValueError(
            f"sharded merge packs doc ids into float32 lanes; corpus size "
            f"{n_docs} >= 2^24 breaks the exact round-trip")
    if n_docs < n_shards:
        raise ValueError(f"cannot spread {n_docs} docs over {n_shards} "
                         f"shards")
    vecs_np = np.asarray(_host(vecs), np.float32)
    centroids = _doc_centroids(
        torch.as_tensor(idx_np, dtype=torch.int64, device=dev0),
        torch.as_tensor(val_np, device=dev0),
        torch.as_tensor(vecs_np, device=dev0))
    if isinstance(n_clusters, str):
        if n_clusters == "auto":
            n_clusters = auto_n_clusters(centroids, seed=ivf_seed)
        elif n_clusters.isdigit():
            n_clusters = int(n_clusters)
        else:
            raise ValueError(f"n_clusters must be an int, None, or "
                             f"'auto', got {n_clusters!r}")
    elif n_clusters is None:
        n_clusters = default_n_clusters(n_docs)
    n_clusters = max(n_shards, min(int(n_clusters), n_docs))

    centers, assign = _kmeans(centroids, n_clusters, n_iters=ivf_iters,
                              seed=ivf_seed)
    centers_np = centers.cpu().numpy()
    sizes = np.bincount(assign, minlength=n_clusters)
    shard_of_cluster = bin_pack_clusters(sizes, n_shards)

    shards, global_ids = [], []
    owner = np.empty(n_docs, np.int32)
    for s in range(n_shards):
        owned = np.nonzero(shard_of_cluster == s)[0]
        doc_sel = np.nonzero(np.isin(assign, owned))[0].astype(np.int32)
        if doc_sel.size == 0:
            raise ValueError(
                f"shard {s} of {n_shards} would own no docs "
                f"({n_clusters} clusters, sizes {sizes.tolist()}); use "
                f"fewer shards or more clusters")
        owner[doc_sel] = s
        relabel = np.full(n_clusters, -1, np.int32)
        relabel[owned] = np.arange(owned.size, dtype=np.int32)
        ix = build_index(
            PaddedDocs(idx=idx_np[doc_sel], val=val_np[doc_sel]), vecs_np,
            device=dev0, doc_groups=doc_groups,
            clusters=(centers_np[owned], relabel[assign[doc_sel]]),
            n_pivots=n_pivots, pivot_seed=pivot_seed)
        shards.append(index_to_device(ix, mesh.devices[s]))
        global_ids.append(doc_sel)
    return ShardedCorpusIndex(
        shards=tuple(shards), global_ids=tuple(global_ids), owner=owner,
        centers=centers, shard_of_cluster=shard_of_cluster, mesh=mesh)


def append_docs_sharded(sindex: ShardedCorpusIndex,
                        new_docs: PaddedDocs) -> ShardedCorpusIndex:
    """Streaming sharded append: route each new doc to the shard owning
    its nearest frozen global center, then run the single-device
    :func:`append_docs` on each grown shard. Every shard's quantizer is a
    subset of the global centers and the routed shard holds the global
    argmin center, so the per-shard assignment agrees with the global one:
    append-then-search equals rebuild-then-search at ``nprobe=None``."""
    n_new = new_docs.idx.shape[0]
    if n_new == 0:
        return sindex
    new_idx, new_val = _compact_slots(new_docs)
    n_old = sindex.n_docs
    if n_old + n_new >= _MAX_DOCS_F32:
        raise ValueError("appended corpus would exceed the 2^24-doc "
                         "float32 id-lane limit of the sharded merge")
    dev0 = sindex.centers.device
    cent_new = _doc_centroids(
        torch.as_tensor(new_idx, dtype=torch.int64, device=dev0),
        torch.as_tensor(new_val, device=dev0),
        sindex.shards[0].vecs.to(dev0))
    assign_new = _assign_clusters(cent_new, sindex.centers).cpu().numpy()
    owner_new = sindex.shard_of_cluster[assign_new]

    shards, global_ids = list(sindex.shards), list(sindex.global_ids)
    tail = np.arange(n_old, n_old + n_new, dtype=np.int32)
    for s in range(sindex.n_shards):
        mine = np.nonzero(owner_new == s)[0]
        if mine.size == 0:
            continue
        shards[s] = append_docs(
            shards[s], PaddedDocs(idx=new_idx[mine], val=new_val[mine]))
        global_ids[s] = np.concatenate([global_ids[s], tail[mine]])
    return sindex._replace(
        shards=tuple(shards), global_ids=tuple(global_ids),
        owner=np.concatenate([sindex.owner, owner_new.astype(np.int32)]))


class ShardSearchError(Exception):
    """Structured shard fan-out failure, naming the shard(s) involved.

    Raised when a shard's dispatch exhausts its retry budget, or by the
    fan-out itself when every shard failed and there is nothing to merge.
    Deliberately not a ``RuntimeError``: the serving ``DispatchGuard``
    classifies ``RuntimeError`` as transient and retryable, and a fan-out
    that already spent its own per-shard retries must not be retried again
    upstream (the ``DispatchFailed`` convention)."""

    def __init__(self, message: str, shard_reasons: dict | None = None):
        super().__init__(message)
        self.shard_reasons = dict(shard_reasons or {})


class ShardCoverage(NamedTuple):
    """How much of the corpus a sharded result actually covers.

    ``fraction == 1.0`` (empty ``missing_shards``) means every shard
    contributed and the usual exactness contract holds; anything less is
    a PARTIAL result: still a true top-k over the responding shards'
    docs, but recall against the full corpus is bounded above by
    ``fraction`` and the serving layer must not claim exactness."""

    fraction: float          # covered docs / corpus docs
    covered_docs: int
    missing_shards: tuple    # shard ids that did not contribute
    reasons: dict            # {shard id: "timeout" | "open_circuit" | error}

    @property
    def full(self) -> bool:
        return not self.missing_shards


# ----------------------------------------------------------------- snapshots
_SHARD_META_FILE = "meta.npz"


def _shard_file(shard_id: int) -> str:
    return f"shard_{shard_id:04d}.npz"


def snapshot_shards(sindex: ShardedCorpusIndex, snapshot_dir) -> list:
    """Persist a sharded index: one :func:`save_index` file per shard
    (``shard_%04d.npz``) plus a checksummed ``meta.npz`` with the
    mesh-level state (owner map, global centers, cluster -> shard map,
    per-shard global ids), the reference's layout. Recovery granularity
    is one shard (:func:`restore_shard`). Returns the written paths."""
    os.makedirs(snapshot_dir, exist_ok=True)
    paths = []
    for si, ix in enumerate(sindex.shards):
        p = os.path.join(snapshot_dir, _shard_file(si))
        save_index(ix, p)
        paths.append(p)
    meta = {
        "owner": np.asarray(sindex.owner),
        "centers": sindex.centers.detach().cpu().numpy(),
        "shard_of_cluster": np.asarray(sindex.shard_of_cluster),
        "n_shards": np.asarray(sindex.n_shards, np.int64),
    }
    for si, gids in enumerate(sindex.global_ids):
        meta[f"global_ids_{si}"] = np.asarray(gids)
    meta["checksum"] = np.asarray(snapshot_checksum(meta), np.uint32)
    mp = os.path.join(snapshot_dir, _SHARD_META_FILE)
    with open(mp, "wb") as f:
        np.savez(f, **meta)
    paths.append(mp)
    return paths


def read_snapshot_meta(snapshot_dir) -> dict:
    """The verified ``meta.npz`` of a :func:`snapshot_shards` directory
    (``ValueError`` on a bad checksum), checksum removed."""
    with np.load(os.path.join(snapshot_dir, _SHARD_META_FILE)) as z:
        meta = {k: z[k] for k in z.files}
    stored = int(meta.pop("checksum"))
    actual = snapshot_checksum(meta)
    if actual != stored:
        raise ValueError(
            f"sharded snapshot meta in {snapshot_dir!r} failed its "
            f"integrity check (stored crc32 {stored:#010x}, recomputed "
            f"{actual:#010x})")
    return meta


def restore_shard(sindex: ShardedCorpusIndex, shard_id: int,
                  snapshot_dir) -> ShardedCorpusIndex:
    """Dead-shard recovery: reload shard ``shard_id`` from its
    :func:`snapshot_shards` file onto its position's device and return the
    sharded index with that shard replaced.

    Validates before trusting: the meta checksum must verify, the
    snapshot's shard count must match the live mesh, and its global ids
    for this shard must equal the live ones (a snapshot taken before an
    :func:`append_docs_sharded` is STALE for the grown shard; restoring it
    would silently drop documents, so that is a ``ValueError``).
    Restore-then-search is bit-compatible with never-failed search."""
    si = int(shard_id)
    meta = read_snapshot_meta(snapshot_dir)
    snap_shards = int(meta["n_shards"])
    if snap_shards != sindex.n_shards:
        raise ValueError(f"snapshot has {snap_shards} shards; live mesh "
                         f"has {sindex.n_shards}")
    if not 0 <= si < sindex.n_shards:
        raise ValueError(f"shard id {si} out of range "
                         f"[0, {sindex.n_shards})")
    gids = meta[f"global_ids_{si}"]
    if not np.array_equal(gids, sindex.global_ids[si]):
        raise ValueError(
            f"snapshot for shard {si} is STALE: it covers {gids.size} "
            f"docs but the live shard owns {sindex.global_ids[si].size} "
            f"(the corpus grew since the snapshot; re-snapshot after "
            f"append_docs_sharded)")
    ix = load_index(os.path.join(snapshot_dir, _shard_file(si)),
                    device=sindex.devices[si])
    shards = sindex.shards[:si] + (ix,) + sindex.shards[si + 1:]
    return sindex._replace(shards=shards)


def load_shards(snapshot_dir, devices=None) -> ShardedCorpusIndex:
    """A whole :class:`ShardedCorpusIndex` from a :func:`snapshot_shards`
    directory (the reference's or the port's), every file verified;
    ``devices`` as in :func:`shard_corpus`."""
    meta = read_snapshot_meta(snapshot_dir)
    n = int(meta["n_shards"])
    mesh = _mesh(n, devices)
    shards = tuple(load_index(os.path.join(snapshot_dir, _shard_file(s)),
                              device=mesh.devices[s]) for s in range(n))
    return ShardedCorpusIndex(
        shards=shards,
        global_ids=tuple(np.asarray(meta[f"global_ids_{s}"], np.int32)
                         for s in range(n)),
        owner=np.asarray(meta["owner"], np.int32),
        centers=torch.as_tensor(np.asarray(meta["centers"], np.float32),
                                device=mesh.devices[0]),
        shard_of_cluster=np.asarray(meta["shard_of_cluster"], np.int32),
        mesh=mesh)


# --------------------------------------------------------------- the merge
def _pack(ids, dists, gids: np.ndarray, nq: int, k: int) -> np.ndarray:
    """One shard's (Q, 2k) float32 lane: k ascending distances (+inf where
    invalid) then k global ids as floats (-1 where invalid)."""
    packed = np.full((nq, 2 * k), np.inf, np.float32)
    packed[:, k:] = -1.0
    ks = ids.shape[1]
    g = np.where(ids >= 0, gids[np.maximum(ids, 0)], -1)
    d = np.asarray(dists, np.float32)
    packed[:, :ks] = np.where((ids >= 0) & np.isfinite(d), d, np.inf)
    packed[:, k:k + ks] = g.astype(np.float32)
    return packed


def merge_topk(parts, k: int, dst):
    """The one cross-shard collective and the global top-k: ``parts`` is
    one (Q, 2k) packed tensor per mesh position, on its device. One
    :func:`all_gather` stacks them (S, Q, 2k) on ``dst``; the flattening
    is shard-major with shard 0 first and a stable sort keeps that order
    among equal distances, as ``lax.top_k``'s lowest-index tie-break does.
    Returns (distances (Q, k), global ids (Q, k) as floats) on ``dst``."""
    packed = all_gather(parts, dst)
    s_count, qn = packed.shape[:2]
    scores = packed[:, :, :k].transpose(0, 1).reshape(qn, s_count * k)
    ids = packed[:, :, k:].transpose(0, 1).reshape(qn, s_count * k)
    dist, pos = torch.sort(scores, dim=1, stable=True)
    return dist[:, :k], torch.gather(ids, 1, pos[:, :k])


class ShardedWmdEngine:
    """Sharded counterpart of :class:`~repro_torch.core.index.WmdEngine`.

    Holds one :class:`WmdEngine` per shard (identical hyperparameters),
    each on its own position's device. ``search`` runs the per-shard
    cascades concurrently on a pool of one thread per shard (torch
    releases the GIL while the card computes, so on several cards the
    shards overlap; on one card their host work is serialized by the
    GIL), lifts shard-local ids to global ids and merges through ONE
    ``all_gather`` and a stable top-k (:func:`merge_topk`). It exposes the
    duck-typed surface ``runtime/serving.py`` consumes (``search``,
    ``rwmd_topk``, ``min_bucket``, ``iter_stats*``, ``dtype``, ``impl``,
    ``precision``, ``shard_fault_hook``, ``last_coverage``, ``health``)
    plus ``n_shards``, ``docs_per_shard``, ``cluster_counts`` and
    ``iter_stats_by_shard``; ``merge_seconds`` sums the merge's wall time.

    Fault tolerance: the fan-out is deadline-bounded and health-gated.
    Each shard dispatch runs under a retry loop (``shard_retries``
    transient retries of ``RuntimeError``/``OSError`` with exponential
    backoff: on the card that covers a CUDA error, an out-of-memory error
    and a failed kernel launch); the collection waits at most
    ``shard_timeout_s`` for the whole fan-out; a shard that times out or
    fails is left out of the merge (its lane stays at the +inf/-1
    defaults, so the collective is the same) and the result is tagged in
    ``last_coverage``. A :class:`~repro_torch.runtime.fault_tolerance.ShardHealth`
    breaker skips a shard that keeps failing and probes it on a fixed
    cadence; ``snapshot()``/``restore_shard()`` persist and recover
    shards. ``last_coverage`` is a plain attribute: safe under the serving
    runtime, which serializes dispatches on one thread.

    ``LamUnderflowError`` is not a shard fault: it re-raises, naming the
    owning shard. ``query_batch`` is the unguarded debugging path. Every
    :class:`WmdEngine` keyword is forwarded to each shard."""

    def __init__(self, sindex: ShardedCorpusIndex, *,
                 shard_timeout_s: float | None = 30.0,
                 shard_retries: int = 1, shard_backoff_s: float = 0.01,
                 fail_threshold: int = 3, probe_every: int = 4,
                 snapshot_dir: str | None = None,
                 shard_fault_hook=None, **engine_kwargs):
        self.sindex = sindex
        # a restored shard's engine is rebuilt with the same keywords
        self._engine_kwargs = dict(engine_kwargs)
        self.engines = tuple(WmdEngine(ix, **engine_kwargs)
                             for ix in sindex.shards)
        e0 = self.engines[0]
        self.lam, self.n_iter = e0.lam, e0.n_iter
        self.impl, self.min_bucket, self.dtype = e0.impl, e0.min_bucket, \
            e0.dtype
        self.precision, self.tol = e0.precision, e0.tol
        self.device = sindex.devices[0]        # where the merge runs
        self._pool = ThreadPoolExecutor(max_workers=sindex.n_shards,
                                        thread_name_prefix="wmd-shard")
        self.merge_seconds = 0.0
        self.shard_timeout_s = shard_timeout_s
        self.shard_retries = max(0, int(shard_retries))
        self.shard_backoff_s = float(shard_backoff_s)
        self.health = ShardHealth(sindex.n_shards,
                                  fail_threshold=fail_threshold,
                                  probe_every=probe_every)
        self.snapshot_dir = snapshot_dir
        # fault-injection entry point (shard, fan-out seq, attempt) ->
        # None, run inside the per-shard retry region; the serving
        # runtime wires FaultInjector.before_shard_attempt here
        self.shard_fault_hook = shard_fault_hook
        self.fanouts = 0       # fan-out sequence counter (chaos drills
        #                        key crash windows off it)
        self.last_coverage = ShardCoverage(1.0, sindex.n_docs, (), {})

    # ------------------------------------------------------------- surface
    @property
    def n_shards(self) -> int:
        return self.sindex.n_shards

    @property
    def n_docs(self) -> int:
        return self.sindex.n_docs

    @property
    def docs_per_shard(self) -> tuple:
        return self.sindex.docs_per_shard

    @property
    def cluster_counts(self) -> tuple:
        return self.sindex.cluster_counts

    @property
    def iter_stats_dropped(self) -> int:
        return sum(e.iter_stats_dropped for e in self.engines)

    def reset_iter_stats(self) -> None:
        for e in self.engines:
            e.reset_iter_stats()
        self.merge_seconds = 0.0

    def iter_stats(self, stage: str | None = None) -> np.ndarray:
        """Realized iteration counts of every shard, concatenated (per
        shard: :meth:`iter_stats_by_shard`)."""
        parts = [e.iter_stats(stage=stage) for e in self.engines]
        return (np.concatenate(parts) if parts
                else np.zeros((0,), np.int64))

    def iter_stats_by_stage(self) -> dict:
        stages: list[str] = []
        for e in self.engines:
            for st in e.iter_stats_by_stage():
                if st not in stages:
                    stages.append(st)
        return {st: self.iter_stats(stage=st) for st in stages}

    def iter_stats_by_shard(self) -> dict:
        """{shard id: {stage: realized iteration counts}}."""
        return {s: e.iter_stats_by_stage()
                for s, e in enumerate(self.engines)}

    # -------------------------------------------------- cross-request cache
    def enable_kcache(self, slots: int) -> bool:
        """Attach a K-column cache to every shard engine (each against its
        own ``vecs``); a restored shard gets a fresh one of the same size.
        Returns ``False`` (attaching nothing) on the kernel impl."""
        ok = all(e.enable_kcache(slots) for e in self.engines)
        if ok:
            self._engine_kwargs["kcache_slots"] = int(slots)
        return ok

    def kcache_stats(self) -> dict | None:
        """Shard-summed cache counters (``None`` when no shard carries a
        cache); the per-shard split under ``"per_shard"``."""
        per = [e.kcache_stats() for e in self.engines]
        if all(p is None for p in per):
            return None
        agg: dict = {"slots": 0, "used": 0, "hits": 0, "misses": 0,
                     "evictions": 0, "inserts": 0, "lookups": 0,
                     "fallbacks": 0, "oversize": 0}
        for p in per:
            for key in agg:
                agg[key] += p.get(key, 0) if p else 0
        total = agg["hits"] + agg["misses"]
        agg["hit_rate"] = round(agg["hits"] / total, 4) if total else 0.0
        agg["per_shard"] = per
        return agg

    def reset_kcache_stats(self) -> None:
        for e in self.engines:
            e.reset_kcache_stats()

    # --------------------------------------------------------------- merge
    def _merge_topk(self, per_shard: dict, nq: int, k: int):
        """Pack ``{shard id: (indices, distances)}`` into one (Q, 2k) lane
        per shard on its own device and merge (:func:`merge_topk`). A shard
        absent from the dict (timed out, failed, open circuit) keeps its
        lane at the +inf/-1 defaults, inert in the sort, so a partial merge
        runs the same collective as a full one. Returns host (Q, k) ids
        (int32, -1 pad) and distances (NaN pad), ascending."""
        t0 = time.perf_counter()
        parts = []
        for si in range(self.n_shards):
            if si in per_shard:
                ids, dists = per_shard[si]
                lane = _pack(np.asarray(ids), dists,
                             self.sindex.global_ids[si], nq, k)
            else:
                lane = _pack(np.full((nq, 0), -1, np.int32),
                             np.zeros((nq, 0), np.float32),
                             self.sindex.global_ids[si], nq, k)
            parts.append(torch.as_tensor(lane, device=self.sindex.devices[si]))
        dist, ids = merge_topk(parts, k, self.device)
        dist = dist.cpu().numpy()
        ids = ids.cpu().numpy().astype(np.int32)
        dist = np.where(ids >= 0, dist, np.nan).astype(self.dtype)
        self.merge_seconds += time.perf_counter() - t0
        return ids, dist

    # -------------------------------------------------------------- search
    def _shard_search(self, si: int, queries, k, prune, nprobe, mode,
                      refine_factor):
        try:
            return self.engines[si].search(queries, k, prune=prune,
                                           nprobe=nprobe, mode=mode,
                                           refine_factor=refine_factor)
        except LamUnderflowError as e:
            raise LamUnderflowError(
                f"owning shard {si} of {self.n_shards} "
                f"({self.docs_per_shard[si]} docs; any doc counts below "
                f"are shard-local, reported ids are external): {e}"
            ) from e

    def _guarded_shard(self, si: int, seq: int, fn):
        """One shard's dispatch under its retry loop (on the shard's pool
        thread). Transient failures (``RuntimeError``, ``OSError``: CUDA
        errors, out of memory, a failed kernel launch) back off
        exponentially up to ``shard_retries`` times; deterministic
        per-request failures (``LamUnderflowError``, ``PoisonStep``)
        re-raise at once; exhaustion raises a :class:`ShardSearchError`
        naming the shard. Returns ``(service_seconds, result)``."""
        last = None
        for attempt in range(self.shard_retries + 1):
            t0 = time.perf_counter()
            try:
                if self.shard_fault_hook is not None:
                    self.shard_fault_hook(si, seq, attempt)
                return time.perf_counter() - t0, fn(si)
            except (PoisonStep, FloatingPointError):
                raise          # deterministic per-request: never a retry
            except (RuntimeError, OSError) as e:
                last = e
                if attempt < self.shard_retries:
                    time.sleep(self.shard_backoff_s * (2 ** attempt))
        raise ShardSearchError(
            f"shard {si} of {self.n_shards} failed after "
            f"{self.shard_retries + 1} attempts "
            f"({type(last).__name__}: {last})",
            {si: f"{type(last).__name__}: {last}"}) from last

    def _fan_out(self, fn, label: str):
        """Deadline-bounded, health-gated fan-out of ``fn(si)`` across
        shards. Returns ``({shard id: result}, ShardCoverage)`` and updates
        ``last_coverage`` and ``health``.

        Open-circuited shards are skipped (probed on the breaker's cadence);
        if every circuit is open, all shards are probed: the engine never
        refuses to serve on breaker state alone. One wall-clock deadline of
        ``shard_timeout_s`` bounds the whole collection; a shard that
        misses it is recorded as ``"timeout"`` and left out (its thread
        finishes in the background: Python cannot preempt a running
        dispatch). A ``LamUnderflowError`` from any shard re-raises after
        the others drain. Raises :class:`ShardSearchError` only when no
        shard responded."""
        seq = self.fanouts
        self.fanouts += 1
        reasons: dict = {}
        live = []
        for si in range(self.n_shards):
            if self.health.admit(si):
                live.append(si)
            else:
                reasons[si] = "open_circuit"
        if not live:                     # all circuits open: probe all
            live = sorted(reasons)
            reasons = {}
        futures = {si: self._pool.submit(self._guarded_shard, si, seq, fn)
                   for si in live}
        deadline = (None if self.shard_timeout_s is None
                    else time.monotonic() + self.shard_timeout_s)
        results: dict = {}
        underflow = None
        for si, f in futures.items():
            try:
                remaining = (None if deadline is None
                             else max(0.0, deadline - time.monotonic()))
                dt, out = f.result(timeout=remaining)
                results[si] = out
                self.health.record_success(si, dt)
            except _FutTimeout:
                reasons[si] = "timeout"
                self.health.record_failure(si)
            except LamUnderflowError as e:
                underflow = e
            except Exception as e:  # noqa: BLE001 — fan-out boundary
                reasons[si] = (str(e) if isinstance(e, ShardSearchError)
                               else f"{type(e).__name__}: {e}")
                self.health.record_failure(si)
        if underflow is not None:
            raise underflow
        if not results:
            detail = "; ".join(f"shard {s}: {r}"
                               for s, r in sorted(reasons.items()))
            raise ShardSearchError(
                f"{label}: all {self.n_shards} shards failed ({detail})",
                reasons)
        covered = sum(self.docs_per_shard[si] for si in results)
        cov = ShardCoverage(
            fraction=covered / max(self.n_docs, 1), covered_docs=covered,
            missing_shards=tuple(si for si in range(self.n_shards)
                                 if si not in results),
            reasons=reasons)
        self.last_coverage = cov
        return results, cov

    def search(self, queries: Sequence, k: int, prune: object = "rwmd",
               nprobe: int | None = None, mode: str = "exact",
               refine_factor: int = 4) -> SearchResult:
        """Sharded staged top-k: per-shard search, then the
        one-collective global merge. Same contract as
        :meth:`WmdEngine.search`, with ``nprobe`` per shard; ``solved``
        sums each query's exact solves over the shards. ``mode="refine"``
        refines per shard (each shard solves its own best
        ``refine_factor * k``); the merge is unchanged.

        Under shard failure the result is PARTIAL: a true top-k over the
        responding shards only, reported in ``last_coverage``; a caller
        that needs the exactness contract checks ``last_coverage.full``."""
        queries = [np.asarray(q) for q in queries]
        nq = len(queries)
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        k = min(int(k), self.n_docs)
        if nq == 0:
            self.last_coverage = ShardCoverage(1.0, self.n_docs, (), {})
            return SearchResult(np.full((0, k), -1, np.int32),
                                np.full((0, k), np.nan, self.dtype),
                                np.zeros(0, np.int64))
        results, _ = self._fan_out(
            lambda si: self._shard_search(si, queries, k, prune, nprobe,
                                          mode, refine_factor),
            label="search")
        ids, dist = self._merge_topk(
            {si: (res.indices, res.distances)
             for si, res in results.items()}, nq, k)
        solved = np.sum([res.solved for res in results.values()], axis=0)
        return SearchResult(ids, dist, solved.astype(np.int64))

    def query_batch(self, queries: Sequence) -> np.ndarray:
        """Exhaustive (Q, N) distance matrix in global caller doc order,
        from concurrent per-shard exhaustive solves (host numpy)."""
        queries = [np.asarray(q) for q in queries]
        nq = len(queries)
        out = np.full((nq, self.n_docs), np.nan, self.dtype)
        if nq == 0:
            return out
        futures = [self._pool.submit(self.engines[si].query_batch, queries)
                   for si in range(self.n_shards)]
        for si, f in enumerate(futures):
            out[:, self.sindex.global_ids[si]] = f.result().cpu().numpy()
        return out

    def rwmd_topk(self, queries: Sequence, k: int):
        """Bound-only ranking for the serving runtime's degraded tier:
        :func:`repro_torch.runtime.serving.rwmd_topk` on each shard's
        engine, through the same deadline-bounded fan-out and the same
        one-collective merge as :meth:`search`. Returns ``(indices,
        distances)`` like the single-device function, which delegates here
        for a sharded engine."""
        from repro_torch.runtime.serving import rwmd_topk as _local_rwmd
        queries = [np.asarray(q) for q in queries]
        nq = len(queries)
        k = min(int(k), self.n_docs)
        if nq == 0 or k <= 0:
            self.last_coverage = ShardCoverage(1.0, self.n_docs, (), {})
            return (np.full((nq, max(k, 0)), -1, np.int32),
                    np.full((nq, max(k, 0)), np.nan, self.dtype))
        results, _ = self._fan_out(
            lambda si: _local_rwmd(self.engines[si], queries, k),
            label="rwmd_topk")
        return self._merge_topk(dict(results), nq, k)

    # ----------------------------------------------------------- snapshots
    def snapshot(self, snapshot_dir=None) -> list:
        """Persist every shard (:func:`snapshot_shards`) and remember the
        directory for :meth:`restore_shard`. Returns the written paths."""
        d = snapshot_dir if snapshot_dir is not None else self.snapshot_dir
        if d is None:
            raise ValueError("no snapshot directory: pass snapshot_dir "
                             "here or at engine construction")
        self.snapshot_dir = d
        return snapshot_shards(self.sindex, d)

    def restore_shard(self, shard_id: int, snapshot_dir=None) -> None:
        """Dead-shard recovery: reload one shard from its snapshot
        (:func:`restore_shard`), rebuild its :class:`WmdEngine` with the
        same keywords and reset its circuit breaker. Search afterwards is
        bit-compatible with a never-failed engine."""
        d = snapshot_dir if snapshot_dir is not None else self.snapshot_dir
        if d is None:
            raise ValueError("no snapshot directory: pass snapshot_dir "
                             "here or at engine construction")
        si = int(shard_id)
        self.sindex = restore_shard(self.sindex, si, d)
        rebuilt = WmdEngine(self.sindex.shards[si], **self._engine_kwargs)
        self.engines = (self.engines[:si] + (rebuilt,)
                        + self.engines[si + 1:])
        self.health.reset(si)
